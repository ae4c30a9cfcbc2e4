"""Training and serving steps of the port's LM stack."""
from .serve import Generator, make_decode_step, make_prefill_step
from .step import (
    AUX_COEF,
    cross_entropy,
    init_state,
    make_loss_fn,
    make_train_step,
)

__all__ = [
    "cross_entropy", "make_loss_fn", "make_train_step", "init_state",
    "AUX_COEF", "Generator", "make_prefill_step",
    "make_decode_step",
]
