"""Checkpoints and the fault-tolerant training loop of the port, copies
of the JAX package's ``checkpoint/`` over trees of tensors."""
from . import ckpt
from .fault_tolerance import FailureInjector, RunReport, run_resilient

__all__ = ["ckpt", "FailureInjector", "RunReport", "run_resilient"]
