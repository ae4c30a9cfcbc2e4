"""The port's optimizer: AdamW with global-norm clipping and the int8
error-feedback gradient compression, copies of the JAX package's
``optim/``."""
from .adamw import AdamW, clip_by_global_norm
from .compress import compressed_psum, ef_quantize

__all__ = ["AdamW", "clip_by_global_norm", "ef_quantize", "compressed_psum"]
