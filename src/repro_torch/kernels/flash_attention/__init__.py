"""Flash-attention forward: two CUDA kernels for Hopper
(``csrc/flash_attention_sm90.cu`` on the tensor cores for bf16 at head
dim 64 and 128, ``csrc/flash_attention.cu`` on the CUDA cores for the
rest) beside their plain PyTorch version.

Online-softmax attention over (b, h, s, d) with GQA (``kvh`` divides
``h``), a causal mask shifted by ``q_offset``, float32 math and the
output in q's dtype.
"""

from .ops import (
    KERNEL_ROUTES,
    attention,
    flash_attention_kernel,
    kernel_route,
)
from .ref import attention_ref

__all__ = ["attention", "attention_ref", "flash_attention_kernel",
           "kernel_route", "KERNEL_ROUTES"]
