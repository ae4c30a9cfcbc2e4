"""Flash attention: two forward CUDA kernels for Hopper
(``csrc/flash_attention_sm90.cu`` on the tensor cores for bf16 at head
dim 64 and 128, ``csrc/flash_attention.cu`` on the CUDA cores for the
rest) and one backward kernel (``csrc/flash_attention_bwd.cu``: dQ, dK,
dV), beside their plain PyTorch versions.

Online-softmax attention over (b, h, s, d) with GQA (``kvh`` divides
``h``), a causal mask shifted by ``q_offset``, float32 math and the
output in q's dtype.
"""

from .ops import (
    BWD_HEAD_DIMS,
    KERNEL_ROUTES,
    FlashAttention,
    attention,
    flash_attention_bwd_kernel,
    flash_attention_kernel,
    kernel_route,
)
from .ref import attention_bwd_ref, attention_ref

__all__ = ["attention", "attention_ref", "attention_bwd_ref",
           "flash_attention_kernel", "flash_attention_bwd_kernel",
           "FlashAttention", "kernel_route", "KERNEL_ROUTES",
           "BWD_HEAD_DIMS"]
