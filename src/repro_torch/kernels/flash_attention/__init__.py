"""Flash attention: two forward CUDA kernels for Hopper
(``csrc/flash_attention_sm90.cu`` on the tensor cores for bf16 at head
dim 64, 128 and 256, ``csrc/flash_attention.cu`` on the CUDA cores for
float32) and two backward kernels (dQ, dK, dV:
``csrc/flash_attention_bwd_sm90.cu`` on the tensor cores for bf16,
``csrc/flash_attention_bwd.cu`` on the CUDA cores for float32), beside
their plain PyTorch versions.

Online-softmax attention over (b, h, s, d) with GQA (``kvh`` divides
``h``), a causal mask shifted by ``q_offset``, float32 math and the
output in q's dtype.
"""

from .ops import (
    BWD_HEAD_DIMS,
    BWD_ROUTES,
    KERNEL_ROUTES,
    FlashAttention,
    attention,
    bwd_route,
    flash_attention_bwd_kernel,
    flash_attention_kernel,
    kernel_route,
)
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

__all__ = ["attention", "attention_ref", "attention_bwd_ref",
           "attention_lse_ref", "flash_attention_kernel",
           "flash_attention_bwd_kernel", "FlashAttention", "kernel_route",
           "bwd_route", "KERNEL_ROUTES", "BWD_ROUTES", "BWD_HEAD_DIMS"]
