"""Flash-attention forward: a CUDA kernel for Hopper
(``csrc/flash_attention.cu``) beside its plain PyTorch version.

Online-softmax attention over (b, h, s, d) with GQA (``kvh`` divides
``h``), a causal mask shifted by ``q_offset``, float32 math and the
output in q's dtype.
"""

from .ops import KERNEL_HEAD_DIMS, attention, flash_attention_kernel
from .ref import attention_ref

__all__ = ["attention", "attention_ref", "flash_attention_kernel",
           "KERNEL_HEAD_DIMS"]
