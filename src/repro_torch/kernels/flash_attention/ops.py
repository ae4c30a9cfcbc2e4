"""The attention op of the port: the flash-attention forward kernel
(``csrc/flash_attention.cu``) or its plain version.

``impl="kernel"`` (the default) launches the CUDA kernel on a CUDA
tensor, or raises; on a CPU tensor it runs the plain version.
``impl="plain"`` runs the plain version on any device: an explicit
choice (``chip_smoke.py`` makes it for its comparisons), never a
fallback.
"""

from __future__ import annotations

import torch

from ... import _build
from .ref import attention_ref

__all__ = ["attention", "flash_attention_kernel", "KERNEL_HEAD_DIMS"]

# head dims the kernel is instantiated for (its shared-memory stage is
# sized per head dim; 256 needs 213 KB of the 227 KB a block may have)
KERNEL_HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, q_offset):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (b,h,sq,d), k/v (b,kvh,sk,d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match (batch, head dim, or heads % kv heads)")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v on different devices")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           q_offset: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel: (b, h, sq, d) in q's dtype."""
    _check(q, k, v, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {KERNEL_HEAD_DIMS}")
    if max(h, b) > 65535:
        raise ValueError(f"{b} batch rows x {h} heads outside the kernel's "
                         "grid")
    if sk < 1:
        raise ValueError("no keys to attend to")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.call("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, h, kvh, sq, sk, d,
                int(bool(causal)), int(q_offset), float(d ** -0.5),
                _DTYPES[q.dtype])
    return out


def attention(
    q: torch.Tensor,          # (b, h, sq, d)
    k: torch.Tensor,          # (b, kvh, sk, d)
    v: torch.Tensor,          # (b, kvh, sk, d)
    *,
    causal: bool = True,
    q_offset: int = 0,
    impl: str = "kernel",     # "kernel" | "plain"
) -> torch.Tensor:
    _check(q, k, v, q_offset)
    if impl == "plain" or (impl == "kernel" and q.device.type == "cpu"):
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    if impl != "kernel":
        raise ValueError(f"unknown attention impl {impl!r}")
    return flash_attention_kernel(q, k, v, causal=causal, q_offset=q_offset)
