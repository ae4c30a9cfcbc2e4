"""The attention op of the port: a flash-attention forward kernel or its
plain version.

Two hand-written kernels compute the function; ``KERNEL_ROUTES`` picks
one by (dtype, head dim): bf16 at d = 64 and 128 runs on the tensor
cores (``csrc/flash_attention_sm90.cu``, wgmma + TMA), float32 and bf16
at d = 256 on the CUDA cores (``csrc/flash_attention.cu``).  Anything
else raises.

``impl="kernel"`` (the default) launches the routed kernel on a CUDA
tensor, or raises; on a CPU tensor it runs the plain version.
``impl="plain"`` runs the plain version on any device: an explicit
choice (``chip_smoke.py`` makes it for its comparisons), never a
fallback.

Under autograd (a training forward) the kernel route is
``FlashAttention``, an autograd function whose forward is the routed
kernel and whose backward is ``csrc/flash_attention_bwd.cu`` (dQ, dK, dV
on the CUDA cores, at q_offset 0; any other offset under grad raises).
The plain version differentiates through ``attention_ref`` as it is.
"""

from __future__ import annotations

import torch

from ... import _build
from .ref import attention_ref

__all__ = ["attention", "flash_attention_kernel",
           "flash_attention_bwd_kernel", "FlashAttention", "kernel_route",
           "KERNEL_ROUTES", "BWD_HEAD_DIMS"]

# (dtype, head dim) -> the kernel that takes it.  The tensor-core kernel
# is instantiated for d = 64 and 128 (granite-8b serves 128); the
# CUDA-core kernel's shared-memory stage is sized per head dim, and 256
# needs 213 KB of the 227 KB a block may have.
KERNEL_ROUTES = {
    (torch.bfloat16, 64): "flash_attention_sm90",
    (torch.bfloat16, 128): "flash_attention_sm90",
    (torch.bfloat16, 256): "flash_attention",
    (torch.float32, 64): "flash_attention",
    (torch.float32, 128): "flash_attention",
    (torch.float32, 256): "flash_attention",
}
# head dims the backward kernel is instantiated for (float32 and bf16)
BWD_HEAD_DIMS = (64, 128, 256)
# dtype argument of the CUDA-core kernels' entry points
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_route(dtype: torch.dtype, d: int) -> str:
    """The kernel (a ``_build.KERNELS`` name) that takes ``dtype`` at head
    dim ``d``; raises if none does."""
    route = KERNEL_ROUTES.get((dtype, d))
    if route is None:
        raise ValueError(f"no flash-attention kernel takes {dtype} at head "
                         f"dim {d}: routes are {sorted(KERNEL_ROUTES, key=str)}")
    return route


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
    """Launch the routed CUDA kernel: (b, h, sq, d) in q's dtype."""
    _check(q, k, v, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    route = kernel_route(q.dtype, d)
    if max(h, b) > 65535:
        raise ValueError(f"{b} batch rows x {h} heads outside the kernel's "
                         "grid")
    if sk < 1:
        raise ValueError("no keys to attend to")
    # the tensor maps of the tensor-core kernel need 16-byte aligned bases
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            kvh, sq, sk, d, int(bool(causal)), int(q_offset),
            float(d ** -0.5))
    if route == "flash_attention":
        args += (_DTYPES[q.dtype],)
    _build.call(route, q.device, *args)
    return out


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               dout: torch.Tensor, *, causal: bool = True
                               ) -> tuple:
    """Launch the backward kernel: (dq, dk, dv) in q's dtype, of the
    attention ``out`` = attention(q, k, v, causal, q_offset=0) against
    the output gradient ``dout``."""
    _check(q, k, v, 0)
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {q.device}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, out, dout)):
        raise ValueError("q, k, v, out and dout must share one dtype, "
                         f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}, {out.dtype}, {dout.dtype}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"the backward kernel takes head dims "
                         f"{BWD_HEAD_DIMS}, not {d}")
    if max(h, b) > 65535:
        raise ValueError(f"{b} batch rows x {h} heads outside the kernel's "
                         "grid")
    if sk < 1:
        raise ValueError("no keys to attend to")
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    _build.call("flash_attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), b, h, kvh, sq, sk, d, int(bool(causal)),
                float(d ** -0.5), _DTYPES[q.dtype])
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention at q_offset 0 on the card with a kernel each way: the
    routed forward kernel, and the backward kernel.  Saves q, k, v and
    the output; the backward recomputes each row's log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out = flash_attention_kernel(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(
            q, k, v, out, dout.to(q.dtype), causal=ctx.causal)
        return dq, dk, dv, None


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


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
    if impl == "plain" or (impl == "kernel" and _on_cpu(q)):
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    if impl != "kernel":
        raise ValueError(f"unknown attention impl {impl!r}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q_offset:
            raise NotImplementedError(
                "the attention backward kernel takes q_offset 0 only, "
                f"not {q_offset}")
        return FlashAttention.apply(q, k, v, causal)
    return flash_attention_kernel(q, k, v, causal=causal, q_offset=q_offset)
