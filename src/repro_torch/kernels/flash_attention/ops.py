"""The attention op of the port: a flash-attention forward kernel or its
plain version.

Two hand-written kernels compute the function; ``KERNEL_ROUTES`` picks
one by (dtype, head dim): bf16 at d = 64, 128 and 256 runs on the tensor
cores (``csrc/flash_attention_sm90.cu``, wgmma + TMA), float32 on the
CUDA cores (``csrc/flash_attention.cu``).  Anything else raises.

``impl="kernel"`` (the default) launches the routed kernel on a CUDA
tensor, or raises; on a CPU tensor it runs the plain version.
``impl="plain"`` runs the plain version on any device: an explicit
choice (``chip_smoke.py`` makes it for its comparisons), never a
fallback.

Under autograd (a training forward) the kernel route is
``FlashAttention``, an autograd function whose forward is the routed
kernel and whose backward is the kernel ``BWD_ROUTES`` names, at
q_offset 0 (any other offset under grad raises): bf16 on the tensor
cores (``csrc/flash_attention_bwd_sm90.cu``, fed the log-sum-exp that
the forward kernel wrote), float32 on the CUDA cores
(``csrc/flash_attention_bwd.cu``, which recomputes it).  The plain
version differentiates through ``attention_ref`` as it is.
"""

from __future__ import annotations

import torch

from ... import _build
from .ref import attention_ref

__all__ = ["attention", "flash_attention_kernel",
           "flash_attention_bwd_kernel", "FlashAttention", "kernel_route",
           "bwd_route", "KERNEL_ROUTES", "BWD_ROUTES", "BWD_HEAD_DIMS"]

# (dtype, head dim) -> the forward kernel that takes it.  The tensor-core
# kernel is instantiated for d = 64, 128 and 256 (granite-8b serves 128,
# gemma-2b 256); the CUDA-core kernel takes float32.
KERNEL_ROUTES = {
    (torch.bfloat16, 64): "flash_attention_sm90",
    (torch.bfloat16, 128): "flash_attention_sm90",
    (torch.bfloat16, 256): "flash_attention_sm90",
    (torch.float32, 64): "flash_attention",
    (torch.float32, 128): "flash_attention",
    (torch.float32, 256): "flash_attention",
}
# head dims the backward kernels are instantiated for
BWD_HEAD_DIMS = (64, 128, 256)
# (dtype, head dim) -> the backward kernel that takes it; the tensor-core
# one needs the forward's log-sum-exp
BWD_ROUTES = {
    **{(torch.bfloat16, d): "flash_attention_bwd_sm90"
       for d in BWD_HEAD_DIMS},
    **{(torch.float32, d): "flash_attention_bwd" for d in BWD_HEAD_DIMS},
}


def kernel_route(dtype: torch.dtype, d: int) -> str:
    """The forward kernel (a ``_build.KERNELS`` name) that takes ``dtype``
    at head dim ``d``; raises if none does."""
    route = KERNEL_ROUTES.get((dtype, d))
    if route is None:
        raise ValueError(f"no flash-attention kernel takes {dtype} at head "
                         f"dim {d}: routes are {sorted(KERNEL_ROUTES, key=str)}")
    return route


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward kernel that takes ``dtype`` at head dim ``d``; raises
    if none does."""
    route = BWD_ROUTES.get((dtype, d))
    if route is None:
        raise ValueError(f"no flash-attention backward kernel takes {dtype} "
                         f"at head dim {d}: routes are "
                         f"{sorted(BWD_ROUTES, key=str)}")
    return route


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {t.device}")


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
                           *, causal: bool = True, q_offset: int = 0,
                           with_lse: bool = False):
    """Launch the routed CUDA kernel: (b, h, sq, d) in q's dtype; with
    ``with_lse`` (the tensor-core route only) also each query row's
    float32 log-sum-exp (b, h, sq) of its scaled, masked scores."""
    _check(q, k, v, q_offset)
    _require_cuda(q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    route = kernel_route(q.dtype, d)
    if with_lse and route != "flash_attention_sm90":
        raise ValueError(f"{route} writes no log-sum-exp")
    if max(h, b) > 65535:
        raise ValueError(f"{b} batch rows x {h} heads outside the kernel's "
                         "grid")
    if sk < 1:
        raise ValueError("no keys to attend to")
    # the tensor maps of the tensor-core kernel need 16-byte aligned bases
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if route == "flash_attention_sm90":
        args += (lse.data_ptr() if with_lse else None,)
    args += (b, h, kvh, sq, sk, d, int(bool(causal)), int(q_offset),
             float(d ** -0.5))
    _build.call(route, q.device, *args)
    return (out, lse) if with_lse else out


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               dout: torch.Tensor, *, causal: bool = True,
                               lse: torch.Tensor | None = None) -> tuple:
    """Launch the routed backward kernel: (dq, dk, dv) in q's dtype, of
    the attention ``out`` = attention(q, k, v, causal, q_offset=0)
    against the output gradient ``dout``, at any query and key lengths
    sq, sk (cross attention).  The tensor-core route (bf16) takes causal
    attention at sq == sk only, and ``lse``, the (b, h, sq) float32
    log-sum-exp that the forward kernel wrote with ``with_lse``; the
    float32 route recomputes it."""
    _check(q, k, v, 0)
    _require_cuda(q)
    if any(t.dtype != q.dtype for t in (k, v, out, dout)):
        raise ValueError("q, k, v, out and dout must share one dtype; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}, {out.dtype}, "
                         f"{dout.dtype}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    route = bwd_route(q.dtype, d)
    tensor_cores = route == "flash_attention_bwd_sm90"
    if tensor_cores:
        if causal and sq != sk:
            raise ValueError(f"{route} takes causal attention at sq == sk "
                             f"only, got {sq}, {sk}")
        if lse is None:
            raise ValueError(f"{route} takes the forward kernel's "
                             "log-sum-exp: pass lse")
        if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
                or lse.device != q.device):
            raise ValueError(f"lse must be float32 {(b, h, sq)} on "
                             f"{q.device}, got {lse.dtype} "
                             f"{tuple(lse.shape)} on {lse.device}")
    if max(h, b) > 65535:
        raise ValueError(f"{b} batch rows x {h} heads outside the kernel's "
                         "grid")
    if sk < 1:
        raise ValueError("no keys to attend to")
    # 16-byte aligned bases for the tensor maps and the vector loads
    q, k, v, out, dout = (t.contiguous() if t.data_ptr() % 16 == 0
                          else t.clone(memory_format=torch.contiguous_format)
                          for t in (q, k, v, out, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if tensor_cores:
        # float32 partial dK, dV of each query head, summed per group in
        # ascending head order by the kernel's last launch
        part = (torch.empty((2, b, h, sk, d), dtype=torch.float32,
                            device=q.device) if h != kvh else None)
        lse = lse.contiguous()
        _build.call(route, q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                    None if part is None else part[0].data_ptr(),
                    None if part is None else part[1].data_ptr(),
                    b, h, kvh, sq, sk, d, int(bool(causal)),
                    float(d ** -0.5))
        return dq, dk, dv
    lse_scratch = torch.empty_like(delta)   # recomputed by the kernel
    _build.call(route, q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), lse_scratch.data_ptr(),
                delta.data_ptr(), b, h, kvh, sq, sk, d, int(bool(causal)),
                float(d ** -0.5))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention at q_offset 0 on the card with a kernel each way: the
    routed forward kernel, and the routed backward kernel.  Saves q, k, v
    and the output, and on the tensor-core route the forward's
    log-sum-exp, which the backward takes instead of recomputing it."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        lse = None
        if bwd_route(q.dtype, q.shape[-1]) == "flash_attention_bwd_sm90":
            out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                              with_lse=True)
        else:
            out = flash_attention_kernel(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(
            q, k, v, out, dout.to(q.dtype), causal=ctx.causal, lse=lse)
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
