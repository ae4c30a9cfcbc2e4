"""The selective-scan op of the port: the CUDA kernel
(``csrc/selective_scan.cu``) or its plain version.

``impl="kernel"`` (the default) launches the CUDA kernel on a CUDA
tensor, or raises; on a CPU tensor it runs the plain version.
``impl="plain"`` runs the plain version on any device: an explicit
choice, never a fallback.

Under autograd (a training forward of a Mamba layer on the card) the
kernel route is ``SelectiveScan``, an autograd function whose forward is
the kernel writing its chunk states (the state entering every
``SCAN_CHUNK`` steps) and whose backward is
``csrc/selective_scan_bwd.cu``, which recomputes each chunk from its
state.  A failed build or launch raises; nothing turns into the plain
scan.  On the CPU the plain version differentiates by autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import _build
from .ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_kernel",
           "selective_scan_bwd_kernel", "SelectiveScan", "KERNEL_MAX_STATE",
           "SCAN_CHUNK", "BWD_CHANNELS"]

# the kernel keeps a channel's n states in registers, 4 to a thread
KERNEL_MAX_STATE = 16
# steps a chunk state covers (kChunk of both kernels' sources)
SCAN_CHUNK = 64
# channels a block of the backward kernel takes: one dB/dC partial each
BWD_CHANNELS = 64


def _check(x, dt, A, B, C, h0):
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x, dt must be (b, s, di), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}")
    b, s, di = x.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"A must be ({di}, n), got {tuple(A.shape)}")
    n = A.shape[1]
    for t, nm in ((B, "B"), (C, "C")):
        if tuple(t.shape) != (b, s, n):
            raise ValueError(f"{nm} must be ({b}, {s}, {n}), got "
                             f"{tuple(t.shape)}")
    if h0 is not None and tuple(h0.shape) != (b, di, n):
        raise ValueError(f"h0 must be ({b}, {di}, {n}), got "
                         f"{tuple(h0.shape)}")
    tensors = [x, dt, A, B, C] + ([h0] if h0 is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("scan operands on different devices")


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _require_kernel_shape(x, A):
    b = x.shape[0]
    n = A.shape[1]
    if not 1 <= n <= KERNEL_MAX_STATE:
        raise ValueError(f"state size {n} outside 1..{KERNEL_MAX_STATE}")
    if b > 65535:
        raise ValueError(f"batch {b} outside the kernel's grid")
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {x.device}")


def n_chunks(s: int) -> int:
    """Chunk states of an ``s``-step scan."""
    return -(-s // SCAN_CHUNK)


def selective_scan_kernel(x, dt, A, B, C, h0=None, *,
                          with_states: bool = False):
    """Launch the CUDA kernel: (y (b, s, di), h_final (b, di, n)),
    float32; with ``with_states`` also the chunk states (b,
    ceil(s / SCAN_CHUNK), di, n), the state entering each chunk (the
    first is h0)."""
    _check(x, dt, A, B, C, h0)
    _require_kernel_shape(x, A)
    b, s, di = x.shape
    n = A.shape[1]
    x, dt, A, B, C = (t.float().contiguous() for t in (x, dt, A, B, C))
    if h0 is None:
        h0 = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    h0 = h0.float().contiguous()
    y = torch.empty((b, s, di), dtype=torch.float32, device=x.device)
    hT = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    hc = (torch.empty((b, n_chunks(s), di, n), dtype=torch.float32,
                      device=x.device) if with_states else None)
    if b * di:
        _build.call("selective_scan", x.device, x.data_ptr(), dt.data_ptr(),
                    A.data_ptr(), B.data_ptr(), C.data_ptr(), h0.data_ptr(),
                    y.data_ptr(), hT.data_ptr(),
                    hc.data_ptr() if with_states else None, b, s, di, n)
    return (y, hT, hc) if with_states else (y, hT)


def selective_scan_bwd_kernel(x, dt, A, B, C, hc, dy, dhT=None):
    """Launch the backward kernel: the gradients (dx, ddt (b, s, di), dA
    (di, n), dB, dC (b, s, n), dh0 (b, di, n)), float32, of the scan
    whose chunk states ``hc`` the forward kernel wrote
    (``with_states``), against dy (b, s, di) and dhT (b, di, n; None is
    0).  The sums across blocks (dB, dC over channels, dA over the
    batch) are per-block partials summed in a fixed order by the
    kernel's second launch: the same inputs give the same bits."""
    _check(x, dt, A, B, C, None)
    b, s, di = x.shape
    n = A.shape[1]
    if tuple(dy.shape) != (b, s, di):
        raise ValueError(f"dy must be ({b}, {s}, {di}), got "
                         f"{tuple(dy.shape)}")
    if tuple(hc.shape) != (b, n_chunks(s), di, n):
        raise ValueError(f"chunk states must be ({b}, {n_chunks(s)}, {di}, "
                         f"{n}), got {tuple(hc.shape)}")
    if dhT is not None and tuple(dhT.shape) != (b, di, n):
        raise ValueError(f"dhT must be ({b}, {di}, {n}), got "
                         f"{tuple(dhT.shape)}")
    if any(t is not None and t.device != x.device for t in (hc, dy, dhT)):
        raise ValueError("scan backward operands on different devices")
    _require_kernel_shape(x, A)
    x, dt, A, B, C, hc, dy = (t.float().contiguous()
                              for t in (x, dt, A, B, C, hc, dy))
    dhT = None if dhT is None else dhT.float().contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt = torch.empty((b, s, di), **f32), torch.empty((b, s, di), **f32)
    dB, dC = torch.empty((b, s, n), **f32), torch.empty((b, s, n), **f32)
    dA = torch.empty((di, n), **f32)
    dh0 = torch.empty((b, di, n), **f32)
    if s == 0 or b * di == 0:
        dh0 = dhT.clone() if dhT is not None else dh0.zero_()
        return dx, ddt, dA.zero_(), dB.zero_(), dC.zero_(), dh0
    nblk = -(-di // BWD_CHANNELS)
    part = torch.empty((2, nblk, b, s, n), **f32)
    dA_part = torch.empty((b, di, n), **f32)
    _build.call("selective_scan_bwd", x.device, x.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B.data_ptr(), C.data_ptr(), hc.data_ptr(),
                dy.data_ptr(), None if dhT is None else dhT.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                dC.data_ptr(), dh0.data_ptr(), part[0].data_ptr(),
                part[1].data_ptr(), dA_part.data_ptr(), b, s, di, n)
    return dx, ddt, dA, dB, dC, dh0


class SelectiveScan(torch.autograd.Function):
    """The scan on the card with a kernel each way: the forward kernel
    with its chunk states, and the backward kernel, which recomputes
    each chunk from them.  Saves x, dt, A, B, C and the chunk states;
    the gradients take their inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0):
        y, hT, hc = selective_scan_kernel(x, dt, A, B, C, h0,
                                          with_states=True)
        ctx.save_for_backward(x, dt, A, B, C, hc)
        ctx.h0_dtype = None if h0 is None else h0.dtype
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, A, B, C, hc = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, dA, dB, dC, dh0 = selective_scan_bwd_kernel(
            x, dt, A, B, C, hc, dy, dhT)
        return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
                dB.to(B.dtype), dC.to(C.dtype),
                None if ctx.h0_dtype is None else dh0.to(ctx.h0_dtype))


def selective_scan(
    x: torch.Tensor,      # (b, s, di)
    dt: torch.Tensor,     # (b, s, di)
    A: torch.Tensor,      # (di, n)
    B: torch.Tensor,      # (b, s, n)
    C: torch.Tensor,      # (b, s, n)
    h0: Optional[torch.Tensor] = None,   # (b, di, n)
    *,
    impl: str = "kernel",     # "kernel" | "plain"
) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x, dt, A, B, C, h0)
    if impl == "plain" or (impl == "kernel" and _on_cpu(x)):
        return selective_scan_ref(x, dt, A, B, C, h0)
    if impl != "kernel":
        raise ValueError(f"unknown scan impl {impl!r}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, B, C, h0)):
        return SelectiveScan.apply(x, dt, A, B, C, h0)
    return selective_scan_kernel(x, dt, A, B, C, h0)
