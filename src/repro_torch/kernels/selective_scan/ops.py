"""The selective-scan op of the port: the CUDA kernel
(``csrc/selective_scan.cu``) or its plain version.

``impl="kernel"`` (the default) launches the CUDA kernel on a CUDA
tensor, or raises; on a CPU tensor it runs the plain version.
``impl="plain"`` runs the plain version on any device: an explicit
choice, never a fallback.

The kernel has no backward yet: a kernel call under autograd (a
training forward of a Mamba layer on the card) raises
``NotImplementedError``; it is not routed to the plain scan.  On the
CPU the plain version differentiates as it is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import _build
from .ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_kernel", "KERNEL_MAX_STATE"]

# the kernel keeps a channel's n states in registers, 4 to a thread
KERNEL_MAX_STATE = 16


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


def selective_scan_kernel(x, dt, A, B, C, h0=None):
    """Launch the CUDA kernel: (y (b, s, di), h_final (b, di, n)),
    float32."""
    _check(x, dt, A, B, C, h0)
    b, s, di = x.shape
    n = A.shape[1]
    if not 1 <= n <= KERNEL_MAX_STATE:
        raise ValueError(f"state size {n} outside 1..{KERNEL_MAX_STATE}")
    if b > 65535:
        raise ValueError(f"batch {b} outside the kernel's grid")
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {x.device}")
    x, dt, A, B, C = (t.float().contiguous() for t in (x, dt, A, B, C))
    if h0 is None:
        h0 = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    h0 = h0.float().contiguous()
    y = torch.empty((b, s, di), dtype=torch.float32, device=x.device)
    hT = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    if b * di == 0:
        return y, hT
    _build.call("selective_scan", x.device, x.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B.data_ptr(), C.data_ptr(), h0.data_ptr(),
                y.data_ptr(), hT.data_ptr(), b, s, di, n)
    return y, hT


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
        raise NotImplementedError(
            "the selective scan has no backward kernel yet: a Mamba layer "
            "cannot train on the card until csrc/ holds one")
    return selective_scan_kernel(x, dt, A, B, C, h0)
