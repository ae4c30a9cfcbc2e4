"""Plain PyTorch version of the Mamba-1 selective scan.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
    y_t = <h_t, C_t>          (the D skip is applied by the caller)

Shapes: x/dt (b, s, di), A (di, n), B/C (b, s, n), h (b, di, n); float32
math.  A sequential loop over ``s``: the CPU path of ``ops.selective_scan``
and the version the CUDA kernel (``csrc/selective_scan.cu``) is held
against on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["selective_scan_ref"]


def selective_scan_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b, s, di), h_final (b, di, n)), float32."""
    b, s, di = x.shape
    n = A.shape[1]
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    h = (torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(s):
        dtt = dt[:, t]
        a = torch.exp(dtt[..., None] * A[None])             # (b, di, n)
        h = a * h + (dtt * x[:, t])[..., None] * B[:, t, None, :]
        ys.append(torch.einsum("bin,bn->bi", h, C[:, t]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((b, 0, di))
    return y, h
