"""Plain PyTorch version of the Mamba-1 selective scan.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
    y_t = <h_t, C_t>          (the D skip is applied by the caller)

Shapes: x/dt (b, s, di), A (di, n), B/C (b, s, n), h (b, di, n); float32
math.  A sequential loop over ``s``: the CPU path of ``ops.selective_scan``
(autograd differentiates it there) and the version the CUDA kernel
(``csrc/selective_scan.cu``) is held against on the card.

``selective_scan_bwd_ref`` is the plain backward of the same function:
the reverse recurrence written out over every step's state, with no
chunks or tiles, which the backward kernel
(``csrc/selective_scan_bwd.cu``) is held against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["selective_scan_ref", "selective_scan_bwd_ref"]


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


def selective_scan_bwd_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    dy: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    dhT: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Gradients of ``selective_scan_ref``'s (y, h_final) against dy
    (b, s, di) and dhT (b, di, n; None is 0): (dx, ddt (b, s, di), dA
    (di, n), dB, dC (b, s, n), dh0 (b, di, n)), float32.  With
    G_t = a_{t+1} G_{t+1} + dy_t C_t (+ dhT at the last step):
    dx = dt sum_n G B, ddt = sum_n G (x B + A a h_{t-1}), dB = sum_di
    G dt x, dC = sum_di dy h_t, dA = sum_{b,t} G dt a h_{t-1}, dh0 = a_1
    G_1."""
    b, s, di = x.shape
    n = A.shape[1]
    x, dt, A, B, C, dy = (t.float() for t in (x, dt, A, B, C, dy))
    h = (torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    states = [h]                     # states[t]: the state entering step t
    for t in range(s):
        a = torch.exp(dt[:, t, :, None] * A[None])
        h = a * h + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        states.append(h)
    g = (torch.zeros_like(h) if dhT is None else dhT.float().clone())
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    dA = torch.zeros_like(A)
    for t in reversed(range(s)):
        a = torch.exp(dt[:, t, :, None] * A[None])
        g = g + dy[:, t, :, None] * C[:, t, None, :]          # G_t
        dC[:, t] = torch.einsum("bi,bin->bn", dy[:, t], states[t + 1])
        dB[:, t] = torch.einsum("bin,bi->bn", g, dt[:, t] * x[:, t])
        gb = torch.einsum("bin,bn->bi", g, B[:, t])
        w = g * a * states[t]                                 # G a h_{t-1}
        dx[:, t] = dt[:, t] * gb
        ddt[:, t] = x[:, t] * gb + torch.einsum("bin,in->bi", w, A)
        dA += torch.einsum("bin,bi->in", w, dt[:, t])
        g = a * g
    return dx, ddt, dA, dB, dC, g
