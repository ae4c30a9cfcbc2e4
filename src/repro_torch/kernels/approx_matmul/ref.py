"""Plain PyTorch versions of the two approximate-matmul semantics.

1. ``lut_matmul`` — the *behavioural* oracle: every scalar product is an
   exhaustive (256x256) product-table lookup, accumulation is exact
   int32.  Bit-exact w.r.t. the numpy behavioural circuit models.

2. ``rank_k_matmul`` — the *deployment* form:
   approx(A@B) = A@B + sum_r U_r[A] @ V_r[B], in float32.

Index convention: unsigned circuits index the table with the raw 8-bit
value; signed circuits with value+128 (see core.acl.tables.AXIS_S8).

These are the CPU path of ``ops`` and the versions the CUDA kernels
(``csrc/lut_matmul.cu``, ``csrc/rank_k.cu``) are held against on the
card.  A float32 product on the card runs in full float32 only with
``torch.backends.cuda.matmul.allow_tf32`` False, which a comparison on
the card sets explicitly.
"""

from __future__ import annotations

import torch

__all__ = ["lut_matmul", "rank_k_matmul", "to_index"]


def to_index(x: torch.Tensor, signed: bool) -> torch.Tensor:
    """Map int8/uint8-valued ints to table row/col indices (int64)."""
    x = x.long()
    return x + 128 if signed else x


def lut_matmul(
    x: torch.Tensor,       # (m, k) int values in the 8-bit domain
    w: torch.Tensor,       # (k, n) int values in the 8-bit domain
    table: torch.Tensor,   # (256, 256) int32 product table
    *,
    signed: bool = False,
) -> torch.Tensor:
    """``out[i, j] = sum_k T[x[i,k], w[k,j]]``, exact int32."""
    xi = to_index(x, signed)
    wi = to_index(w, signed)
    flat = table.reshape(-1).to(torch.int32)
    idx = xi[:, :, None] * 256 + wi[None, :, :]      # (m, k, n)
    # int32 accumulation: |product| <= 65025, safe for k up to ~3.3e4
    return flat[idx].sum(dim=1, dtype=torch.int32)


def rank_k_matmul(
    x: torch.Tensor,   # (m, k) int values
    w: torch.Tensor,   # (k, n) int values
    u: torch.Tensor,   # (256, r) f32 error row-factors
    v: torch.Tensor,   # (256, r) f32 error col-factors
    *,
    signed: bool = False,
) -> torch.Tensor:
    """``out = x @ w + sum_r u_r[x] @ v_r[w]`` in float32."""
    xi = to_index(x, signed)
    wi = to_index(w, signed)
    out = x.float() @ w.float()
    if u.shape[1]:
        ux = u.float()[xi]          # (m, k, r)
        vw = v.float()[wi]          # (k, n, r)
        out = out + torch.einsum("mkr,knr->mn", ux, vw)
    return out
