"""Plain PyTorch versions of the two approximate-matmul semantics.

1. ``lut_matmul`` — the *behavioural* oracle: every scalar product is an
   exhaustive (256x256) product-table lookup, accumulation is exact
   int32.  Bit-exact w.r.t. the numpy behavioural circuit models.

2. ``rank_k_matmul`` — the *deployment* form:
   approx(A@B) = A@B + sum_r U_r[A] @ V_r[B], in float32.

3. ``grouped_rank_k_matmul`` — the deployment form of a whole variant:
   one ``rank_k_matmul`` per slot group of the contraction, on the packed
   group layout that ``ops.pack_groups`` builds, partials summed in
   group order.

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

__all__ = ["lut_matmul", "rank_k_matmul", "grouped_rank_k_matmul",
           "mask_operand", "to_index", "DESC_WORDS"]

# int32 words per group descriptor of the packed layout:
# (start, stop, rank, table offset, index offset, truncation bits)
DESC_WORDS = 6


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


def mask_operand(t: torch.Tensor, trunc: int) -> torch.Tensor:
    """Native reduced-width deployment: the truncation IS the circuit.
    Sign-magnitude masking matches the behavioural mul8s wrapper."""
    return torch.sign(t) * ((torch.abs(t) >> trunc) << trunc)


def grouped_rank_k_matmul(
    x: torch.Tensor,        # (m, k) int values
    w: torch.Tensor,        # (k, n) int values
    packed: torch.Tensor,   # int32 packed groups (ops.pack_groups)
) -> torch.Tensor:
    """``sum_g rank_k_matmul(t_g(x[:, s_g:e_g]), t_g(w[s_g:e_g]), U_g,
    V_g)`` in group order, float32: the packed layout's own reading of
    the per-group chain, bit-equal to it."""
    packed = packed.to(x.device)
    n_groups = int(packed[0])
    desc = packed[1:1 + DESC_WORDS * n_groups].tolist()
    tables = packed[1 + DESC_WORDS * n_groups:].view(torch.float32)
    x = x.to(torch.int32)
    w = w.to(torch.int32)
    out = None
    for g in range(n_groups):
        s, e, r, at, offset, trunc = desc[DESC_WORDS * g:DESC_WORDS * (g + 1)]
        xs = x[:, s:e].contiguous()
        ws = w[s:e, :].contiguous()
        if trunc:
            xs = mask_operand(xs, trunc).contiguous()
            ws = mask_operand(ws, trunc).contiguous()
        u = tables[at:at + 256 * r].reshape(256, r)
        v = tables[at + 256 * r:at + 512 * r].reshape(256, r)
        part = rank_k_matmul(xs, ws, u, v, signed=offset != 0)
        out = part if out is None else out + part
    return out
