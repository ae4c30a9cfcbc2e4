"""Exhaustive tables, error statistics and low-rank error factorization.

This is the numerical heart of the TPU adaptation (DESIGN.md §2): for an
8-bit approximate multiplier with product table M[a,b] we factor the error
table E = M - a*b as E ~= sum_r u_r (x) v_r (SVD), so an approximate matmul
becomes  A@B + sum_r U_r[A] @ V_r[B]  — (k+1) exact MXU matmuls plus
256-entry elementwise lookups.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

AXIS_U8 = np.arange(256, dtype=np.int64)
AXIS_S8 = np.arange(-128, 128, dtype=np.int64)

__all__ = [
    "product_table_u8",
    "product_table_s8",
    "error_table",
    "ErrorStats",
    "error_stats",
    "adder_error_stats",
    "RankFactors",
    "svd_factors",
    "effective_rank",
]


def product_table_u8(fn) -> np.ndarray:
    """(256,256) int64 table of fn over the full unsigned 8-bit domain."""
    a, b = np.meshgrid(AXIS_U8, AXIS_U8, indexing="ij")
    return np.asarray(fn(a, b), dtype=np.int64)


def product_table_s8(signed_fn) -> np.ndarray:
    """(256,256) int64 table over int8 x int8; index i maps to value i-128."""
    a, b = np.meshgrid(AXIS_S8, AXIS_S8, indexing="ij")
    return np.asarray(signed_fn(a, b), dtype=np.int64)


def error_table(table: np.ndarray, *, signed: bool) -> np.ndarray:
    """E[a,b] = approx(a,b) - a*b over the matching 8-bit domain."""
    ax = AXIS_S8 if signed else AXIS_U8
    exact = np.multiply.outer(ax, ax)
    return table - exact


@dataclass(frozen=True)
class ErrorStats:
    """The error metrics the paper's QoR surrogate consumes ("mean and
    average error of the approximate circuits"), plus the standard AC
    benchmarking set (MAE/MSE/WCE/EP/MRE)."""

    me: float      # mean (signed) error — bias
    mae: float     # mean absolute error
    mse: float     # mean squared error
    wce: float     # worst-case absolute error
    ep: float      # error probability (fraction of input pairs with error)
    mre: float     # mean relative error (w.r.t. exact product, 0-safe)
    var: float     # error variance (mse - me^2)

    def as_array(self) -> np.ndarray:
        return np.array(
            [self.me, self.mae, self.mse, self.wce, self.ep, self.mre, self.var]
        )


def _stats_from_errors(err: np.ndarray, exact: np.ndarray) -> ErrorStats:
    err = err.astype(np.float64)
    me = float(err.mean())
    mae = float(np.abs(err).mean())
    mse = float((err**2).mean())
    wce = float(np.abs(err).max())
    ep = float((err != 0).mean())
    denom = np.maximum(np.abs(exact.astype(np.float64)), 1.0)
    mre = float((np.abs(err) / denom).mean())
    return ErrorStats(me=me, mae=mae, mse=mse, wce=wce, ep=ep, mre=mre, var=mse - me * me)


def error_stats(table: np.ndarray, *, signed: bool) -> ErrorStats:
    ax = AXIS_S8 if signed else AXIS_U8
    exact = np.multiply.outer(ax, ax)
    return _stats_from_errors(table - exact, exact)


def adder_error_stats(fn, *, w: int = 16, n: int = 1 << 20, seed: int = 0) -> ErrorStats:
    """Adder error metrics over a fixed uniform sample (the 2^32 pair space
    is too large to exhaust; deterministic seed keeps this reproducible)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << w, size=n, dtype=np.int64)
    b = rng.integers(0, 1 << w, size=n, dtype=np.int64)
    exact = a + b
    err = np.asarray(fn(a, b), dtype=np.int64) - exact
    return _stats_from_errors(err, exact)


@dataclass(frozen=True)
class RankFactors:
    """Rank-k factorization of an error table: E ~= u @ v.T (singular
    values folded symmetrically into both factors)."""

    u: np.ndarray  # (256, k) float32
    v: np.ndarray  # (256, k) float32

    @property
    def rank(self) -> int:
        return self.u.shape[1]

    def reconstruct(self) -> np.ndarray:
        return self.u @ self.v.T


def svd_factors(etab: np.ndarray, rank: int) -> RankFactors:
    u, s, vt = np.linalg.svd(etab.astype(np.float64), full_matrices=False)
    rank = min(rank, len(s))
    sq = np.sqrt(s[:rank])
    return RankFactors(
        u=(u[:, :rank] * sq).astype(np.float32),
        v=(vt[:rank, :].T * sq).astype(np.float32),
    )


def effective_rank(etab: np.ndarray, energy: float = 0.99) -> int:
    """Smallest k such that the top-k singular values capture `energy` of
    the error table's squared Frobenius norm.  0 for an all-zero table."""
    s = np.linalg.svd(etab.astype(np.float64), compute_uv=False)
    tot = float((s**2).sum())
    if tot == 0.0:
        return 0
    c = np.cumsum(s**2) / tot
    return int(np.searchsorted(c, energy) + 1)
