"""Behavioral models of 8-bit approximate multipliers.

Every function is a vectorized numpy model ``f(a, b) -> p`` where ``a`` and
``b`` are integer arrays holding unsigned 8-bit values (any integer dtype;
values are masked to 8 bits) and ``p`` is the approximate 16-bit product as
int64.  These mirror the behavioral (C++) models of the EvoApprox8b library
used by the paper: the exact netlists are not vendored in this offline
environment, so we generate a structurally equivalent family spanning the
same error-vs-cost spectrum (truncation, partial-product perforation,
broken-array, Mitchell logarithmic, DRUM, Kulkarni-composed).  See
DESIGN.md §8.

All models are deterministic and exhaustively tabulable (256x256), which is
what `core.acl.tables` does.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "mul8_exact",
    "mul8_trunc",
    "mul8_perforated",
    "mul8_broken_array",
    "mul8_mitchell",
    "mul8_drum",
    "mul8_kulkarni",
    "signed_wrap",
]


def _u8(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int64) & 0xFF


def mul8_exact(a, b) -> np.ndarray:
    """Exact unsigned 8x8 -> 16 multiplier."""
    return _u8(a) * _u8(b)


def mul8_trunc(a, b, *, k: int) -> np.ndarray:
    """Operand-truncation multiplier: drop the k LSBs of both operands.

    p = (a >> k) * (b >> k) << 2k.  Classic bitwidth-reduction AC; very
    cheap (a (8-k)x(8-k) core) with a negative-biased error.
    """
    a, b = _u8(a), _u8(b)
    return ((a >> k) * (b >> k)) << (2 * k)


def mul8_perforated(a, b, *, k: int) -> np.ndarray:
    """Partial-product perforation: drop the k least-significant PP rows.

    p = sum_{i=k..7} a_i * (b << i).  Mirrors PPP multipliers (Zervakis et
    al.); saves k rows of the array.
    """
    a, b = _u8(a), _u8(b)
    p = np.zeros_like(a)
    for i in range(k, 8):
        bit = (a >> i) & 1
        p = p + bit * (b << i)
    return p


def mul8_broken_array(a, b, *, k: int) -> np.ndarray:
    """Broken-array multiplier (BAM): omit all carry-save cells below
    column k.  Each partial-product row keeps only the bits at global
    column >= k; the low-order triangle of the array is removed.
    """
    a, b = _u8(a), _u8(b)
    mask = ~np.int64((1 << k) - 1)
    p = np.zeros_like(a)
    for i in range(8):
        bit = (a >> i) & 1
        p = p + (bit * (b << i) & mask)
    return p


def _ilog2(x: np.ndarray) -> np.ndarray:
    """floor(log2(x)) for x >= 1, exact for integers (via frexp)."""
    return np.frexp(x.astype(np.float64))[1].astype(np.int64) - 1


def mul8_mitchell(a, b) -> np.ndarray:
    """Mitchell's logarithmic multiplier (1962), integer realization.

    log2(a) ~= ka + xa/2^ka with xa = a - 2^ka.  The antilog of the summed
    approximate logs gives:
        fa + fb < 1 : p = 2^(ka+kb) + xa*2^kb + xb*2^ka
        fa + fb >= 1: p = 2 * (xa*2^kb + xb*2^ka)
    Zero operands produce zero.
    """
    a, b = _u8(a), _u8(b)
    nz = (a > 0) & (b > 0)
    asafe = np.where(nz, a, 1)
    bsafe = np.where(nz, b, 1)
    ka, kb = _ilog2(asafe), _ilog2(bsafe)
    xa = asafe - (np.int64(1) << ka)
    xb = bsafe - (np.int64(1) << kb)
    cross = xa * (np.int64(1) << kb) + xb * (np.int64(1) << ka)
    base = np.int64(1) << (ka + kb)
    p = np.where(cross < base, base + cross, 2 * cross)
    return np.where(nz, p, 0)


def mul8_drum(a, b, *, k: int) -> np.ndarray:
    """DRUM-k (Hashemi et al., ICCAD'15): dynamic-range unbiased multiplier.

    Keep a k-bit window starting at the leading one of each operand, force
    the window LSB to 1 (unbiasing), multiply the short operands, and shift
    back.  Cited as [11] by the paper.
    """
    a, b = _u8(a), _u8(b)
    nz = (a > 0) & (b > 0)
    asafe = np.where(nz, a, 1)
    bsafe = np.where(nz, b, 1)
    sa = np.maximum(_ilog2(asafe) - (k - 1), 0)
    sb = np.maximum(_ilog2(bsafe) - (k - 1), 0)
    ta = (asafe >> sa) | 1
    tb = (bsafe >> sb) | 1
    p = (ta * tb) << (sa + sb)
    return np.where(nz, p, 0)


_KULKARNI_2X2 = np.array(
    [
        [0, 0, 0, 0],
        [0, 1, 2, 3],
        [0, 2, 4, 6],
        [0, 3, 6, 7],  # 3*3 -> 7 instead of 9: the single approximate cell
    ],
    dtype=np.int64,
)


def _kulkarni_rec(a: np.ndarray, b: np.ndarray, bits: int) -> np.ndarray:
    if bits == 2:
        return _KULKARNI_2X2[a, b]
    h = bits // 2
    mask = (1 << h) - 1
    al, ah = a & mask, a >> h
    bl, bh = b & mask, b >> h
    ll = _kulkarni_rec(al, bl, h)
    lh = _kulkarni_rec(al, bh, h)
    hl = _kulkarni_rec(ah, bl, h)
    hh = _kulkarni_rec(ah, bh, h)
    return ll + ((lh + hl) << h) + (hh << (2 * h))


def mul8_kulkarni(a, b) -> np.ndarray:
    """Kulkarni et al. (VLSID'11) underdesigned multiplier: an 8x8 array
    recursively composed of 2x2 blocks whose single inaccurate entry is
    3*3 -> 7.  Adders in the recomposition tree are exact.
    """
    return _kulkarni_rec(_u8(a), _u8(b), 8)


def signed_wrap(fn):
    """Lift an unsigned 8x8 behavioral model to signed int8 x int8.

    Sign-magnitude wrapper: p = sign(a)*sign(b) * fn(|a|, |b|).  This is
    our mul8s extension (DESIGN.md §8).  |-128| = 128 is passed through to
    the unsigned core unchanged (it fits the 8-bit domain), so the exact
    signed multiplier is bit-exact over the full int8 range.
    """

    def signed(a, b):
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        sgn = np.sign(a) * np.sign(b)
        return sgn * fn(np.abs(a), np.abs(b))

    return signed
