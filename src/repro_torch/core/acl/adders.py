"""Behavioral models of W-bit approximate adders (default W=16).

Vectorized numpy models ``f(a, b) -> s`` over unsigned W-bit operands.
Families: lower-OR (LOA), truncated, carry-cut segmented (ETA-II-like),
and speculative carry (almost-correct adder).  These span the error-vs-cost
spectrum of the FPGA approximate-adder literature referenced by the paper
([13], [16]).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "add_exact",
    "add_loa",
    "add_trunc",
    "add_segmented",
    "add_eta1",
    "add_speculative",
]


def _uw(x, w: int) -> np.ndarray:
    return np.asarray(x, dtype=np.int64) & ((1 << w) - 1)


def add_exact(a, b, *, w: int = 16) -> np.ndarray:
    """Exact W-bit adder (full (W+1)-bit sum, no wraparound)."""
    return _uw(a, w) + _uw(b, w)


def add_loa(a, b, *, k: int, w: int = 16) -> np.ndarray:
    """Lower-OR adder: low k bits are a|b (no carry generated into the
    accurate upper (W-k)-bit adder)."""
    a, b = _uw(a, w), _uw(b, w)
    mask = (1 << k) - 1
    low = (a | b) & mask
    high = ((a >> k) + (b >> k)) << k
    return high + low


def add_trunc(a, b, *, k: int, w: int = 16) -> np.ndarray:
    """Truncated adder: low k bits of both operands are zeroed."""
    a, b = _uw(a, w), _uw(b, w)
    mask = ~np.int64((1 << k) - 1)
    return (a & mask) + (b & mask)


def add_segmented(a, b, *, seg: int, w: int = 16) -> np.ndarray:
    """Carry-cut segmented adder (ETA-II style): the adder is split into
    ceil(W/seg) independent segments; carries do not propagate across
    segment boundaries (each segment's carry-out is dropped, except the
    top segment which keeps its carry to preserve the (W+1)-bit range)."""
    a, b = _uw(a, w), _uw(b, w)
    out = np.zeros_like(a)
    nseg = (w + seg - 1) // seg
    for i in range(nseg):
        lo = i * seg
        width = min(seg, w - lo)
        m = (1 << width) - 1
        s = ((a >> lo) & m) + ((b >> lo) & m)
        if i < nseg - 1:
            s = s & m  # drop the segment carry-out
        out = out + (s << lo)
    return out


def add_eta1(a, b, *, k: int, w: int = 16) -> np.ndarray:
    """Error-tolerant adder type I (Zhu et al.): exact upper part; the low
    k bits are produced MSB->LSB until the first position where both
    operand bits are 1, after which every lower output bit is forced to 1.
    """
    a, b = _uw(a, w), _uw(b, w)
    low = np.zeros_like(a)
    flood = np.zeros_like(a, dtype=bool)
    for i in range(k - 1, -1, -1):
        ai = (a >> i) & 1
        bi = (b >> i) & 1
        both = (ai & bi).astype(bool)
        bit = np.where(flood, 1, ai | bi)
        low = low | (bit << i)
        flood = flood | both
    high = ((a >> k) + (b >> k)) << k
    return high + low


def add_speculative(a, b, *, la: int, w: int = 16) -> np.ndarray:
    """Almost-correct adder: each sum bit i uses a carry speculated from
    only the previous `la` bit positions (carry lookahead window).  Exact
    when the true carry chain is shorter than `la`."""
    a, b = _uw(a, w), _uw(b, w)
    out = np.zeros_like(a)
    for i in range(w + 1):
        lo = max(0, i - la)
        # carry into bit i computed from the window [lo, i)
        aw = (a >> lo) & ((1 << (i - lo)) - 1)
        bw = (b >> lo) & ((1 << (i - lo)) - 1)
        carry = ((aw + bw) >> (i - lo)) & 1 if i > lo else np.zeros_like(a)
        ai = (a >> i) & 1
        bi = (b >> i) & 1
        out = out | (((ai + bi + carry) & 1) << i)
    return out
