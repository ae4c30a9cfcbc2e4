"""Pareto-front utilities (minimization convention throughout).

Objectives are (n, m) float arrays; smaller is better on every axis.
QoR-style "bigger is better" objectives are negated by the caller.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = [
    "dominates",
    "non_dominated_mask",
    "fast_non_dominated_sort",
    "crowding_distance",
    "pareto_front",
    "hypervolume_2d",
]


def dominates(a: np.ndarray, b: np.ndarray) -> bool:
    """True iff a <= b on all axes and a < b on at least one."""
    return bool(np.all(a <= b) and np.any(a < b))


def non_dominated_mask(obj: np.ndarray) -> np.ndarray:
    """Boolean mask of the non-dominated points of `obj` (n, m).

    O(n^2) vectorized pairwise check — fine for n up to a few 10^4.
    """
    obj = np.asarray(obj, dtype=np.float64)
    n = obj.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)
    # le[i, j] = obj[i] <= obj[j] on all axes; lt = strictly on some axis
    le = np.all(obj[:, None, :] <= obj[None, :, :], axis=-1)
    lt = np.any(obj[:, None, :] < obj[None, :, :], axis=-1)
    dom = le & lt  # dom[i, j]: i dominates j
    return ~dom.any(axis=0)


def fast_non_dominated_sort(obj: np.ndarray) -> List[np.ndarray]:
    """NSGA-II fast non-dominated sort: list of index arrays, front 0 first."""
    obj = np.asarray(obj, dtype=np.float64)
    n = obj.shape[0]
    le = np.all(obj[:, None, :] <= obj[None, :, :], axis=-1)
    lt = np.any(obj[:, None, :] < obj[None, :, :], axis=-1)
    dom = le & lt                       # dom[i, j]: i dominates j
    n_dom = dom.sum(axis=0).astype(np.int64)  # how many dominate j
    fronts: List[np.ndarray] = []
    current = np.flatnonzero(n_dom == 0)
    assigned = np.zeros(n, dtype=bool)
    while current.size:
        fronts.append(current)
        assigned[current] = True
        # remove the current front's domination counts
        n_dom = n_dom - dom[current].sum(axis=0)
        nxt = np.flatnonzero((n_dom == 0) & ~assigned)
        current = nxt
    return fronts


def crowding_distance(obj: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance for one front (n, m); boundary points inf."""
    obj = np.asarray(obj, dtype=np.float64)
    n, m = obj.shape
    if n <= 2:
        return np.full(n, np.inf)
    dist = np.zeros(n)
    for k in range(m):
        order = np.argsort(obj[:, k], kind="stable")
        vals = obj[order, k]
        span = vals[-1] - vals[0]
        dist[order[0]] = np.inf
        dist[order[-1]] = np.inf
        if span > 0:
            dist[order[1:-1]] += (vals[2:] - vals[:-2]) / span
    return dist


def pareto_front(obj: np.ndarray) -> np.ndarray:
    """Indices of the non-dominated points, sorted by first objective."""
    idx = np.flatnonzero(non_dominated_mask(obj))
    return idx[np.argsort(np.asarray(obj)[idx, 0], kind="stable")]


def hypervolume_2d(obj: np.ndarray, ref: Sequence[float]) -> float:
    """Exact 2-D hypervolume (minimization) w.r.t. reference point `ref`.

    Used by tests and by the Fig. 7 generation-quality benchmark.
    """
    obj = np.asarray(obj, dtype=np.float64)
    assert obj.shape[1] == 2, "hypervolume_2d is 2-D only"
    ref = np.asarray(ref, dtype=np.float64)
    pts = obj[non_dominated_mask(obj)]
    pts = pts[np.all(pts < ref, axis=1)]
    if pts.shape[0] == 0:
        return 0.0
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    hv = 0.0
    prev_y = ref[1]
    for x, y in pts:
        hv += (ref[0] - x) * (prev_y - y)
        prev_y = y
    return float(hv)
