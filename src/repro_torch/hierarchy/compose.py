"""Stage-front composition: per-stage Pareto fronts -> application candidates.

The autoAx decomposition: search each component, keep its front, compose
fronts instead of searching the product space.  Composition combines
objective vectors (minimization convention throughout, as core.pareto):

  * hardware objectives (energy, latency, flops, ...) — summed: stage
    deployments execute back-to-back, and the marginal-energy model is
    separable across stages (synth.synthesize_variant),
  * the QoR column (``-psnr``) — additive noise power:
        psnr_c = -10*log10(sum_i 10^(-psnr_i/10))
    i.e. stage error signals are treated as independent additive noise.
    This is an *estimate* used only to rank candidates; the surviving
    candidates are re-labeled end-to-end by search.py.

Both maps are monotone in every stage input, so a dominated partial
composition can never complete into a non-dominated full composition —
the incremental fold below prunes to the non-dominated set after each
stage and never materializes the full cross-product.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..core.pareto import non_dominated_mask

__all__ = [
    "StageFront",
    "ComposeStats",
    "ComposeResult",
    "compose_qor",
    "truncate_front",
    "compose_fronts",
]


@dataclass(frozen=True)
class StageFront:
    """One stage's Pareto front: stage-local genomes + objectives (n, m),
    minimization convention (the QoR column is ``-psnr``)."""

    genomes: np.ndarray
    objectives: np.ndarray

    def __post_init__(self):
        assert len(self.genomes) == len(self.objectives)
        assert len(self.genomes) > 0, "a stage front cannot be empty"


@dataclass
class ComposeStats:
    stage_sizes: List[int] = field(default_factory=list)      # as given
    truncated_sizes: List[int] = field(default_factory=list)  # after k_per_stage
    cross_product_size: float = 0.0   # full product of truncated sizes
    pairs_evaluated: int = 0          # partial compositions materialized
    survivors: int = 0


@dataclass
class ComposeResult:
    """``indices[t, i]`` selects the row of stage ``i``'s (truncated)
    front used by candidate ``t``; ``objectives`` are the composed
    estimates; ``stage_genomes[i]`` is the truncated front ``i`` genome
    array the indices point into."""

    indices: np.ndarray           # (n_candidates, n_stages) int
    objectives: np.ndarray        # (n_candidates, m)
    stage_genomes: List[np.ndarray]
    stats: ComposeStats


def compose_qor(neg_psnr_a: np.ndarray, neg_psnr_b: np.ndarray) -> np.ndarray:
    """Combine two ``-psnr`` columns by additive noise power (monotone
    increasing in both arguments, hence pruning-safe)."""
    return 10.0 * np.log10(
        np.power(10.0, neg_psnr_a / 10.0) + np.power(10.0, neg_psnr_b / 10.0)
    )


def _combine(a: np.ndarray, b: np.ndarray, qor_index: Optional[int]) -> np.ndarray:
    """Pairwise composition: (n, m) x (k, m) -> (n*k, m)."""
    out = a[:, None, :] + b[None, :, :]
    if qor_index is not None:
        out[:, :, qor_index] = compose_qor(
            a[:, None, qor_index], b[None, :, qor_index]
        )
    return out.reshape(-1, a.shape[1])


def truncate_front(objectives: np.ndarray, k: Optional[int],
                   *, sort_index: int = 0) -> np.ndarray:
    """Indices of at most ``k`` points spread evenly along the front
    (sorted by ``sort_index``), always keeping both extremes."""
    n = len(objectives)
    order = np.argsort(np.asarray(objectives)[:, sort_index], kind="stable")
    if k is None or n <= k:
        return order
    pick = np.unique(np.round(np.linspace(0, n - 1, k)).astype(np.int64))
    return order[pick]


def compose_fronts(
    fronts: Sequence[StageFront],
    *,
    qor_index: Optional[int] = 0,
    k_per_stage: Optional[int] = None,
    max_survivors: Optional[int] = None,
) -> ComposeResult:
    """Fold the stage fronts left-to-right with incremental non-dominated
    pruning.  ``k_per_stage`` truncates each stage front before the fold;
    ``max_survivors`` additionally caps the candidate set after each
    prune (evenly spaced along the front) to bound the fold itself."""
    assert len(fronts) >= 1
    stats = ComposeStats(stage_sizes=[len(f.genomes) for f in fronts])

    trunc_obj: List[np.ndarray] = []
    trunc_gen: List[np.ndarray] = []
    for f in fronts:
        sel = truncate_front(f.objectives, k_per_stage,
                             sort_index=qor_index if qor_index is not None else 0)
        trunc_obj.append(np.asarray(f.objectives, dtype=np.float64)[sel])
        trunc_gen.append(np.asarray(f.genomes)[sel])
    stats.truncated_sizes = [len(o) for o in trunc_obj]
    stats.cross_product_size = float(np.prod([float(n) for n in
                                              stats.truncated_sizes]))

    cur_obj = trunc_obj[0]
    cur_idx = np.arange(len(cur_obj), dtype=np.int64)[:, None]
    for si in range(1, len(fronts)):
        nxt = trunc_obj[si]
        n, k = len(cur_obj), len(nxt)
        stats.pairs_evaluated += n * k
        obj = _combine(cur_obj, nxt, qor_index)
        idx = np.concatenate(
            [
                np.repeat(cur_idx, k, axis=0),
                np.tile(np.arange(k, dtype=np.int64), n)[:, None],
            ],
            axis=1,
        )
        mask = non_dominated_mask(obj)
        cur_obj, cur_idx = obj[mask], idx[mask]
        if max_survivors is not None and len(cur_obj) > max_survivors:
            sel = truncate_front(cur_obj, max_survivors,
                                 sort_index=qor_index
                                 if qor_index is not None else 0)
            cur_obj, cur_idx = cur_obj[sel], cur_idx[sel]

    stats.survivors = len(cur_obj)
    return ComposeResult(
        indices=cur_idx, objectives=cur_obj, stage_genomes=trunc_gen,
        stats=stats,
    )
