"""NSGA-II [24] over integer genomes, as used by the paper's exploration
stage (Section II-B): population 1000, elite parent set 200, 1000
generations (with the paper's own Fig. 7 observation that ~10x fewer
generations suffice — exposed as a knob).

A genome is an integer vector; gene i takes values in [0, gene_sizes[i]).
For accelerator DSE, genes are (circuit index per slot) and optionally
(correction rank per slot).  ``evaluate`` maps a (n, g) genome batch to a
(n, m) objective batch, minimization convention.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from .pareto import crowding_distance, fast_non_dominated_sort

__all__ = ["NSGA2Config", "GenerationLog", "NSGA2Result", "nsga2"]


@dataclass(frozen=True)
class NSGA2Config:
    pop_size: int = 1000          # paper: 1000 variants per generation
    n_parents: int = 200          # paper: 200 best kept as parents
    n_generations: int = 100      # paper: 1000; Fig. 7 shows ~100 suffices
    crossover_prob: float = 0.9
    mutation_prob: float = 0.05   # per gene: random reset
    seed: int = 0
    dedup: bool = True            # never re-evaluate an identical genome


@dataclass
class GenerationLog:
    generation: int
    genomes: np.ndarray      # (pop, g) the evaluated population
    objectives: np.ndarray   # (pop, m)
    n_evaluated: int         # surrogate calls so far (cumulative)


@dataclass
class NSGA2Result:
    genomes: np.ndarray        # final parent set (n_parents, g)
    objectives: np.ndarray     # (n_parents, m)
    front_mask: np.ndarray     # non-dominated mask within the parent set
    history: List[GenerationLog] = field(default_factory=list)
    n_evaluated: int = 0

    @property
    def front_genomes(self) -> np.ndarray:
        return self.genomes[self.front_mask]

    @property
    def front_objectives(self) -> np.ndarray:
        return self.objectives[self.front_mask]


def _select_parents(
    genomes: np.ndarray, obj: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Elitist environmental selection: fill k slots front-by-front, break
    the last front by crowding distance.  Returns (genomes, obj, rank)."""
    fronts = fast_non_dominated_sort(obj)
    chosen: List[int] = []
    rank = np.zeros(len(obj), dtype=np.int64)
    for fi, front in enumerate(fronts):
        rank[front] = fi
        if len(chosen) + len(front) <= k:
            chosen.extend(front.tolist())
        else:
            cd = crowding_distance(obj[front])
            order = np.argsort(-cd, kind="stable")
            chosen.extend(front[order[: k - len(chosen)]].tolist())
            break
    idx = np.array(chosen, dtype=np.int64)
    return genomes[idx], obj[idx], rank[idx]


def _tournament(
    rng: np.random.Generator, rank: np.ndarray, cd: np.ndarray, n: int
) -> np.ndarray:
    """Binary tournament with the crowded-comparison operator."""
    a = rng.integers(0, len(rank), size=n)
    b = rng.integers(0, len(rank), size=n)
    a_wins = (rank[a] < rank[b]) | ((rank[a] == rank[b]) & (cd[a] > cd[b]))
    return np.where(a_wins, a, b)


def _offspring(
    rng: np.random.Generator,
    parents: np.ndarray,
    rank: np.ndarray,
    cd: np.ndarray,
    gene_sizes: np.ndarray,
    n: int,
    cfg: NSGA2Config,
) -> np.ndarray:
    i = _tournament(rng, rank, cd, n)
    j = _tournament(rng, rank, cd, n)
    pa, pb = parents[i], parents[j]
    # uniform crossover
    cross = rng.random((n, 1)) < cfg.crossover_prob
    take_b = rng.random(pa.shape) < 0.5
    child = np.where(cross & take_b, pb, pa)
    # per-gene random-reset mutation
    mut = rng.random(child.shape) < cfg.mutation_prob
    resets = rng.integers(0, gene_sizes[None, :], size=child.shape)
    return np.where(mut, resets, child)


def nsga2(
    gene_sizes,
    evaluate: Callable[[np.ndarray], np.ndarray],
    cfg: Optional[NSGA2Config] = None,
    *,
    init: Optional[np.ndarray] = None,
    callback: Optional[Callable[[GenerationLog], None]] = None,
    keep_history: bool = True,
) -> NSGA2Result:
    """Run NSGA-II to completion.  ``evaluate`` is called on full
    generations (vectorized surrogate evaluation is the whole point of
    the paper).

    This is now a thin drive-to-completion loop over the ask/tell
    ``strategies.NSGA2Strategy`` — interruptible callers (the campaign
    service) step the strategy themselves and snapshot between rounds."""
    from .strategies.nsga2 import NSGA2Strategy

    cfg = cfg if cfg is not None else NSGA2Config()
    strat = NSGA2Strategy(gene_sizes, cfg, init=init,
                          keep_history=keep_history or callback is not None)
    while not strat.done:
        genomes = strat.ask()
        if len(genomes):
            obj = np.asarray(evaluate(genomes), dtype=np.float64)
        else:
            # every candidate is cached: tell() rebuilds the generation
            # from its cache and never reads the (empty) objectives
            obj = np.zeros((0, 0))
        log = strat.tell(genomes, obj)
        if callback is not None and log is not None:
            callback(log)
    res = strat.result()
    if not keep_history:
        res.history = []
    return res
