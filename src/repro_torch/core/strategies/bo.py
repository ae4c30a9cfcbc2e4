"""Batch Bayesian optimization as an ask/tell strategy (AMG-style,
arXiv:2310.15495: BO replacing evolutionary search for approximate
multiplier selection).

Multi-objective handling is ParEGO-style: each round draws a random
weight vector, scalarizes the normalized observed objectives with the
augmented Chebyshev norm, fits a probabilistic model from the existing
surrogate registry (default ``bayesian_ridge``, whose posterior
``predict_std`` gives calibrated uncertainty; models without a std are
wrapped with a constant residual estimate), and picks the batch by
closed-form expected improvement over a candidate pool of random
genomes plus mutations of the current non-dominated set.

The strategy is deliberately a *different* explorer, not NSGA-II in a
hat: no crossover, no elitist selection — every proposal is
acquisition-driven.  It exists to prove the ask/tell seam carries a
genuinely different search, and to be compared on
hypervolume-per-evaluation in ``benchmarks/strategy_quality.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from ..nsga2 import GenerationLog, NSGA2Result, _select_parents
from ..pareto import non_dominated_mask
from ..surrogates import make as make_surrogate
from .base import SearchStrategy, decode_array, encode_array

__all__ = ["BOStrategy"]

_erf = np.frompyfunc(math.erf, 1, 1)


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + _erf(z / math.sqrt(2.0)).astype(np.float64))


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _row_keys(genomes: np.ndarray, width: int) -> np.ndarray:
    """(n, width) int64 genomes -> (n,) void row keys: each key's bytes
    equal ``row.tobytes()``, but the whole batch is encoded in one C
    view instead of a per-row Python loop."""
    a = np.ascontiguousarray(
        np.atleast_2d(np.asarray(genomes, dtype=np.int64))
    ).reshape(-1, width)
    return a.view(np.dtype((np.void, a.dtype.itemsize * width))).reshape(-1)


def _first_occurrence(keys: np.ndarray) -> np.ndarray:
    """Indices of each key's first occurrence, in original order (the
    vectorized equivalent of the seen-set dedup loop)."""
    _, first = np.unique(keys, return_index=True)
    return np.sort(first)


class BOStrategy(SearchStrategy):
    name = "bo"

    def __init__(
        self,
        gene_sizes,
        *,
        n_rounds: int = 10,
        batch_size: int = 16,
        n_parents: Optional[int] = None,
        model: str = "bayesian_ridge",
        pool_size: Optional[int] = None,
        mutation_prob: float = 0.15,
        seed: int = 0,
        init: Optional[np.ndarray] = None,
        keep_history: bool = True,
    ):
        self.gene_sizes = np.asarray(gene_sizes, dtype=np.int64)
        self.n_rounds = int(n_rounds)
        self.batch_size = int(batch_size)
        self.n_parents = n_parents
        self.model = model
        self.pool_size = int(pool_size) if pool_size else 8 * self.batch_size
        self.mutation_prob = float(mutation_prob)
        self.seed = int(seed)
        self.keep_history = keep_history
        self._rng = np.random.default_rng(self.seed)
        self._init = None if init is None else np.asarray(init, dtype=np.int64)
        self._round = 0
        self._pending: Optional[np.ndarray] = None
        self._obs_g: List[np.ndarray] = []
        self._obs_o: List[np.ndarray] = []
        self._seen_keys = _row_keys(
            np.empty((0, len(self.gene_sizes)), dtype=np.int64),
            len(self.gene_sizes),
        )
        self.n_evaluated = 0
        self.history: List[GenerationLog] = []

    # ------------------------------------------------------------------
    @property
    def done(self) -> bool:
        # round 0 is the initial design, then n_rounds acquisition rounds
        return self._round > self.n_rounds and self._pending is None

    def _encode(self, genomes: np.ndarray) -> np.ndarray:
        """Genomes -> [0, 1] floats (the BO model's input space)."""
        span = np.maximum(self.gene_sizes - 1, 1).astype(np.float64)
        return genomes.astype(np.float64) / span[None, :]

    def _observed(self):
        return np.concatenate(self._obs_g), np.concatenate(self._obs_o)

    def _candidate_pool(self) -> np.ndarray:
        """Random genomes + mutations of the current non-dominated set,
        deduped against everything already observed.  Dedup is fully
        vectorized (void-view row keys + np.unique/np.isin), so growing
        the pool no longer grows a per-row Python loop."""
        g = len(self.gene_sizes)
        n_rand = self.pool_size // 2
        pool = [self._rng.integers(0, self.gene_sizes[None, :],
                                   size=(n_rand, g))]
        G, O = self._observed()
        elite = G[non_dominated_mask(O)]
        n_mut = self.pool_size - n_rand
        base = elite[self._rng.integers(0, len(elite), size=n_mut)]
        mut = self._rng.random(base.shape) < self.mutation_prob
        resets = self._rng.integers(0, self.gene_sizes[None, :],
                                    size=base.shape)
        pool.append(np.where(mut, resets, base))
        cand = np.concatenate(pool).astype(np.int64)
        keys = _row_keys(cand, g)
        first = _first_occurrence(keys)
        keep = first[~np.isin(keys[first], self._seen_keys)]
        return cand[keep] if len(keep) else cand[:0]

    def _acquire(self) -> np.ndarray:
        """One ParEGO round: scalarize, fit, maximize EI over the pool."""
        G, O = self._observed()
        lo, hi = O.min(axis=0), O.max(axis=0)
        Z = (O - lo) / np.where(hi > lo, hi - lo, 1.0)
        w = self._rng.random(O.shape[1])
        w = w / w.sum()
        y = (w * Z).max(axis=1) + 0.05 * (w * Z).sum(axis=1)
        m = make_surrogate(self.model, seed=self.seed).fit(self._encode(G), y)
        cand = self._candidate_pool()
        if len(cand) == 0:
            # space exhausted: fall back to fresh uniform draws
            return self._rng.integers(
                0, self.gene_sizes[None, :],
                size=(self.batch_size, len(self.gene_sizes)),
            )
        Xc = self._encode(cand)
        mu = np.asarray(m.predict(Xc), dtype=np.float64)
        if hasattr(m, "predict_std"):
            sd = np.asarray(m.predict_std(Xc), dtype=np.float64)
        else:
            resid = y - np.asarray(m.predict(self._encode(G)))
            sd = np.full(len(cand), float(resid.std()) or 1e-6)
        sd = np.maximum(sd, 1e-9)
        imp = float(y.min()) - mu              # minimization EI
        z = imp / sd
        ei = imp * _norm_cdf(z) + sd * _norm_pdf(z)
        order = np.argsort(-ei, kind="stable")
        return cand[order[: min(self.batch_size, len(cand))]]

    def ask(self) -> np.ndarray:
        if self.done:
            raise RuntimeError("strategy is done; ask() has no next batch")
        if self._pending is None:
            if self._round == 0:
                if self._init is not None:
                    batch = self._init
                else:
                    batch = self._rng.integers(
                        0, self.gene_sizes[None, :],
                        size=(self.batch_size, len(self.gene_sizes)),
                    )
                # dedup the initial design against itself (vectorized
                # first-occurrence, original order preserved)
                batch = np.asarray(batch, dtype=np.int64)
                batch = batch[_first_occurrence(
                    _row_keys(batch, len(self.gene_sizes))
                )]
            else:
                batch = self._acquire()
            self._pending = np.asarray(batch, dtype=np.int64)
        return self._pending

    def tell(self, genomes, objectives) -> Optional[GenerationLog]:
        genomes = self._check_tell(self._pending, genomes)
        objectives = np.asarray(objectives, dtype=np.float64)
        self._obs_g.append(np.array(genomes))
        self._obs_o.append(objectives)
        self._seen_keys = np.concatenate([
            self._seen_keys, _row_keys(genomes, len(self.gene_sizes)),
        ])
        self.n_evaluated += len(genomes)
        log = GenerationLog(self._round, np.array(genomes), objectives,
                            self.n_evaluated)
        if self.keep_history:
            self.history.append(log)
        self._round += 1
        self._pending = None
        return log

    def result(self) -> NSGA2Result:
        if not self._obs_g:
            raise RuntimeError("no population evaluated yet")
        G, O = self._observed()
        if self.n_parents is not None and self.n_parents < len(G):
            G, O, _ = _select_parents(G, O, self.n_parents)
        return NSGA2Result(
            genomes=G,
            objectives=O,
            front_mask=non_dominated_mask(O),
            history=self.history,
            n_evaluated=self.n_evaluated,
        )

    def progress(self) -> Dict:
        return {
            "strategy": self.name,
            "generation": int(self._round),
            "n_generations": int(self.n_rounds) + 1,
            "surrogate_evals": int(self.n_evaluated),
            "done": bool(self.done),
        }

    # ------------------------------------------------------------------
    def state(self) -> Dict:
        return {
            "name": self.name,
            "gene_sizes": encode_array(self.gene_sizes),
            "n_rounds": self.n_rounds,
            "batch_size": self.batch_size,
            "n_parents": self.n_parents,
            "model": self.model,
            "pool_size": self.pool_size,
            "mutation_prob": self.mutation_prob,
            "seed": self.seed,
            "rng": self._rng.bit_generator.state,
            "init": encode_array(self._init),
            "round": self._round,
            "pending": encode_array(self._pending),
            "obs_g": [encode_array(a) for a in self._obs_g],
            "obs_o": [encode_array(a) for a in self._obs_o],
            "n_evaluated": self.n_evaluated,
        }

    def restore(self, state: Dict) -> "BOStrategy":
        self.gene_sizes = decode_array(state["gene_sizes"])
        g = len(self.gene_sizes)
        for k in ("n_rounds", "batch_size", "n_parents", "model",
                  "pool_size", "mutation_prob", "seed"):
            setattr(self, k, state[k])
        self._rng = np.random.default_rng()
        self._rng.bit_generator.state = state["rng"]
        self._init = decode_array(state["init"], width=g)
        self._round = state["round"]
        self._pending = decode_array(state["pending"], width=g)
        self._obs_g = [decode_array(a, width=g) for a in state["obs_g"]]
        self._obs_o = [decode_array(a, dtype=np.float64)
                       for a in state["obs_o"]]
        self._seen_keys = _row_keys(
            np.concatenate(self._obs_g) if self._obs_g
            else np.empty((0, g), dtype=np.int64), g,
        )
        self.n_evaluated = state["n_evaluated"]
        self.history = []
        return self
    # NOTE: history is not round-tripped (it can be large and the result
    # front does not depend on it); a resumed strategy's history covers
    # post-restore rounds only.
