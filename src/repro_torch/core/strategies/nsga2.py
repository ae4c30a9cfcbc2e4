"""NSGA-II as an ask/tell strategy — generation-at-a-time, seed-identical
to the classic ``core.nsga2.nsga2`` loop (which is now a thin wrapper over
this class).

Round structure:

    round -1   ask -> the initial population (``init`` or a seeded random
               draw); tell -> elitist selection of the first parent set.
    round g    ask -> the offspring of generation g (tournament +
               uniform crossover + random-reset mutation, consuming the
               RNG in exactly the legacy order); tell -> (mu + lambda)
               environmental selection.

With ``cfg.dedup`` the strategy keeps the objective cache itself: ask()
returns only the rows whose objectives it has never seen (first
occurrence order, duplicates within the batch skipped) and tell()
scatters the cached rows back over the full generation — so the
surrogate-call accounting (``n_evaluated``) matches the legacy loop
exactly.
"""

from __future__ import annotations

from dataclasses import asdict
from typing import Dict, List, Optional

import numpy as np

from ..nsga2 import (
    GenerationLog,
    NSGA2Config,
    NSGA2Result,
    _offspring,
    _select_parents,
)
from ..pareto import crowding_distance, fast_non_dominated_sort, non_dominated_mask
from .base import SearchStrategy, decode_array, encode_array

__all__ = ["NSGA2Strategy"]


class NSGA2Strategy(SearchStrategy):
    name = "nsga2"

    def __init__(
        self,
        gene_sizes,
        cfg: Optional[NSGA2Config] = None,
        *,
        init: Optional[np.ndarray] = None,
        keep_history: bool = True,
    ):
        self.gene_sizes = np.asarray(gene_sizes, dtype=np.int64)
        self.cfg = cfg if cfg is not None else NSGA2Config()
        self.keep_history = keep_history
        self._rng = np.random.default_rng(self.cfg.seed)
        # init is drawn lazily at the first ask() so restore() on a fresh
        # instance never wastes (or disturbs) RNG draws
        self._init = None if init is None else np.asarray(init, dtype=np.int64)
        self._cache: Dict[bytes, np.ndarray] = {}
        self._gen = -1                    # -1 = initial-population round
        self._parents: Optional[np.ndarray] = None
        self._pobj: Optional[np.ndarray] = None
        self._pending: Optional[np.ndarray] = None   # full batch awaiting tell
        self._fresh: Optional[np.ndarray] = None     # its uncached rows
        self.n_evaluated = 0
        self.history: List[GenerationLog] = []

    # ------------------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._gen >= self.cfg.n_generations

    def ask(self) -> np.ndarray:
        if self.done:
            raise RuntimeError("strategy is done; ask() has no next batch")
        if self._pending is None:
            if self._gen == -1:
                if self._init is not None:
                    batch = self._init
                else:
                    batch = self._rng.integers(
                        0, self.gene_sizes[None, :],
                        size=(self.cfg.pop_size, len(self.gene_sizes)),
                    )
            else:
                fronts = fast_non_dominated_sort(self._pobj)
                rank = np.zeros(len(self._pobj), dtype=np.int64)
                cd = np.zeros(len(self._pobj))
                for fi, front in enumerate(fronts):
                    rank[front] = fi
                    cd[front] = crowding_distance(self._pobj[front])
                batch = _offspring(
                    self._rng, self._parents, rank, cd,
                    self.gene_sizes, self.cfg.pop_size, self.cfg,
                )
            self._pending = np.asarray(batch, dtype=np.int64)
            self._fresh = self._fresh_rows(self._pending)
        return self._fresh

    def _fresh_rows(self, batch: np.ndarray) -> np.ndarray:
        if not self.cfg.dedup:
            return batch
        rows, seen = [], set()
        for k, g in enumerate(batch):
            key = g.tobytes()
            if key not in self._cache and key not in seen:
                seen.add(key)
                rows.append(k)
        if not rows:
            return batch[:0]
        return batch[np.array(rows)]

    def tell(self, genomes, objectives) -> Optional[GenerationLog]:
        genomes = self._check_tell(self._fresh, genomes)
        objectives = np.asarray(objectives, dtype=np.float64)
        batch = self._pending
        if self.cfg.dedup:
            for g, row in zip(genomes, objectives):
                self._cache[g.tobytes()] = row
            self.n_evaluated += len(genomes)
            full = np.stack([self._cache[g.tobytes()] for g in batch])
        else:
            self.n_evaluated += len(genomes)
            full = objectives
        log = None
        if self._gen == -1:
            self._parents, self._pobj, _ = _select_parents(
                batch, full, self.cfg.n_parents
            )
        else:
            log = GenerationLog(self._gen, batch, full, self.n_evaluated)
            if self.keep_history:
                self.history.append(log)
            allg = np.concatenate([self._parents, batch], axis=0)
            allo = np.concatenate([self._pobj, full], axis=0)
            self._parents, self._pobj, _ = _select_parents(
                allg, allo, self.cfg.n_parents
            )
        self._gen += 1
        self._pending = self._fresh = None
        return log

    def result(self) -> NSGA2Result:
        if self._parents is None:
            raise RuntimeError("no population evaluated yet")
        return NSGA2Result(
            genomes=self._parents,
            objectives=self._pobj,
            front_mask=non_dominated_mask(self._pobj),
            history=self.history,
            n_evaluated=self.n_evaluated,
        )

    def progress(self) -> Dict:
        return {
            "strategy": self.name,
            "generation": int(max(self._gen, 0)),
            "n_generations": int(self.cfg.n_generations),
            "surrogate_evals": int(self.n_evaluated),
            "done": bool(self.done),
        }

    # ------------------------------------------------------------------
    def state(self) -> Dict:
        cache_g = [list(map(int, np.frombuffer(k, dtype=np.int64)))
                   for k in self._cache]
        cache_o = [encode_array(v) for v in self._cache.values()]
        return {
            "name": self.name,
            "cfg": asdict(self.cfg),
            "gene_sizes": encode_array(self.gene_sizes),
            "rng": self._rng.bit_generator.state,
            "gen": int(self._gen),
            "n_evaluated": int(self.n_evaluated),
            "parents": encode_array(self._parents),
            "pobj": encode_array(self._pobj),
            "init": encode_array(self._init),
            "pending": encode_array(self._pending),
            "cache_genomes": cache_g,
            "cache_obj": cache_o,
            "history": [
                {
                    "generation": int(h.generation),
                    "genomes": encode_array(h.genomes),
                    "objectives": encode_array(h.objectives),
                    "n_evaluated": int(h.n_evaluated),
                }
                for h in self.history
            ],
        }

    def restore(self, state: Dict) -> "NSGA2Strategy":
        self.cfg = NSGA2Config(**state["cfg"])
        self.gene_sizes = decode_array(state["gene_sizes"])
        g = len(self.gene_sizes)
        self._rng = np.random.default_rng()
        self._rng.bit_generator.state = state["rng"]
        self._gen = state["gen"]
        self.n_evaluated = state["n_evaluated"]
        self._parents = decode_array(state["parents"], width=g)
        self._pobj = decode_array(state["pobj"], dtype=np.float64)
        self._init = decode_array(state["init"], width=g)
        self._pending = decode_array(state["pending"], width=g)
        self._cache = {
            np.asarray(gg, dtype=np.int64).tobytes():
                np.asarray(oo, dtype=np.float64)
            for gg, oo in zip(state["cache_genomes"], state["cache_obj"])
        }
        self._fresh = (self._fresh_rows(self._pending)
                       if self._pending is not None else None)
        self.history = [
            GenerationLog(
                h["generation"],
                decode_array(h["genomes"], width=g),
                decode_array(h["objectives"], dtype=np.float64),
                h["n_evaluated"],
            )
            for h in state["history"]
        ]
        return self
