"""Pure random search as an ask/tell strategy.

The exploration baseline of the paper's Figs. 8/9: draw genomes
uniformly, keep the non-dominated survivors.  ``random_search`` in
``core.dse`` drives this class with ground-truth labels directly (one
round covering the whole budget, so its labeler sees exactly the legacy
batch); through a ``Campaign`` it spends the same surrogate budget as
NSGA-II, which is what ``benchmarks/strategy_quality.py`` compares.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..nsga2 import GenerationLog, NSGA2Result, _select_parents
from ..pareto import non_dominated_mask
from .base import SearchStrategy, decode_array, encode_array

__all__ = ["RandomStrategy"]


class RandomStrategy(SearchStrategy):
    name = "random"

    def __init__(
        self,
        gene_sizes,
        *,
        n_total: int = 1000,
        batch_size: Optional[int] = None,
        n_parents: Optional[int] = None,
        seed: int = 0,
        keep_history: bool = True,
    ):
        self.gene_sizes = np.asarray(gene_sizes, dtype=np.int64)
        self.n_total = int(n_total)
        self.batch_size = int(batch_size) if batch_size else self.n_total
        self.n_parents = n_parents          # None = keep every observation
        self.seed = int(seed)
        self.keep_history = keep_history
        self._rng = np.random.default_rng(self.seed)
        self._drawn = 0
        self._round = 0
        self._pending: Optional[np.ndarray] = None
        self._obs_g: List[np.ndarray] = []  # observed batches, ask order
        self._obs_o: List[np.ndarray] = []
        self.n_evaluated = 0
        self.history: List[GenerationLog] = []

    # ------------------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._drawn >= self.n_total and self._pending is None

    def ask(self) -> np.ndarray:
        if self.done:
            raise RuntimeError("strategy is done; ask() has no next batch")
        if self._pending is None:
            n = min(self.batch_size, self.n_total - self._drawn)
            self._pending = self._rng.integers(
                0, self.gene_sizes[None, :], size=(n, len(self.gene_sizes))
            )
            self._drawn += n
        return self._pending

    def tell(self, genomes, objectives) -> Optional[GenerationLog]:
        genomes = self._check_tell(self._pending, genomes)
        objectives = np.asarray(objectives, dtype=np.float64)
        self._obs_g.append(np.array(genomes))
        self._obs_o.append(objectives)
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
        G = np.concatenate(self._obs_g)
        O = np.concatenate(self._obs_o)
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
            "n_generations": -(-self.n_total // self.batch_size),
            "surrogate_evals": int(self.n_evaluated),
            "done": bool(self.done),
        }

    # ------------------------------------------------------------------
    def state(self) -> Dict:
        return {
            "name": self.name,
            "gene_sizes": encode_array(self.gene_sizes),
            "n_total": self.n_total,
            "batch_size": self.batch_size,
            "n_parents": self.n_parents,
            "seed": self.seed,
            "rng": self._rng.bit_generator.state,
            "drawn": self._drawn,
            "round": self._round,
            "pending": encode_array(self._pending),
            "obs_g": [encode_array(a) for a in self._obs_g],
            "obs_o": [encode_array(a) for a in self._obs_o],
            "n_evaluated": self.n_evaluated,
        }

    def restore(self, state: Dict) -> "RandomStrategy":
        self.gene_sizes = decode_array(state["gene_sizes"])
        g = len(self.gene_sizes)
        self.n_total = state["n_total"]
        self.batch_size = state["batch_size"]
        self.n_parents = state["n_parents"]
        self.seed = state["seed"]
        self._rng = np.random.default_rng()
        self._rng.bit_generator.state = state["rng"]
        self._drawn = state["drawn"]
        self._round = state["round"]
        self._pending = decode_array(state["pending"], width=g)
        self._obs_g = [decode_array(a, width=g) for a in state["obs_g"]]
        self._obs_o = [decode_array(a, dtype=np.float64)
                       for a in state["obs_o"]]
        self.n_evaluated = state["n_evaluated"]
        self.history = []
        return self
