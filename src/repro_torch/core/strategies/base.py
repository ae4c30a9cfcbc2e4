"""The ask/tell ``SearchStrategy`` protocol — the exploration loop as an
interruptible state machine instead of a blocking function call.

A strategy never evaluates anything itself.  It proposes genome batches
(``ask``), receives their objective values back (``tell``), and keeps
every bit of loop state — RNG, population, round counter, history —
inside itself, where it can be captured (``state``) and re-installed
(``restore``) at any round boundary:

    strat = NSGA2Strategy(gene_sizes, NSGA2Config(...))
    while not strat.done:
        genomes = strat.ask()           # fresh genomes needing objectives
        strat.tell(genomes, evaluate(genomes) if len(genomes) else
                   np.zeros((0, n_obj)))
    result = strat.result()             # an NSGA2Result

Who computes the objectives is the caller's business: the ``Campaign``
loop (strategies.campaign) evaluates surrogates during EXPLORE and
routes ground truth through a labeler; ``random_search`` feeds true
labels straight in.  That inversion is what lets the service step many
campaigns cooperatively over one worker pool and resume a killed
campaign from its snapshot.

``state()`` must return a JSON-serializable dict (numpy arrays as
lists, RNG as ``Generator.bit_generator.state``) so snapshots can be
persisted next to the label store and survive a process death.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "SearchStrategy",
    "STRATEGIES",
    "register_strategy",
    "make_strategy",
    "available_strategies",
    "encode_array",
    "decode_array",
]


def encode_array(a: Optional[np.ndarray]) -> Optional[list]:
    """numpy -> nested lists (None passes through)."""
    return None if a is None else np.asarray(a).tolist()


def decode_array(v, dtype=np.int64, width: Optional[int] = None
                 ) -> Optional[np.ndarray]:
    """Inverse of encode_array; ``width`` disambiguates empty 2-D arrays."""
    if v is None:
        return None
    a = np.asarray(v, dtype=dtype)
    if a.size == 0 and width is not None:
        a = a.reshape(0, width)
    return a


class SearchStrategy:
    """Base class for ask/tell explorers over integer genome spaces.

    Subclasses implement ``ask``/``tell``/``done``/``result`` and the
    ``state``/``restore`` pair.  Contract:

      * ``ask()`` returns an (n, g) int64 batch of genomes whose
        objectives the strategy has not seen (n may be 0 when every
        candidate this round is already known); calling it twice
        without an intervening ``tell`` returns the same batch and
        consumes no randomness (idempotent, so a caller can be
        re-entered safely).
      * ``tell(genomes, objectives)`` must receive exactly the last
        ``ask`` batch with an (n, m) float64 objective matrix
        (minimization convention).  It returns the round's
        ``GenerationLog`` when a round completed, else None.
      * ``done`` is True once the budget is exhausted; ``ask`` then
        raises.
      * ``state()``/``restore(state)`` round-trip the FULL loop state at
        a round boundary (never between ask and tell — callers snapshot
        after tell).
    """

    name: str = "base"

    def ask(self) -> np.ndarray:
        raise NotImplementedError

    def tell(self, genomes: np.ndarray, objectives: np.ndarray):
        raise NotImplementedError

    @property
    def done(self) -> bool:
        raise NotImplementedError

    def result(self):
        """Final survivor set as an ``NSGA2Result`` (genomes, objectives,
        front_mask, history, n_evaluated)."""
        raise NotImplementedError

    def state(self) -> Dict:
        raise NotImplementedError

    def restore(self, state: Dict) -> "SearchStrategy":
        raise NotImplementedError

    def progress(self) -> Dict:
        """Small JSON-safe live-progress record (for GET /campaigns/<id>)."""
        return {"strategy": self.name, "done": bool(self.done)}

    # ------------------------------------------------------------------
    @staticmethod
    def _check_tell(expected: Optional[np.ndarray], genomes: np.ndarray
                    ) -> np.ndarray:
        """Validate a tell() batch against the outstanding ask()."""
        genomes = np.atleast_2d(np.asarray(genomes, dtype=np.int64))
        if expected is None:
            raise RuntimeError("tell() without a preceding ask()")
        if len(genomes) != len(expected) or (
                len(genomes) and not np.array_equal(genomes, expected)):
            raise ValueError(
                f"tell() batch does not match the last ask() batch "
                f"({len(genomes)} vs {len(expected)} genomes)"
            )
        return genomes


# ---------------------------------------------------------------------------
# registry: strategies plug in by name (CampaignSpec.strategy, --strategy)
# ---------------------------------------------------------------------------

# name -> factory(gene_sizes, dse_cfg, *, init=None) -> SearchStrategy.
# ``dse_cfg`` is a core.dse.DSEConfig: factories derive their budget from
# cfg.nsga (pop_size/n_parents/n_generations/seed) so every strategy
# spends a comparable number of objective evaluations per campaign.
STRATEGIES: Dict[str, Callable] = {}


def register_strategy(name: str, factory: Callable) -> None:
    """Register a strategy factory.  ``factory(gene_sizes, cfg, *,
    init=None)`` returns a fresh ``SearchStrategy``; ``init`` is the
    campaign's warm-started initial population (strategies may ignore
    it).  Last registration wins, so tests can shadow built-ins."""
    STRATEGIES[name] = factory


def make_strategy(name: str, gene_sizes, cfg, *, init=None) -> SearchStrategy:
    if name not in STRATEGIES:
        raise ValueError(
            f"unknown strategy {name!r}; known: {available_strategies()}"
        )
    return STRATEGIES[name](gene_sizes, cfg, init=init)


def available_strategies() -> List[str]:
    return sorted(STRATEGIES)
