"""Pluggable ask/tell search strategies + the ``Campaign`` stage machine.

The DSE core's central seam: explorers implement ``SearchStrategy``
(``ask``/``tell``/``state``/``restore``/``done``) and register a factory
under a name; ``Campaign`` owns the paper's TRAIN -> EXPLORE -> FINAL
loop and yields labeling requests instead of calling a labeler, so the
service can step many campaigns cooperatively and resume killed ones.

Built-ins: ``nsga2`` (seed-identical to the legacy loop), ``random``,
and ``bo`` (ParEGO expected-improvement Bayesian optimization).  Add
your own with ``register_strategy`` — see examples/STRATEGIES.md.
"""

from .base import (
    STRATEGIES,
    SearchStrategy,
    available_strategies,
    make_strategy,
    register_strategy,
)
from .bo import BOStrategy
from .campaign import Campaign, LabelRequest, drive
from .nsga2 import NSGA2Strategy
from .random import RandomStrategy

__all__ = [
    "SearchStrategy",
    "STRATEGIES",
    "register_strategy",
    "make_strategy",
    "available_strategies",
    "NSGA2Strategy",
    "RandomStrategy",
    "BOStrategy",
    "Campaign",
    "LabelRequest",
    "drive",
]


def _nsga2_factory(gene_sizes, cfg, *, init=None):
    return NSGA2Strategy(gene_sizes, cfg.nsga, init=init)


def _random_factory(gene_sizes, cfg, *, init=None):
    # same evaluation budget as NSGA-II: init population + one batch per
    # generation (init, if given, is ignored — random search is the
    # uniform baseline by definition)
    n = cfg.nsga.pop_size * (cfg.nsga.n_generations + 1)
    return RandomStrategy(
        gene_sizes,
        n_total=n,
        batch_size=cfg.nsga.pop_size,
        n_parents=cfg.nsga.n_parents,
        seed=cfg.nsga.seed,
    )


def _bo_factory(gene_sizes, cfg, *, init=None):
    return BOStrategy(
        gene_sizes,
        n_rounds=cfg.nsga.n_generations,
        batch_size=cfg.nsga.pop_size,
        n_parents=cfg.nsga.n_parents,
        seed=cfg.nsga.seed,
        init=init,
    )


register_strategy("nsga2", _nsga2_factory)
register_strategy("random", _random_factory)
register_strategy("bo", _bo_factory)
