"""repro_torch.serving — the Pareto front as a product.

A ``FrontCatalog`` materializes a campaign's front as named operating
tiers (``exact`` / ``balanced`` / ``budget``) plus an SLA selector that
maps a per-request latency/energy/QoR budget to a genome (deterministic
tie-breaking, nearest-feasible degrade on infeasible budgets).

The port carries the catalog (a copy of the JAX package's, numpy only),
which ``launch/serve.py --front`` reads.  The serving engine, its
backends and the hub are not ported yet (ROADMAP.md §1 item 4).
"""

from .catalog import (
    DEFAULT_TIERS,
    EmptyFrontError,
    FrontCatalog,
    NoFrontError,
    OperatingPoint,
    Selection,
)

__all__ = [
    "DEFAULT_TIERS",
    "EmptyFrontError",
    "FrontCatalog",
    "NoFrontError",
    "OperatingPoint",
    "Selection",
]
