"""repro_torch.serving — the Pareto front as a product.

The search tier (repro_torch.service) finds fronts; this package
*serves* them.  A ``FrontCatalog`` materializes a campaign's composed
front as named operating tiers (``exact`` / ``balanced`` / ``budget``)
plus an SLA selector that maps a per-request latency/energy/QoR budget
to a genome (deterministic tie-breaking, nearest-feasible degrade on
infeasible budgets).  A ``ServingEngine`` runs a continuous-batching
request loop over one accelerator on one device: admission queue ->
per-operating-point batch groups -> the population engine's kernels /
LM prefill and decode -> completion, with atomic catalog hot-swap
between batches ("search while serving": the engine subscribes to a
live ``CampaignManager`` and picks up improved fronts; requests pinned
to an old catalog version keep byte-identical results).
``ServingHub`` keys engines by accelerator behind ``POST /serve`` /
``GET /serving/stats`` on the service HTTP API.  ``launch/serve.py
--front`` reads a stored catalog.
"""

from .backends import LMBackend, SimBackend, make_backend
from .catalog import (
    DEFAULT_TIERS,
    EmptyFrontError,
    FrontCatalog,
    NoFrontError,
    OperatingPoint,
    Selection,
)
from .engine import ServeRequest, ServingEngine
from .hub import ServingHub

__all__ = [
    "DEFAULT_TIERS",
    "EmptyFrontError",
    "FrontCatalog",
    "LMBackend",
    "NoFrontError",
    "OperatingPoint",
    "Selection",
    "ServeRequest",
    "ServingEngine",
    "ServingHub",
    "SimBackend",
    "make_backend",
]
