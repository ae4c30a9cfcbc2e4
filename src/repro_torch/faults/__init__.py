"""repro_torch.faults — deterministic, seeded fault injection.

The chaos harness for the DSE service, fleet, store and serving tiers:

  * :class:`FaultPlan` / :class:`FaultRule` — named injection points
    with per-point probability / latency / error schedules, decided by
    a pure function of ``(seed, rule, point, hit index)`` so storms
    replay bit-identically.
  * ``REPRO_FAULTS=plan.json`` env (inherited by worker subprocesses)
    or programmatic :func:`install` / :func:`uninstall`.
  * Zero overhead when disarmed — :func:`check`/:func:`hit` are a
    single global load, the same no-op discipline as ``REPRO_OBS=0``.
  * Every firing: ``repro_faults_injected_total`` + a
    ``faults.injected`` span + per-point tallies in :func:`stats`.

See ``examples/RESILIENCE.md`` and ``benchmarks/chaos_drill.py``.  The
port's own copy of the JAX package's ``faults``: the same
``REPRO_FAULTS`` plans, point names and per-hit decisions.
"""

from .inject import (
    Fault, FaultInjected, active, check, hit, install, installed, reset,
    stats, uninstall,
)
from .plan import KINDS, POINTS, FaultPlan, FaultRule

__all__ = [
    "Fault", "FaultInjected", "FaultPlan", "FaultRule", "KINDS",
    "POINTS", "active", "check", "hit", "install", "installed", "reset",
    "stats", "uninstall",
]
