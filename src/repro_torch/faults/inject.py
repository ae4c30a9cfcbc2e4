"""The injection runtime: zero-cost when idle, deterministic when armed.

Call sites name their hazard and ask::

    from repro_torch import faults
    ...
    faults.hit("sched.dispatch", batch=len(entries))   # may sleep/raise

With no plan installed, :func:`check`/:func:`hit` are a single global
load and a ``None`` test — the same no-op discipline as ``REPRO_OBS=0``
(hot paths pay nothing for the harness existing).  A plan arms via
:func:`install` or the ``REPRO_FAULTS`` environment variable (a path to
a plan JSON, or inline JSON starting with ``{``), which worker
subprocesses inherit so one plan can storm a whole fleet.

Every firing increments ``repro_faults_injected_total``, records a
``faults.injected`` span, and is tallied per point in :func:`stats` —
drills assert on those tallies instead of hoping the storm happened.
"""

from __future__ import annotations

import os
import random
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .. import obs
from .plan import FaultPlan, FaultRule

__all__ = [
    "Fault", "FaultInjected", "active", "check", "hit", "install",
    "installed", "reset", "stats", "uninstall",
]


class FaultInjected(RuntimeError):
    """Raised by ``error``-kind rules.  Carries the point and optional
    HTTP ``status`` so transport layers can style it (fleet/http turns
    a status-carrying injection into a retryable HTTPError)."""

    def __init__(self, point: str, kind: str = "error",
                 status: Optional[int] = None, message: str = ""):
        self.point = point
        self.kind = kind
        self.status = status
        super().__init__(
            message or f"injected fault at {point}"
            + (f" (http {status})" if status else ""))


@dataclass
class Fault:
    """Directive handed to a call site when a rule fires."""

    point: str
    kind: str
    rule: FaultRule
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def delay_s(self) -> float:
        return self.rule.delay_s

    @property
    def status(self) -> Optional[int]:
        return self.rule.status

    @property
    def fraction(self) -> float:
        return self.rule.fraction

    def raise_(self) -> None:
        raise FaultInjected(self.point, self.kind, self.rule.status,
                            self.rule.message)


# ---------------------------------------------------------------------
# module state — reads are a single global load; mutation is locked
_LOG = obs.get_logger("faults")
_PLAN: Optional[FaultPlan] = None
_LOCK = threading.Lock()
_HITS: Dict[int, int] = {}       # rule idx -> eligible hits seen
_FIRED: Dict[int, int] = {}      # rule idx -> times fired
_BY_POINT: Dict[str, int] = {}   # point -> injections
_COUNTER: Optional[obs.Counter] = None
_GAUGE: Optional[obs.Gauge] = None


def _decide(seed: int, idx: int, point: str, n: int, p: float) -> bool:
    """Deterministic per-hit coin: pure function of the identifiers (crc
    seeding, not hash(), so worker processes agree with the parent)."""
    if p >= 1.0:
        return True
    if p <= 0.0:
        return False
    key = zlib.crc32(f"{seed}:{idx}:{point}:{n}".encode())
    return random.Random(key).random() < p


def installed() -> Optional[FaultPlan]:
    return _PLAN


def active() -> bool:
    return _PLAN is not None


def install(plan: FaultPlan) -> FaultPlan:
    """Arm a plan (replacing any previous one; schedules restart)."""
    global _PLAN, _COUNTER, _GAUGE
    with _LOCK:
        _HITS.clear()
        _FIRED.clear()
        _BY_POINT.clear()
        _COUNTER = obs.REGISTRY.counter(
            "repro_faults_injected_total",
            "faults injected by the chaos harness")
        _GAUGE = obs.REGISTRY.gauge(
            "repro_faults_active", "1 while a fault plan is installed")
        _GAUGE.set(1.0)
        _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    with _LOCK:
        _PLAN = None
        if _GAUGE is not None:
            _GAUGE.set(0.0)


def reset() -> None:
    """Disarm and zero tallies (test isolation)."""
    uninstall()
    with _LOCK:
        _HITS.clear()
        _FIRED.clear()
        _BY_POINT.clear()


def stats() -> Dict[str, Any]:
    with _LOCK:
        plan = _PLAN
        return {
            "active": plan is not None,
            "plan": plan.name if plan else None,
            "seed": plan.seed if plan else None,
            "injected": sum(_BY_POINT.values()),
            "by_point": dict(sorted(_BY_POINT.items())),
        }


def check(point: str, **attrs: Any) -> Optional[Fault]:
    """Return a :class:`Fault` directive if a rule fires at ``point``,
    else ``None``.  The disabled path is one global load."""
    plan = _PLAN
    if plan is None:
        return None
    return _check_armed(plan, point, attrs)


def _check_armed(plan: FaultPlan, point: str,
                 attrs: Dict[str, Any]) -> Optional[Fault]:
    fired: Optional[FaultRule] = None
    counter: Optional[obs.Counter] = None
    with _LOCK:
        if _PLAN is not plan:        # racing uninstall
            return None
        for idx, rule in enumerate(plan.rules):
            if not rule.matches(point):
                continue
            n = _HITS.get(idx, 0)
            _HITS[idx] = n + 1
            if n < rule.after:
                continue
            if rule.times is not None and _FIRED.get(idx, 0) >= rule.times:
                continue
            if not _decide(plan.seed, idx, point, n, rule.p):
                continue
            _FIRED[idx] = _FIRED.get(idx, 0) + 1
            _BY_POINT[point] = _BY_POINT.get(point, 0) + 1
            fired, counter = rule, _COUNTER
            break                    # first matching rule wins
    if fired is None:
        return None
    if counter is not None:
        counter.inc()
    sp = obs.start_span("faults.injected", point=point, kind=fired.kind,
                        rule=fired.point)
    sp.end()
    _LOG.info("injected %s at %s", fired.kind, point)
    return Fault(point=point, kind=fired.kind, rule=fired, attrs=attrs)


def hit(point: str, **attrs: Any) -> Optional[Fault]:
    """Check-and-apply: sleeps out latency, raises ``error`` kinds,
    honors ``exit`` kinds (process dies, like a kill between two
    non-atomic steps).  Site-specific kinds (``torn_write``, ``drop``,
    ``duplicate``) are returned for the caller to enact; plain latency
    returns ``None`` after the stall so callers can ignore it."""
    plan = _PLAN
    if plan is None:
        return None
    f = _check_armed(plan, point, attrs)
    if f is None:
        return None
    if f.delay_s > 0:
        time.sleep(f.delay_s)
    if f.kind == "latency":
        return None
    if f.kind == "error":
        f.raise_()
    if f.kind == "exit":
        os._exit(17)
    return f


def _arm_from_env() -> None:
    spec = os.environ.get("REPRO_FAULTS", "").strip()
    if not spec or spec == "0":
        return
    try:
        if spec.startswith("{"):
            plan = FaultPlan.from_json(spec)
        else:
            plan = FaultPlan.from_file(spec)
    except (OSError, ValueError) as e:  # a broken plan must not take
        _LOG.warning(                       # down the real service
            "ignoring REPRO_FAULTS=%r: %s", spec, e)
        return
    install(plan)


_arm_from_env()
