"""Seeded fault plans: what to break, where, and on which hit.

A :class:`FaultPlan` is a list of :class:`FaultRule`\\ s, each matched by
glob against a *named injection point* (``store.append``,
``http.request``, ``fleet.result``, ...).  Rules fire deterministically:
the decision for the *n*-th hit of a rule is a pure function of
``(plan.seed, rule index, point name, n)`` — no wall clock, no global
RNG — so a chaos drill replays bit-identically and a failure found once
can be reproduced forever by re-running the same plan.

Plans serialize to plain JSON so they travel to worker subprocesses via
``REPRO_FAULTS=plan.json`` (see :mod:`repro_torch.faults.inject`).
"""

from __future__ import annotations

import fnmatch
import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["FaultRule", "FaultPlan", "KINDS", "POINTS"]

# What a rule does when it fires.  ``error``/``latency`` are handled by
# the injection runtime itself; the site-specific kinds are returned to
# the call site as a directive (see inject.hit):
#   error      raise FaultInjected (optionally styled as HTTP ``status``)
#   latency    sleep ``delay_s`` then continue
#   torn_write the store writes ``fraction`` of a record, no newline
#   drop       the site discards the message/lease/result
#   duplicate  the site delivers the message twice
#   exit       os._exit — simulate a kill between two non-atomic steps
KINDS = ("error", "latency", "torn_write", "drop", "duplicate", "exit")

# The injection points threaded through the stack (documentation — a
# rule may glob-match any name, including ones added later).
POINTS = (
    "store.append",        # label/synth store: before records are written
    "store.seal",          # segment seal / compact: between rename+manifest
    "store.lock",          # flock acquisition (latency = lock contention)
    "http.request",        # fleet/http.request_json, per attempt
    "fleet.lease",         # orchestrator lease grant (drop = starve)
    "fleet.result",        # orchestrator result ingest (drop/duplicate)
    "fleet.heartbeat",     # worker heartbeat send (drop = go dark)
    "sched.dispatch",      # scheduler batch dispatch
    "synth.compile",       # structural synthesis compile (latency = slow)
    "serving.backend",     # serving engine backend.run
)


@dataclass
class FaultRule:
    """One thing to break.  ``point`` is an fnmatch glob over injection
    point names; ``after``/``times`` schedule the rule over the point's
    hit sequence (skip the first ``after`` hits, fire at most ``times``
    times); ``p`` is the per-hit probability once eligible."""

    point: str
    kind: str = "error"
    p: float = 1.0
    delay_s: float = 0.0          # latency kind, or pre-raise stall
    status: Optional[int] = None  # error kind: style as this HTTP status
    message: str = ""
    times: Optional[int] = None   # max firings (None = unlimited)
    after: int = 0                # skip the first N eligible hits
    fraction: float = 0.5         # torn_write: fraction of bytes written

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if not (0.0 <= float(self.p) <= 1.0):
            raise ValueError(f"p must be in [0,1], got {self.p}")
        if self.delay_s < 0:
            raise ValueError("delay_s must be >= 0")
        if not (0.0 <= float(self.fraction) < 1.0):
            raise ValueError("fraction must be in [0,1)")

    def matches(self, point: str) -> bool:
        return fnmatch.fnmatchcase(point, self.point)

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        # keep plans tidy: drop fields at their defaults
        for k, v in (("p", 1.0), ("delay_s", 0.0), ("status", None),
                     ("message", ""), ("times", None), ("after", 0),
                     ("fraction", 0.5)):
            if d[k] == v:
                del d[k]
        return d


@dataclass
class FaultPlan:
    """A named, seeded set of fault rules."""

    seed: int = 0
    rules: List[FaultRule] = field(default_factory=list)
    name: str = ""

    def add(self, point: str, kind: str = "error", **kw: Any) -> "FaultPlan":
        """Append a rule; returns self so plans chain fluently."""
        self.rules.append(FaultRule(point=point, kind=kind, **kw))
        return self

    # ---- serialization ------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": 1,
            "name": self.name,
            "seed": self.seed,
            "rules": [r.to_dict() for r in self.rules],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultPlan":
        rules = [FaultRule(**r) for r in d.get("rules", [])]
        return cls(seed=int(d.get("seed", 0)), rules=rules,
                   name=str(d.get("name", "")))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())
