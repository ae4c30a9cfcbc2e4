"""FrontCatalog: a composed Pareto front materialized as operating tiers.

A catalog is an immutable snapshot of one accelerator's front — the
(genome, labels) pairs a campaign (or the service's merged global front)
found non-dominated — ordered canonically and annotated with named
*operating tiers*:

  * ``exact``    — the highest-QoR point (ties: cheapest, then genome),
  * ``budget``   — the cheapest point on the primary cost objective
                   (ties: best QoR, then genome),
  * ``balanced`` — the knee: the point closest (L2) to the ideal corner
                   after min-max normalizing every objective over the
                   front (ties: canonical order).

``select`` is the SLA knob: a named tier, or a per-request budget
(``{"energy": <= x, "latency": <= y, "qor": >= z}``) resolved to the
best feasible point — or, when NO point is feasible, degraded
deterministically to the nearest-feasible point (minimum total relative
violation).  Every code path tie-breaks deterministically (objective
values, then genome bytes), so two replicas holding the same front
always pick the same genome for the same request.

Catalogs are cheap value objects: the serving engine hot-swaps them
atomically between batches and keeps recent versions around so requests
pinned to an old version stay byte-identical.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "DEFAULT_TIERS",
    "EmptyFrontError",
    "FrontCatalog",
    "NoFrontError",
    "OperatingPoint",
    "Selection",
]

# objectives where bigger is better (everything else is a cost);
# mirrors the sign convention of core.dse (qor auto-negated there)
HIGHER_BETTER = frozenset({"qor"})

DEFAULT_TIERS = ("exact", "balanced", "budget")


class EmptyFrontError(ValueError):
    """select() on a catalog with no operating points."""


class NoFrontError(LookupError):
    """No completed campaign has produced a front for this accelerator."""


@dataclass(frozen=True)
class OperatingPoint:
    """One front point: a genome and its ground-truth labels."""

    genome: Tuple[int, ...]
    labels: Dict[str, float]

    def genome_array(self) -> np.ndarray:
        return np.array(self.genome, dtype=np.int64)


@dataclass(frozen=True)
class Selection:
    """What the SLA knob resolved to."""

    tier: Optional[str]          # named tier, or None for a budget pick
    index: int                   # canonical index into catalog.points
    point: OperatingPoint
    feasible: bool = True        # False: nearest-feasible degrade


def _obj_key(labels: Dict[str, float], objectives: Sequence[str]) -> Tuple:
    """Minimization-convention sort key over the objective columns."""
    return tuple(
        -labels[o] if o in HIGHER_BETTER else labels[o] for o in objectives
    )


class FrontCatalog:
    """An ordered front snapshot + named tiers + the SLA selector."""

    def __init__(
        self,
        accel: str,
        points: Sequence[OperatingPoint],
        objectives: Sequence[str] = ("qor", "energy"),
        *,
        version: int = 1,
        source: str = "",
        rank_genes: bool = False,
    ):
        self.accel = str(accel)
        self.objectives = tuple(objectives)
        self.version = int(version)
        self.source = str(source)
        self.rank_genes = bool(rank_genes)
        for p in points:
            missing = [o for o in self.objectives if o not in p.labels]
            if missing:
                raise ValueError(
                    f"operating point {p.genome} lacks objective(s) {missing}"
                )
        # canonical order: best QoR first, then cheaper, then genome
        # bytes — every downstream tie-break reduces to "first in order"
        self.points: List[OperatingPoint] = sorted(
            points,
            key=lambda p: (_obj_key(p.labels, self.objectives), p.genome),
        )
        self.tiers: Dict[str, int] = self._build_tiers()

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_front(
        cls,
        accel: str,
        genomes,
        front,
        objectives: Sequence[str] = ("qor", "energy"),
        **kw,
    ) -> "FrontCatalog":
        """Build from minimization-convention front columns — the shape
        ``core.dse`` emits (qor stored NEGATED, ``-v if nm == "qor"``)
        and every ``/front`` payload carries.  Labels on the resulting
        operating points are RAW (qor = PSNR dB, higher better)."""
        genomes = np.atleast_2d(np.asarray(genomes, dtype=np.int64))
        front = np.atleast_2d(np.asarray(front, dtype=np.float64))
        objectives = tuple(objectives)
        if genomes.size == 0 and front.size == 0:
            return cls(accel, [], objectives, **kw)
        if len(front) and front.shape[1] != len(objectives):
            raise ValueError(
                f"front has {front.shape[1]} columns for "
                f"{len(objectives)} objectives {objectives}"
            )
        pts = [
            OperatingPoint(
                tuple(int(v) for v in g),
                {
                    o: float(-row[j] if o in HIGHER_BETTER else row[j])
                    for j, o in enumerate(objectives)
                },
            )
            for g, row in zip(genomes, front)
        ]
        return cls(accel, pts, objectives, **kw)

    @classmethod
    def from_json(cls, d: Dict, **kw) -> "FrontCatalog":
        """The ``GET /front`` / ``GET /campaigns/<id>/front`` payload
        shape (also what ``to_json`` emits)."""
        kw.setdefault("version", int(d.get("version", 1)))
        kw.setdefault("rank_genes", bool(d.get("rank_genes", False)))
        kw.setdefault("source", str(d.get("source", "json")))
        return cls.from_front(
            d["accel"], d.get("genomes", []), d.get("front", []),
            tuple(d.get("objectives", ("qor", "energy"))), **kw,
        )

    @classmethod
    def from_file(cls, path: str, **kw) -> "FrontCatalog":
        with open(path) as f:
            d = json.load(f)
        kw.setdefault("source", path)
        return cls.from_json(d, **kw)

    @classmethod
    def from_manager(
        cls,
        manager,
        accel: str,
        objectives: Optional[Sequence[str]] = None,
        **kw,
    ) -> "FrontCatalog":
        """Snapshot the service's merged global front for ``accel``
        (every completed campaign's non-dominated union)."""
        objectives = tuple(objectives or ("qor", "energy"))
        d = manager.global_front(accel, objectives)
        kw.setdefault("source", "manager")
        return cls.from_front(accel, d["genomes"], d["front"], objectives,
                              **kw)

    def to_json(self) -> Dict:
        # "front" rows round-trip in the minimization convention that
        # from_front consumes (qor re-negated); "tiers" carry raw labels
        return {
            "accel": self.accel,
            "objectives": list(self.objectives),
            "genomes": [list(p.genome) for p in self.points],
            "front": [
                [
                    -p.labels[o] if o in HIGHER_BETTER else p.labels[o]
                    for o in self.objectives
                ]
                for p in self.points
            ],
            "version": self.version,
            "rank_genes": self.rank_genes,
            "source": self.source,
            "digest": self.digest,
            "tiers": {
                name: {
                    "index": i,
                    "genome": list(self.points[i].genome),
                    "labels": dict(self.points[i].labels),
                }
                for name, i in self.tiers.items()
            },
        }

    # ------------------------------------------------------------------
    @property
    def empty(self) -> bool:
        return not self.points

    def __len__(self) -> int:
        return len(self.points)

    @property
    def digest(self) -> str:
        """Content hash of the front (NOT the version): hot-swap
        triggers only when the actual front changed."""
        h = hashlib.sha256()
        h.update(json.dumps(
            {
                "accel": self.accel,
                "objectives": self.objectives,
                "rank_genes": self.rank_genes,
                "points": [
                    (p.genome, [p.labels[o] for o in self.objectives])
                    for p in self.points
                ],
            },
            sort_keys=True,
        ).encode())
        return h.hexdigest()[:16]

    # ------------------------------------------------------------------
    # tiers
    # ------------------------------------------------------------------
    def _primary_cost(self) -> Optional[str]:
        for o in self.objectives:
            if o not in HIGHER_BETTER:
                return o
        return None

    def _build_tiers(self) -> Dict[str, int]:
        if not self.points:
            return {}
        n = len(self.points)
        cost = self._primary_cost()
        # exact: canonical order already leads with best QoR
        exact = 0
        if cost is None:
            budget = n - 1
        else:
            budget = min(
                range(n),
                key=lambda i: (
                    self.points[i].labels[cost],
                    _obj_key(self.points[i].labels, self.objectives),
                    self.points[i].genome,
                ),
            )
        balanced = self._knee()
        return {"exact": exact, "balanced": balanced, "budget": budget}

    def _knee(self) -> int:
        """Min-max normalize each objective over the front (as a loss:
        0 = best seen, 1 = worst seen) and pick the point closest to the
        all-best corner; ties break to canonical order."""
        vals = np.array(
            [[p.labels[o] for o in self.objectives] for p in self.points],
            dtype=np.float64,
        )
        for j, o in enumerate(self.objectives):
            if o in HIGHER_BETTER:
                vals[:, j] = -vals[:, j]
        lo, hi = vals.min(axis=0), vals.max(axis=0)
        span = np.where(hi > lo, hi - lo, 1.0)
        norm = (vals - lo) / span
        dist = np.sqrt((norm ** 2).sum(axis=1))
        return int(np.argmin(dist))  # argmin: first index on ties

    # ------------------------------------------------------------------
    # the SLA knob
    # ------------------------------------------------------------------
    def select(
        self,
        tier: Optional[str] = None,
        budget: Optional[Dict[str, float]] = None,
    ) -> Selection:
        """Resolve a request's SLA to one operating point.

        Exactly one of ``tier``/``budget`` (neither defaults to the
        ``balanced`` tier).  A budget maps objective names to bounds:
        an upper bound for cost objectives, a LOWER bound for
        higher-is-better objectives (``qor``).  When no point satisfies
        every bound the selection degrades to the point with the
        smallest total relative violation (``feasible=False``)."""
        if self.empty:
            raise EmptyFrontError(
                f"catalog for {self.accel!r} holds no operating points"
            )
        if tier is not None and budget is not None:
            raise ValueError("pass either tier or budget, not both")
        if budget is None:
            name = tier if tier is not None else "balanced"
            if name not in self.tiers:
                raise ValueError(
                    f"unknown tier {name!r}; known: {sorted(self.tiers)}"
                )
            i = self.tiers[name]
            return Selection(name, i, self.points[i])
        unknown = sorted(set(budget) - set(self.objectives))
        if unknown:
            raise ValueError(
                f"unknown budget objective(s) {unknown}; "
                f"known: {list(self.objectives)}"
            )
        if not budget:
            raise ValueError("budget cannot be empty")
        bounds = {k: float(v) for k, v in budget.items()}

        def violation(p: OperatingPoint) -> float:
            total = 0.0
            for o, b in bounds.items():
                v = p.labels[o]
                over = (b - v) if o in HIGHER_BETTER else (v - b)
                if over > 0.0:
                    total += over / max(abs(b), 1e-12)
            return total

        feasible = [
            i for i, p in enumerate(self.points) if violation(p) == 0.0
        ]
        if feasible:
            # canonical order leads with best QoR, so the first feasible
            # index IS the deterministic best pick
            i = feasible[0]
            return Selection(None, i, self.points[i])
        # nearest-feasible degrade: minimal total relative violation,
        # ties to canonical order (best QoR, cheapest, genome bytes)
        i = min(range(len(self.points)),
                key=lambda j: (violation(self.points[j]), j))
        return Selection(None, i, self.points[i], feasible=False)
