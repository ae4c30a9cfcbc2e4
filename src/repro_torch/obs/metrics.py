"""Lock-cheap counters/gauges/histograms with Prometheus-text scrape.

The scheduler/labeler/fleet hot paths increment counters from worker
threads on every request; a mutex per increment would serialize exactly
the paths the service exists to parallelize.  ``Counter`` and
``Histogram`` therefore shard per thread: each thread owns a private
accumulator (single writer, no lock on the hot path — list-item float
adds are atomic enough under the GIL because only the owning thread
writes them) and scrapes sum the shards under the registration lock.
``Gauge`` is a plain locked cell (set-dominated, never hot).

A ``Registry`` maps flat metric names to instruments and renders the
whole family as Prometheus exposition text for ``GET /metrics``.
Registration is idempotent-replace: components create their instruments
per instance (so per-instance ``stats()`` keep working and tests can
build many schedulers), and the most recently constructed instance is
the one a scrape observes — which is the live service object.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "render_prometheus",
]

# label→batch→synth latencies span ~100µs (store hit) to minutes (cold
# compile wave): exponential-ish seconds buckets covering that range
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0, 300.0,
)


class Counter:
    """Monotonic counter, per-thread sharded."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._shards: Dict[int, List[float]] = {}

    def inc(self, n: float = 1.0) -> None:
        tid = threading.get_ident()
        shard = self._shards.get(tid)
        if shard is None:
            with self._lock:
                shard = self._shards.setdefault(tid, [0.0])
        shard[0] += n

    @property
    def value(self) -> float:
        with self._lock:
            shards = list(self._shards.values())
        return sum(s[0] for s in shards)

    def samples(self) -> List[Tuple[str, float]]:
        return [(self.name, self.value)]


class Gauge:
    """Last-write-wins value (queue depths, fleet size, inflight)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> List[Tuple[str, float]]:
        return [(self.name, self.value)]


class Histogram:
    """Cumulative-bucket histogram, per-thread sharded like Counter.
    ``observe`` takes seconds (or any unit consistent per metric)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._lock = threading.Lock()
        # shard layout: [count per bucket..., overflow, sum, n]
        self._shards: Dict[int, List[float]] = {}
        self._width = len(self.buckets) + 3

    def observe(self, v: float) -> None:
        tid = threading.get_ident()
        shard = self._shards.get(tid)
        if shard is None:
            with self._lock:
                shard = self._shards.setdefault(tid, [0.0] * self._width)
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        shard[i] += 1.0
        shard[-2] += v
        shard[-1] += 1.0

    def _agg(self) -> List[float]:
        with self._lock:
            shards = [list(s) for s in self._shards.values()]
        agg = [0.0] * self._width
        for s in shards:
            for i, v in enumerate(s):
                agg[i] += v
        return agg

    @property
    def count(self) -> float:
        return self._agg()[-1]

    @property
    def sum(self) -> float:
        return self._agg()[-2]

    @property
    def value(self) -> float:  # uniform scrape surface: the mean
        agg = self._agg()
        return (agg[-2] / agg[-1]) if agg[-1] else 0.0

    def samples(self) -> List[Tuple[str, float]]:
        agg = self._agg()
        out: List[Tuple[str, float]] = []
        cum = 0.0
        for b, c in zip(self.buckets, agg):
            cum += c
            out.append((f'{self.name}_bucket{{le="{b:g}"}}', cum))
        cum += agg[len(self.buckets)]
        out.append((f'{self.name}_bucket{{le="+Inf"}}', cum))
        out.append((f"{self.name}_sum", agg[-2]))
        out.append((f"{self.name}_count", agg[-1]))
        return out


class Registry:
    """Flat name → instrument map with idempotent-replace creation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge(name, help))

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help, buckets))

    def _register(self, inst):
        with self._lock:
            self._instruments[inst.name] = inst
        return inst

    def get(self, name: str) -> Optional[object]:
        with self._lock:
            return self._instruments.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> Dict[str, float]:
        """name → scalar view (histograms report their mean) — the raw
        material /stats-style JSON views read."""
        with self._lock:
            insts = list(self._instruments.values())
        return {i.name: i.value for i in insts}

    def collect(self, prefix: str) -> Dict[str, float]:
        """Scalar snapshot of every instrument whose name starts with
        ``prefix`` — how the chaos drill and ``/health`` gather one
        subsystem's counters (e.g. ``repro_faults_``, ``repro_http_``)
        without enumerating names at the call site."""
        with self._lock:
            insts = [i for i in self._instruments.values()
                     if i.name.startswith(prefix)]
        return {i.name: i.value for i in insts}

    def render(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        with self._lock:
            insts = sorted(self._instruments.values(),
                           key=lambda i: i.name)
        lines: List[str] = []
        for inst in insts:
            if inst.help:
                h = inst.help.replace("\\", "\\\\").replace("\n", "\\n")
                lines.append(f"# HELP {inst.name} {h}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
            for name, v in inst.samples():
                lines.append(f"{name} {v:g}")
        return "\n".join(lines) + "\n"


REGISTRY = Registry()


def render_prometheus(registry: Optional[Registry] = None) -> str:
    return (registry or REGISTRY).render()
