"""Context-propagated span tracing for the DSE service and fleet.

One campaign's labels flow through the campaign worker thread, the
scheduler's batcher, a thread/process/fleet backend, and (for the
fleet) a worker on another HOST — so "where did the last 10 minutes
go?" needs spans whose correlation ids survive every one of those
boundaries.  This module is the zero-dependency flight recorder core:

  * ``span(name, **attrs)`` — a context manager that times a region and
    emits one record; nesting links child to parent via a contextvar.
  * ``context(campaign=..., batch=...)`` — pushes correlation *baggage*
    (campaign/batch/lease/worker ids) that every span started inside it
    carries in its attrs.
  * ``wire_context()`` / ``attach(wire)`` — a plain-dict codec so the
    current trace context can ride existing wire payloads (fleet lease
    responses, process-pool call args) and be re-attached on the far
    side; ``Recorder.ingest`` folds the far side's finished spans back
    into the local ring (workers piggyback them on result payloads,
    exactly like the synth-stat counters already do).

Records land in a bounded in-memory ring plus an optional JSONL sink
(``--trace`` on the service CLI); ``python -m repro_torch.obs.export
--chrome-trace`` turns the sink file into a Perfetto-loadable trace.

Tracing is on by default and costs two clock reads plus a deque append
per span; ``REPRO_OBS=0`` (or ``set_enabled(False)``) turns every
``span``/``context`` into a no-op for overhead benchmarking.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional

__all__ = [
    "Recorder", "Span", "attach", "context", "current_baggage",
    "enabled", "recorder", "set_enabled", "set_sink", "span",
    "start_span", "wire_context",
]

_BAGGAGE_KEYS = ("campaign", "batch", "lease", "worker", "stage")

_enabled = os.environ.get("REPRO_OBS", "1").lower() not in (
    "0", "false", "off", "no",
)


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Flip tracing globally (the overhead benchmark's obs-off arm)."""
    global _enabled
    _enabled = bool(on)


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class _Ctx:
    """Immutable trace context: a trace id, the current span id (parent
    of any span started under it) and the correlation baggage."""

    __slots__ = ("trace_id", "span_id", "baggage")

    def __init__(self, trace_id: str, span_id: Optional[str],
                 baggage: Dict[str, str]):
        self.trace_id = trace_id
        self.span_id = span_id
        self.baggage = baggage


_current: contextvars.ContextVar[Optional[_Ctx]] = contextvars.ContextVar(
    "repro_obs_ctx", default=None
)


class Recorder:
    """Bounded ring of finished span records + optional JSONL sink."""

    def __init__(self, ring: int = 4096, sink: Optional[str] = None):
        self._ring: deque = deque(maxlen=int(ring))
        self._lock = threading.Lock()
        self._sink_path: Optional[str] = None
        self._sink_file = None
        self.n_spans = 0
        self.n_ingested = 0
        self.n_dropped = 0  # sink write failures, not ring evictions
        if sink:
            self.set_sink(sink)

    def set_sink(self, path: Optional[str]) -> None:
        with self._lock:
            if self._sink_file is not None:
                try:
                    self._sink_file.close()
                except OSError:
                    pass
                self._sink_file = None
            self._sink_path = path
            if path:
                d = os.path.dirname(os.path.abspath(path))
                os.makedirs(d, exist_ok=True)
                self._sink_file = open(path, "a", encoding="utf-8")

    @property
    def sink_path(self) -> Optional[str]:
        return self._sink_path

    def emit(self, rec: Dict) -> None:
        with self._lock:
            self._ring.append(rec)
            self.n_spans += 1
            if self._sink_file is not None:
                try:
                    self._sink_file.write(
                        json.dumps(rec, separators=(",", ":")) + "\n"
                    )
                    self._sink_file.flush()
                except (OSError, ValueError):
                    self.n_dropped += 1

    def ingest(self, recs: Iterable[Dict]) -> None:
        """Fold spans recorded elsewhere (worker process / fleet host)
        into this recorder — they arrive finished, piggybacked on result
        payloads."""
        for rec in recs:
            if isinstance(rec, dict) and "name" in rec:
                self.emit(rec)
                with self._lock:
                    self.n_ingested += 1

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def stats(self) -> Dict:
        with self._lock:
            return {
                "spans": self.n_spans,
                "ingested": self.n_ingested,
                "ring": len(self._ring),
                "sink": self._sink_path,
                "sink_drops": self.n_dropped,
            }

    def close(self) -> None:
        self.set_sink(None)


_recorder = Recorder()


def recorder() -> Recorder:
    return _recorder


def set_sink(path: Optional[str]) -> None:
    _recorder.set_sink(path)


def current_baggage() -> Dict[str, str]:
    ctx = _current.get()
    return dict(ctx.baggage) if ctx is not None else {}


@contextmanager
def context(**baggage):
    """Push correlation baggage (and mint a trace id if none is live).
    ``trace_id=`` pins the trace id — campaigns pass their campaign id
    so every span of a campaign shares one trace."""
    if not _enabled:
        yield
        return
    trace_id = baggage.pop("trace_id", None)
    parent = _current.get()
    merged = dict(parent.baggage) if parent is not None else {}
    merged.update({k: str(v) for k, v in baggage.items() if v is not None})
    ctx = _Ctx(
        trace_id or (parent.trace_id if parent is not None else _new_id()),
        parent.span_id if parent is not None else None,
        merged,
    )
    token = _current.set(ctx)
    try:
        yield
    finally:
        _current.reset(token)


class Span:
    """A started span; ``end()`` emits it.  Returned by ``start_span``
    for lifecycles that cross threads (fleet leases: granted on the
    protocol thread, ended by a result post, heartbeat expiry, or the
    in-process reclaim)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "_t0", "_clk", "_rec", "_done")

    def __init__(self, name: str, ctx: Optional[_Ctx], attrs: Dict,
                 rec: Recorder):
        self.name = name
        self.trace_id = ctx.trace_id if ctx is not None else _new_id()
        self.span_id = _new_id()
        self.parent_id = ctx.span_id if ctx is not None else None
        self.attrs = dict(ctx.baggage) if ctx is not None else {}
        self.attrs.update(attrs)
        self._t0 = time.time()
        self._clk = time.perf_counter()
        self._rec = rec
        self._done = False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self, **attrs) -> None:
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        self._rec.emit({
            "name": self.name,
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "t0": round(self._t0, 6),
            "dur": round(time.perf_counter() - self._clk, 6),
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFFFFFF,
            "attrs": {k: v for k, v in self.attrs.items() if v is not None},
        })


class _NullSpan:
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def end(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


def start_span(name: str, **attrs) -> Span:
    """Start a span WITHOUT making it the ambient parent — for
    lifecycles whose end happens on another thread."""
    if not _enabled:
        return _NULL
    return Span(name, _current.get(), attrs, _recorder)


@contextmanager
def span(name: str, **attrs):
    """Time a region; nested spans parent to it via the contextvar."""
    if not _enabled:
        yield _NULL
        return
    s = Span(name, _current.get(), attrs, _recorder)
    token = _current.set(_Ctx(s.trace_id, s.span_id, dict(s.attrs)))
    try:
        yield s
    finally:
        _current.reset(token)
        s.end()


# ----------------------------------------------------------------------
# wire codec: trace context over existing payloads


def wire_context() -> Optional[Dict]:
    """The current context as a plain JSON-safe dict, or None.  Rides
    fleet lease responses and process-pool call args."""
    if not _enabled:
        return None
    ctx = _current.get()
    if ctx is None:
        return None
    out: Dict = {"trace": ctx.trace_id}
    if ctx.span_id:
        out["span"] = ctx.span_id
    bag = {k: v for k, v in ctx.baggage.items() if k in _BAGGAGE_KEYS}
    if bag:
        out["baggage"] = bag
    return out


@contextmanager
def attach(wire: Optional[Dict], **extra_baggage):
    """Adopt a remote trace context (the far side of ``wire_context``).
    A None/garbage wire still pushes ``extra_baggage`` so worker-local
    spans stay labeled."""
    if not _enabled:
        yield
        return
    wire = wire if isinstance(wire, dict) else {}
    bag = wire.get("baggage")
    merged = dict(bag) if isinstance(bag, dict) else {}
    merged.update(
        {k: str(v) for k, v in extra_baggage.items() if v is not None}
    )
    trace_id = wire.get("trace")
    ctx = _Ctx(
        str(trace_id) if trace_id else _new_id(),
        str(wire["span"]) if wire.get("span") else None,
        merged,
    )
    token = _current.set(ctx)
    try:
        yield
    finally:
        _current.reset(token)
