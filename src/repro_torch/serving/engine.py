"""ServingEngine: a continuous-batching request loop over one catalog.

Requests enter an admission queue (``submit`` returns a future and
holds no thread); a dedicated batcher thread drains up to ``max_batch``
requests per cycle (waiting ``max_wait_s`` for stragglers so concurrent
callers coalesce), resolves each request's SLA against the CURRENT
catalog — or the catalog version the request is pinned to — groups the
batch by resolved operating point + input shape, and executes each
group in one batched backend call (the population engine's kernels, or
the LM's prefill/decode) on the engine's ``device`` (default
``"cuda"``).  Every result is a host value before its future resolves.

Hot-swap: ``install`` atomically replaces the catalog between batches
(the batcher snapshots it once per cycle under the same lock), keeps
the last ``keep_catalogs`` versions for pinned requests, and
``attach``/``refresh_from`` subscribe the engine to a live
``CampaignManager`` so a campaign that improves the merged front swaps
it in mid-run without dropping a request — search while serving.

The ``serving.request`` span starts in the submitter's trace context
(trace id flows through batch formation into the group execution
attrs); counters ride the sharded metrics registry and surface as
``repro_serving_*`` on ``GET /metrics`` and in ``GET /serving/stats``.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .. import faults, obs
from ..core.acl.library import default_library
from .backends import make_backend
from .catalog import EmptyFrontError, FrontCatalog, Selection

__all__ = ["DeadlineExceeded", "OverloadedError", "ServeRequest",
           "ServingEngine"]


class OverloadedError(RuntimeError):
    """Admission queue full — the request was rejected WITHOUT being
    enqueued.  Retriable: the caller should back off and resubmit (the
    HTTP layer maps this to 429)."""

    retriable = True


class DeadlineExceeded(TimeoutError):
    """The request's ``deadline_s`` elapsed before its group ran; it
    was dropped instead of burning backend time on an answer nobody is
    waiting for."""

_log = obs.get_logger("serving")

# instruments are process-wide (the registry is a flat name->instrument
# map with replace-on-register): create once, shared by every engine;
# per-engine breakdowns live in ServingEngine.stats()
_METRICS_LOCK = threading.Lock()
_METRICS: Dict[str, object] = {}


def _metrics() -> Dict[str, object]:
    with _METRICS_LOCK:
        if not _METRICS:
            R = obs.REGISTRY
            _METRICS.update(
                requests=R.counter(
                    "repro_serving_requests_total",
                    "serving requests admitted"),
                responses=R.counter(
                    "repro_serving_responses_total",
                    "serving requests completed"),
                errors=R.counter(
                    "repro_serving_errors_total",
                    "serving requests failed"),
                batches=R.counter(
                    "repro_serving_batches_total", "serving batch cycles"),
                groups=R.counter(
                    "repro_serving_groups_total",
                    "operating-point batch groups run"),
                swaps=R.counter(
                    "repro_serving_hot_swaps_total",
                    "catalog hot-swaps installed"),
                degrades=R.counter(
                    "repro_serving_degrades_total",
                    "infeasible budgets degraded to nearest-feasible"),
                rejects=R.counter(
                    "repro_serving_rejects_total",
                    "requests rejected at admission (queue full)"),
                expired=R.counter(
                    "repro_serving_deadline_expired_total",
                    "requests dropped after their deadline elapsed"),
                depth=R.gauge(
                    "repro_serving_queue_depth", "admission queue depth"),
                latency=R.histogram(
                    "repro_serving_request_seconds",
                    "request latency (seconds)"),
            )
        return _METRICS


def _tier_counter(tier: str) -> "obs.Counter":
    name = f"repro_serving_selected_{tier}_total"
    with _METRICS_LOCK:
        ctr = obs.REGISTRY.get(name)
        if ctr is None:
            ctr = obs.REGISTRY.counter(
                name, f"requests served at the {tier} tier")
    return ctr


@dataclass
class ServeRequest:
    """One admitted request (internal; callers hold the future)."""

    id: str
    inputs: np.ndarray
    tier: Optional[str] = None
    budget: Optional[Dict[str, float]] = None
    pin_version: Optional[int] = None
    gen: Optional[int] = None            # LM: tokens to decode
    return_outputs: bool = False
    deadline: Optional[float] = None     # absolute perf_counter time
    future: Future = field(default_factory=Future)
    span: object = None                  # serving.request (submitter ctx)
    t_submit: float = field(default_factory=time.perf_counter)


class ServingEngine:
    """Continuous-batching inference over one accelerator's front."""

    def __init__(
        self,
        accel,
        library=None,
        *,
        catalog: Optional[FrontCatalog] = None,
        rank_genes: bool = False,
        max_batch: int = 16,
        max_wait_s: float = 0.005,
        keep_catalogs: int = 8,
        default_tier: str = "balanced",
        max_queue: int = 256,
        device=None,
    ):
        from ..device import resolve_device

        self.device = resolve_device(device)
        if isinstance(accel, str):
            from ..service.campaigns import make_accelerator

            accel = make_accelerator(accel, device=self.device)
        self.accel = accel
        self.library = library if library is not None else default_library()
        self.rank_genes = bool(rank_genes)
        self.backend = make_backend(self.accel, self.library,
                                    rank_genes=self.rank_genes,
                                    device=self.device)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.keep_catalogs = max(1, int(keep_catalogs))
        self.default_tier = str(default_tier)
        self.max_queue = max(1, int(max_queue))

        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._catalog: Optional[FrontCatalog] = None
        self._catalogs: "OrderedDict[int, FrontCatalog]" = OrderedDict()
        self._version = itertools.count(1)
        self._closed = False
        self._manager = None

        name = self.accel.name
        self._m = _metrics()
        # engine-local breakdowns (instruments are process-wide)
        self._n: Dict[str, int] = dict(
            requests=0, responses=0, errors=0, batches=0, groups=0,
            hot_swaps=0, degrades=0, rejects=0, expired=0,
        )
        self._tier_counts: Dict[str, int] = {}
        self._served_by_version: Dict[int, int] = {}
        _log.info("serving engine up for %s (backend=%s)",
                  name, self.backend.kind)

        if catalog is not None:
            self.install(catalog)
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"serving-{name}",
        )
        self._thread.start()

    # ------------------------------------------------------------------
    # catalog lifecycle (hot-swap)
    # ------------------------------------------------------------------
    def install(self, catalog: FrontCatalog) -> Optional[int]:
        """Atomically make ``catalog`` the serving front.  Between
        batches by construction: the batcher snapshots the catalog
        under the same lock once per cycle.  Returns the installed
        version, or None when the front content is unchanged."""
        with self._cond:
            prev = self._catalog
            if prev is not None and prev.digest == catalog.digest:
                return None
            version = next(self._version)
            catalog.version = version
            self._catalog = catalog
            self._catalogs[version] = catalog
            while len(self._catalogs) > self.keep_catalogs:
                self._catalogs.popitem(last=False)
        if prev is not None:
            self._m["swaps"].inc()
            with self._cond:
                self._n["hot_swaps"] += 1
            _log.info("hot-swap: %s front v%d -> v%d (%d -> %d points)",
                      catalog.accel, prev.version, version,
                      len(prev), len(catalog))
        return version

    def refresh_from(self, manager, objectives=None) -> Optional[int]:
        """Rebuild the catalog from the manager's merged global front;
        install it only when the front actually changed."""
        cat = FrontCatalog.from_manager(
            manager, self.accel.name, objectives or self._objectives(),
            rank_genes=self.rank_genes,
        )
        if cat.empty:
            return None
        return self.install(cat)

    def attach(self, manager) -> None:
        """Subscribe to a live CampaignManager: every campaign that
        completes for this accelerator re-derives the catalog (the
        search-while-serving loop)."""
        self._manager = manager
        manager.subscribe_front(self._on_front_update)

    def _on_front_update(self, accel_name: str) -> None:
        if accel_name != self.accel.name or self._manager is None:
            return
        try:
            self.refresh_from(self._manager)
        except Exception:  # noqa: BLE001 - a bad refresh must not kill the campaign tick
            _log.exception("front refresh failed for %s", accel_name)

    def _objectives(self):
        with self._cond:
            cat = self._catalog
        return cat.objectives if cat is not None else ("qor", "energy")

    @property
    def catalog(self) -> Optional[FrontCatalog]:
        with self._cond:
            return self._catalog

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(
        self,
        inputs,
        *,
        tier: Optional[str] = None,
        budget: Optional[Dict[str, float]] = None,
        pin_version: Optional[int] = None,
        gen: Optional[int] = None,
        return_outputs: bool = False,
        deadline_s: Optional[float] = None,
    ) -> Future:
        """Admit one request; returns a Future resolving to the result
        record.  SLA errors (unknown tier, bad budget, unknown pinned
        version, empty front) surface as ValueError on the future.

        Graceful degradation: when the admission queue already holds
        ``max_queue`` requests the call raises :class:`OverloadedError`
        immediately (retriable — nothing was enqueued); a request whose
        ``deadline_s`` elapses before its group runs fails with
        :class:`DeadlineExceeded` instead of burning backend time."""
        if self._closed:
            raise RuntimeError("serving engine is closed")
        req = ServeRequest(
            id=uuid.uuid4().hex[:12],
            inputs=np.asarray(inputs),
            tier=tier,
            budget=dict(budget) if budget else None,
            pin_version=int(pin_version) if pin_version is not None else None,
            gen=gen,
            return_outputs=bool(return_outputs),
            deadline=(time.perf_counter() + float(deadline_s)
                      if deadline_s is not None else None),
        )
        # started in the SUBMITTER's trace context: the request span
        # carries the caller's trace id through batch formation and is
        # ended by the batcher with the batch/group attrs
        req.span = obs.start_span(
            "serving.request", accel=self.accel.name, request=req.id,
            tier=tier, pinned=req.pin_version,
        )
        with self._cond:
            if len(self._queue) >= self.max_queue:
                # bounded admission: reject NOW (nothing enqueued) so
                # the caller can shed load instead of queueing forever
                self._n["rejects"] += 1
                depth = len(self._queue)
            else:
                depth = None
                self._n["requests"] += 1
                self._queue.append(req)
                self._m["depth"].set(len(self._queue))
                self._cond.notify_all()
        if depth is not None:
            self._m["rejects"].inc()
            req.span.end(error="OverloadedError: queue full")
            raise OverloadedError(
                f"serving queue full ({depth}/{self.max_queue}); "
                "retry with backoff")
        self._m["requests"].inc()
        return req.future

    def serve(self, inputs, *, timeout: float = 300.0, **kw) -> Dict:
        """Blocking convenience wrapper around ``submit``."""
        return self.submit(inputs, **kw).result(timeout=timeout)

    # ------------------------------------------------------------------
    # the batch loop
    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(0.25)
                if self._closed and not self._queue:
                    return
                # admission window: linger briefly so concurrent
                # submitters coalesce into one batch
                deadline = time.perf_counter() + self.max_wait_s
                while (len(self._queue) < self.max_batch
                       and not self._closed):
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                batch = [
                    self._queue.popleft()
                    for _ in range(min(self.max_batch, len(self._queue)))
                ]
                self._m["depth"].set(len(self._queue))
                catalog = self._catalog
                catalogs = dict(self._catalogs)
            if batch:
                try:
                    self._run_batch(batch, catalog, catalogs)
                except Exception as exc:  # noqa: BLE001 - engine must survive
                    _log.exception("serving batch failed")
                    for req in batch:
                        self._fail(req, exc)

    def _run_batch(self, batch, catalog, catalogs) -> None:
        bid = uuid.uuid4().hex[:8]
        with obs.span("serving.batch", accel=self.accel.name,
                      batch=bid, n=len(batch)) as sp:
            self._m["batches"].inc()
            with self._cond:
                self._n["batches"] += 1
            groups: "OrderedDict[tuple, tuple]" = OrderedDict()
            for req in batch:
                if (req.deadline is not None
                        and time.perf_counter() > req.deadline):
                    self._m["expired"].inc()
                    with self._cond:
                        self._n["expired"] += 1
                    self._fail(req, DeadlineExceeded(
                        f"request {req.id} waited "
                        f"{time.perf_counter() - req.t_submit:.3f}s, "
                        "past its deadline"))
                    continue
                cat = catalog
                if req.pin_version is not None:
                    cat = catalogs.get(req.pin_version)
                    if cat is None:
                        self._fail(req, ValueError(
                            f"unknown catalog version {req.pin_version} "
                            f"(kept: {sorted(catalogs)})"))
                        continue
                if cat is None or cat.empty:
                    self._fail(req, EmptyFrontError(
                        f"no front installed for {self.accel.name!r}"))
                    continue
                try:
                    sel = cat.select(tier=req.tier, budget=req.budget)
                except ValueError as exc:
                    self._fail(req, exc)
                    continue
                key = (sel.point.genome, self.backend.group_key(req))
                groups.setdefault(
                    key, (sel, cat.version, [])
                )[2].append(req)
            sp.set(groups=len(groups))
            for (genome, _), (sel, version, reqs) in groups.items():
                self._run_group(bid, sel, version, reqs)

    def _run_group(self, bid: str, sel: Selection, version: int,
                   reqs: List[ServeRequest]) -> None:
        tier_label = sel.tier or ("degraded" if not sel.feasible
                                  else "budget")
        with obs.span("serving.group", accel=self.accel.name, batch=bid,
                      tier=tier_label, version=version, n=len(reqs)):
            self._m["groups"].inc()
            try:
                faults.hit("serving.backend", accel=self.accel.name,
                           tier=tier_label, n=len(reqs))
                results = self.backend.run(sel.point, reqs)
            except Exception as exc:  # noqa: BLE001 - group isolation
                _log.exception("group execution failed (tier=%s)",
                               tier_label)
                for req in reqs:
                    self._fail(req, exc)
                return
        now = time.perf_counter()
        with self._cond:
            self._n["groups"] += 1
            self._n["responses"] += len(reqs)
            self._tier_counts[tier_label] = (
                self._tier_counts.get(tier_label, 0) + len(reqs))
            self._served_by_version[version] = (
                self._served_by_version.get(version, 0) + len(reqs))
            if not sel.feasible:
                self._n["degrades"] += len(reqs)
        _tier_counter(tier_label).inc(len(reqs))
        if not sel.feasible:
            self._m["degrades"].inc(len(reqs))
        for req, res in zip(reqs, results):
            out = {
                "id": req.id,
                "accel": self.accel.name,
                "tier": sel.tier,
                "feasible": sel.feasible,
                "catalog_version": version,
                "genome": list(sel.point.genome),
                "labels": dict(sel.point.labels),
                "batch": bid,
                "group_size": len(reqs),
                "latency_s": now - req.t_submit,
                **res,
            }
            self._m["responses"].inc()
            self._m["latency"].observe(now - req.t_submit)
            req.span.end(tier=tier_label, batch=bid, version=version,
                         group_size=len(reqs))
            if not req.future.set_running_or_notify_cancel():
                continue
            req.future.set_result(out)

    def _fail(self, req: ServeRequest, exc: BaseException) -> None:
        self._m["errors"].inc()
        with self._cond:
            self._n["errors"] += 1
        req.span.end(error=f"{type(exc).__name__}: {exc}")
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(exc)

    # ------------------------------------------------------------------
    def stats(self) -> Dict:
        with self._cond:
            cat = self._catalog
            depth = len(self._queue)
            tiers = dict(self._tier_counts)
            by_version = dict(self._served_by_version)
            counts = dict(self._n)
        out = {
            "accel": self.accel.name,
            "backend": self.backend.kind,
            "device": str(self.device),
            **counts,
            "queue_depth": depth,
            "tier_selections": tiers,
            "served_by_version": {str(k): v for k, v in by_version.items()},
        }
        if cat is not None:
            out["catalog"] = {
                "version": cat.version,
                "points": len(cat),
                "digest": cat.digest,
                "objectives": list(cat.objectives),
                "tiers": {
                    name: dict(cat.points[i].labels)
                    for name, i in cat.tiers.items()
                },
            }
        return out

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=10.0)
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
        for req in pending:
            self._fail(req, RuntimeError("serving engine closed"))
