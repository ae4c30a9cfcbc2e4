"""Continuous-batching evaluation scheduler.

Ground-truth labeling (deployment synthesis + behavioral simulation) dominates
every campaign's wall clock, so the service routes ALL label requests
through one scheduler that

  * answers from the label store when it can (cross-campaign and
    cross-process reuse),
  * **dedupes identical genomes in flight** — if campaign B asks for a
    genome campaign A is already synthesizing, B rides A's future
    instead of paying a second compile,
  * **coalesces** outstanding misses from all concurrent campaigns into
    batches (the JetStream/vLLM continuous-batching idiom: a short
    admission window, then drain up to ``max_batch`` compatible
    requests) and fans them out to a thread worker pool.

Requests are only batched together when they share an evaluation
context (same accelerator / library / QoR signature) — a batch is one
``ctx.ground_truth`` call.

``backend`` selects where a batch's ground truth runs: ``"thread"``
labels in-process on the dispatching worker thread, launching its
kernels on the context's device; ``"process"`` fans the batch out to a
spawn-safe worker process pool on ``device`` (``workers.
ProcessPoolLabeler``), the only way the GIL-bound host work of the
labels parallelizes; ``"fleet"`` leases batches to remote workers
registered with the embedded ``repro_torch.fleet`` orchestrator
(multi-host labeling, each worker on its own device);
``fleet_fallback`` picks what runs a batch when the fleet is empty or
the context is not portable.  Contexts a fresh process/host cannot
rebuild from their descriptor fall back to the in-process path, and
every such fallback is counted (``process_fallbacks``,
``fleet_fallbacks``), so ``stats()`` shows the degradation.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .. import faults, obs
from .store import LABEL_KEYS, EvalContext, LabelStore

__all__ = ["EvalScheduler", "gather_futures"]


def gather_futures(futures: List[Future], callback) -> None:
    """Invoke ``callback(recs, exc)`` exactly once when every future has
    resolved — the non-blocking counterpart of ``[f.result() for f in
    futures]`` that lets a campaign release its worker thread while its
    labels are in flight.  ``recs`` is the in-order result list (None on
    failure, with ``exc`` the first exception encountered)."""
    if not futures:
        callback([], None)
        return
    lock = threading.Lock()
    remaining = [len(futures)]

    def _one_done(_f: Future) -> None:
        with lock:
            remaining[0] -= 1
            if remaining[0]:
                return
        try:
            recs = [f.result() for f in futures]
        except Exception as exc:  # noqa: BLE001 - surfaced via callback
            callback(None, exc)
            return
        callback(recs, None)

    for f in futures:
        f.add_done_callback(_one_done)


@dataclass
class _Entry:
    """One in-flight unique genome: a shared future plus the campaigns
    waiting on it (for coalescing accounting)."""

    key: str
    genome: np.ndarray
    ctx: EvalContext
    origin: Optional[str] = None  # campaign that pays the ground truth
    future: Future = field(default_factory=Future)
    campaigns: set = field(default_factory=set)
    # trace context captured at submit() so the batch span (run on a
    # pool thread) links back to the submitting campaign's trace
    wire: Optional[dict] = None


class EvalScheduler:
    """Coalescing label scheduler over a ``LabelStore``.

    ``label(ctx, genomes)`` is the blocking batch interface campaigns
    inject into ``run_dse`` as their labeler; ``submit`` is the
    future-based building block underneath it."""

    def __init__(
        self,
        store: LabelStore,
        *,
        n_workers: int = 2,
        max_batch: int = 32,
        max_wait_s: float = 0.02,
        backend: str = "thread",
        process_workers: Optional[int] = None,
        chunk_size: Optional[int] = None,
        synth_cache_path: Optional[str] = None,
        fleet: Optional[object] = None,
        fleet_fallback: str = "thread",
        lease_ttl_s: float = 30.0,
        heartbeat_ttl_s: float = 15.0,
        fleet_chunk: Optional[int] = None,
        device=None,
    ):
        if backend not in ("thread", "process", "fleet"):
            raise ValueError(
                f"backend must be 'thread', 'process' or 'fleet', "
                f"got {backend!r}"
            )
        if fleet_fallback not in ("thread", "process"):
            raise ValueError(
                f"fleet_fallback must be 'thread' or 'process', "
                f"got {fleet_fallback!r}"
            )
        self.store = store
        if hasattr(store, "register_metrics"):
            store.register_metrics()
        self.backend = backend
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._proc = None
        self.fleet = None
        if backend == "fleet":
            from ..fleet.orchestrator import FleetCoordinator

            self.fleet = fleet if fleet is not None else FleetCoordinator(
                lease_ttl_s=lease_ttl_s, heartbeat_ttl_s=heartbeat_ttl_s,
                chunk_size=fleet_chunk,
            )
        if backend == "process" or (backend == "fleet"
                                    and fleet_fallback == "process"):
            from .workers import ProcessPoolLabeler

            self._proc = ProcessPoolLabeler(
                process_workers if process_workers is not None else n_workers,
                chunk_size=chunk_size, device=device,
                synth_cache_path=synth_cache_path,
            )
        self._pool = ThreadPoolExecutor(n_workers, thread_name_prefix="eval")
        self._cv = threading.Condition()
        self._pending: deque = deque()          # _Entry awaiting dispatch
        self._inflight: Dict[str, _Entry] = {}  # key -> entry (pending or running)
        self._stopped = False
        # accounting — registry instruments, not plain ints: per-thread
        # sharded counters are incrementable outside _cv (worker threads
        # never contend with stats() scrapes) and double as the
        # GET /metrics substrate.  Running counters only: the service is
        # long-lived, so per-batch history would grow unbounded.
        reg = obs.REGISTRY
        self.n_requests = reg.counter(
            "repro_sched_requests_total", "label requests submitted")
        self.n_store_hits = reg.counter(
            "repro_sched_store_hits_total", "requests answered by the store")
        self.n_inflight_hits = reg.counter(
            "repro_sched_inflight_hits_total",
            "requests deduped onto an in-flight genome")
        self.n_labeled = reg.counter(
            "repro_sched_labeled_total", "genomes ground-truth labeled")
        self.n_batches = reg.counter(
            "repro_sched_batches_total", "label batches dispatched")
        self.n_coalesced_batches = reg.counter(
            "repro_sched_coalesced_batches_total",
            "batches serving more than one campaign")
        self.n_process_batches = reg.counter(
            "repro_sched_process_batches_total",
            "batches labeled on the process pool")
        self.n_process_fallbacks = reg.counter(
            "repro_sched_process_fallbacks_total",
            "batches that fell back from the process pool")
        self.n_fleet_batches = reg.counter(
            "repro_sched_fleet_batches_total", "batches leased to the fleet")
        self.n_fleet_fallbacks = reg.counter(
            "repro_sched_fleet_fallbacks_total",
            "batches that fell back from the fleet")
        self.batch_size = reg.histogram(
            "repro_sched_batch_size", "genomes per dispatched batch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
        self.batch_seconds = reg.histogram(
            "repro_sched_batch_seconds",
            "ground truth + store write latency per batch")
        self.queue_depth = reg.gauge(
            "repro_sched_pending", "entries awaiting dispatch")
        self.inflight_gauge = reg.gauge(
            "repro_sched_inflight", "unique genomes pending or running")
        self.per_campaign: Dict[str, Dict[str, int]] = {}
        self._batcher = threading.Thread(
            target=self._batch_loop, name="eval-batcher", daemon=True
        )
        self._batcher.start()

    # ------------------------------------------------------------------
    def _campaign_stats(self, campaign: Optional[str]) -> Dict[str, int]:
        cid = campaign or "_anon"
        if cid not in self.per_campaign:
            self.per_campaign[cid] = {
                "requests": 0, "store_hits": 0, "inflight_hits": 0,
                "labeled": 0,
            }
        return self.per_campaign[cid]

    def submit(
        self,
        ctx: EvalContext,
        genomes: np.ndarray,
        *,
        campaign: Optional[str] = None,
    ) -> List[Future]:
        """One future per genome row; resolved futures for store hits."""
        genomes = np.atleast_2d(np.asarray(genomes, dtype=np.int64))
        futures: List[Future] = []
        to_enqueue: List[_Entry] = []
        wire = obs.wire_context()
        with self._cv:
            if self._stopped:
                raise RuntimeError("scheduler is shut down")
            cstats = self._campaign_stats(campaign)
            for g in genomes:
                self.n_requests.inc()
                cstats["requests"] += 1
                key = ctx.key(g)
                ent = self._inflight.get(key)
                if ent is not None:
                    # identical genome already queued/being labeled:
                    # share its future (in-flight dedup)
                    self.n_inflight_hits.inc()
                    cstats["inflight_hits"] += 1
                    if campaign is not None:
                        ent.campaigns.add(campaign)
                    futures.append(ent.future)
                    continue
                rec = self.store.get(key)
                if rec is not None:
                    self.n_store_hits.inc()
                    cstats["store_hits"] += 1
                    f: Future = Future()
                    f.set_result(rec)
                    futures.append(f)
                    continue
                ent = _Entry(key=key, genome=np.array(g), ctx=ctx,
                             origin=campaign, wire=wire)
                if campaign is not None:
                    ent.campaigns.add(campaign)
                self._inflight[key] = ent
                to_enqueue.append(ent)
                futures.append(ent.future)
            self._pending.extend(to_enqueue)
            self.queue_depth.set(len(self._pending))
            self.inflight_gauge.set(len(self._inflight))
            if to_enqueue:
                self._cv.notify_all()
        return futures

    def label(
        self,
        ctx: EvalContext,
        genomes: np.ndarray,
        *,
        campaign: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> Dict[str, np.ndarray]:
        """Blocking batch labeling — the drop-in ``run_dse`` labeler."""
        genomes = np.atleast_2d(np.asarray(genomes, dtype=np.int64))
        futures = self.submit(ctx, genomes, campaign=campaign)
        recs = [f.result(timeout=timeout) for f in futures]
        return {
            k: np.array([float(r[k]) for r in recs]) for k in LABEL_KEYS
        }

    # ------------------------------------------------------------------
    def _batch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._pending:
                    return
                # pending campaigns BEFORE the admission window: the
                # window only exists to coalesce concurrent campaigns,
                # so a lone campaign skips it (single-campaign latency —
                # every batch used to eat the full wait)
                pending_campaigns = {e.origin for e in self._pending}
            if self.max_wait_s > 0 and len(pending_campaigns) > 1:
                time.sleep(self.max_wait_s)
            batch: List[_Entry] = []
            bad: List = []  # (entry, exc) whose ctx.fingerprint raised
            with self._cv:
                if not self._pending:
                    continue
                # drain up to max_batch entries sharing the head's context
                head_fp = None
                keep: deque = deque()
                while self._pending:
                    ent = self._pending.popleft()
                    try:
                        fp = ent.ctx.fingerprint
                    except Exception as exc:  # noqa: BLE001 - caller ctx
                        self._inflight.pop(ent.key, None)
                        bad.append((ent, exc))
                        continue
                    if head_fp is None:
                        head_fp = fp
                    if len(batch) < self.max_batch and fp == head_fp:
                        batch.append(ent)
                    else:
                        keep.append(ent)
                self._pending = keep
                self.queue_depth.set(len(self._pending))
            # a misbehaving caller context must fail its waiters, never
            # kill the batcher thread
            for ent, exc in bad:
                ent.future.set_exception(exc)
            if not batch:
                continue
            try:
                self._pool.submit(self._run_batch, batch)
            except RuntimeError as exc:
                # pool already shut down (shutdown(wait=False) race):
                # fail the waiters instead of leaving futures unresolved
                with self._cv:
                    for e in batch:
                        self._inflight.pop(e.key, None)
                for e in batch:
                    e.future.set_exception(exc)

    def _ground_truth(self, ctx: EvalContext, genomes: np.ndarray,
                      sp=None):
        """One batched ground-truth call, on the configured backend."""
        if self.fleet is not None:
            # empty fleet / unportable context degrades to the fallback
            # backend below (counted, so /stats shows the degradation)
            if self.fleet.eligible(ctx):
                self.n_fleet_batches.inc()
                if sp is not None:
                    sp.set(backend="fleet")
                return self.fleet.label(ctx, genomes)
            self.n_fleet_fallbacks.inc()
        if self._proc is not None:
            if self._proc.can_label(ctx):
                self.n_process_batches.inc()
                if sp is not None:
                    sp.set(backend="process")
                return self._proc.label(ctx, genomes)
            self.n_process_fallbacks.inc()
        if sp is not None:
            sp.set(backend="thread")
        return ctx.ground_truth(genomes)

    def _run_batch(self, batch: List[_Entry]) -> None:
        ctx = batch[0].ctx
        head = batch[0]
        t0 = time.perf_counter()
        with obs.attach(head.wire), \
                obs.span("sched.batch", n=len(batch),
                         origin=head.origin) as sp:
            try:
                faults.hit("sched.dispatch", n=len(batch),
                           origin=head.origin)
                genomes = np.stack([e.genome for e in batch])
                labels = self._ground_truth(ctx, genomes, sp)
                recs = [
                    {k: float(labels[k][i]) for k in LABEL_KEYS}
                    for i in range(len(batch))
                ]
                # one lock acquisition + one buffered write for the batch
                self.store.put_many(
                    (e.key, rec) for e, rec in zip(batch, recs)
                )
            except Exception as exc:
                # label OR store failure: fail every waiter instead of
                # leaving dead inflight entries that hang future dedup hits
                sp.set(outcome="error", error=type(exc).__name__)
                with self._cv:
                    for e in batch:
                        self._inflight.pop(e.key, None)
                    self.inflight_gauge.set(len(self._inflight))
                for e in batch:
                    e.future.set_exception(exc)
                return
            with self._cv:
                # e.campaigns is mutated by submit() under this lock, so
                # the union must happen here too
                campaigns = set()
                for e in batch:
                    campaigns |= e.campaigns
                    # the originating request pays ground truth — accounted
                    # on success so failed batches don't overstate work
                    self._campaign_stats(e.origin)["labeled"] += 1
                for e in batch:
                    self._inflight.pop(e.key, None)
                self.inflight_gauge.set(len(self._inflight))
            self.n_labeled.inc(len(batch))
            self.n_batches.inc()
            if len(campaigns) > 1:
                self.n_coalesced_batches.inc()
            self.batch_size.observe(len(batch))
            self.batch_seconds.observe(time.perf_counter() - t0)
            sp.set(outcome="ok", campaigns=len(campaigns))
        for rec, e in zip(recs, batch):
            e.future.set_result(rec)

    # ------------------------------------------------------------------
    def stats(self) -> Dict:
        # per-backend labeler counters (the process pool aggregates its
        # workers' synthesis, engine and launch counters); taken outside
        # the cv so a slow pool can't stall submitters
        labeler = self._proc.stats() if self._proc is not None else None
        fleet = self.fleet.stats() if self.fleet is not None else None
        # counter reads are registry-instrument scrapes — no _cv needed,
        # so a long-running batch can never stall a stats() poller; only
        # the per-campaign dict still wants the lock
        requests = int(self.n_requests.value)
        store_hits = int(self.n_store_hits.value)
        inflight_hits = int(self.n_inflight_hits.value)
        n_batches = int(self.n_batches.value)
        with self._cv:
            per_campaign = {k: dict(v) for k, v in self.per_campaign.items()}
        return {
            "backend": self.backend,
            "labeler": labeler,
            "fleet": fleet,
            "fleet_batches": int(self.n_fleet_batches.value),
            "fleet_fallbacks": int(self.n_fleet_fallbacks.value),
            "process_batches": int(self.n_process_batches.value),
            "process_fallbacks": int(self.n_process_fallbacks.value),
            "requests": requests,
            "store_hits": store_hits,
            "inflight_dedup_hits": inflight_hits,
            "labeled": int(self.n_labeled.value),
            "batches": n_batches,
            "coalesced_batches": int(self.n_coalesced_batches.value),
            "mean_batch_size": (
                self.batch_size.sum / n_batches
            ) if n_batches else 0.0,
            "label_hit_rate": (
                (store_hits + inflight_hits) / requests
            ) if requests else 0.0,
            "per_campaign": per_campaign,
            "store": self.store.stats(),
        }

    def campaign_stats(self, campaign: str) -> Optional[Dict[str, int]]:
        """One campaign's labeling counters — O(1), unlike stats()."""
        with self._cv:
            s = self.per_campaign.get(campaign)
            return dict(s) if s is not None else None

    def forget_campaign(self, campaign: str) -> None:
        """Drop a retired campaign's per-campaign accounting (the
        global counters keep its contribution)."""
        with self._cv:
            self.per_campaign.pop(campaign, None)

    def shutdown(self, *, wait: bool = True) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if wait:
            self._batcher.join(timeout=5)
        if self.fleet is not None:
            # first: a pool thread blocked in fleet.label() reclaims its
            # remaining chunks in-process and returns, so the pool join
            # below cannot deadlock on a starved fleet
            self.fleet.shutdown(wait=wait)
        self._pool.shutdown(wait=wait)
        if self._proc is not None:
            self._proc.shutdown(wait=wait)
