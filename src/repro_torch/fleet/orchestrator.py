"""Fleet orchestrator: lease coalesced label batches to remote workers.

The coordinator is transport-agnostic — ``register`` / ``heartbeat`` /
``lease`` / ``result`` take and return JSON-safe dicts.  The service's
HTTP front end (``service/api.py``) mounts them under ``POST /fleet/*``;
``serve_fleet`` runs the same four routes standalone for CLI scripts,
benchmarks and tests that have no campaign manager.

Work flows PULL-style (the JetStream idiom): workers poll ``lease`` and
the coordinator hands out chunks of whatever batches are in flight, so
elastic join is trivial — a worker that registers mid-campaign starts
pulling chunks on its next poll, and one that leaves simply stops
polling.  Robustness invariants:

  * **zero-loss failure** — a lease that expires, or whose worker's
    heartbeats stop, requeues its chunk; chunks requeued past
    ``max_requeues`` (or stranded with no live worker) are labeled
    in-process by the orchestrator thread that owns the batch, so
    ``label()`` ALWAYS returns complete labels.
  * **at-most-once commit** — labels are deterministic and
    content-addressed; a late result from a presumed-dead worker either
    completes the chunk first (and the reissued lease's result is
    dropped as a duplicate) or finds it completed (and is dropped
    itself).  Either way the label store sees one record per key and a
    mid-run ``kill -9`` changes zero output bytes.
  * **drift safety** — a worker that derives a different context
    fingerprint than the parent rejects the lease; the fingerprint is
    pinned away from that worker, and away from the fleet entirely once
    every live worker has rejected it.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import faults, obs
from .leases import Chunk, FleetBatch, Lease, WorkerRecord
from .protocol import (
    PROTOCOL_VERSION,
    context_is_portable,
    ctx_descriptor,
    decode_labels,
)

__all__ = ["FleetCoordinator", "handle_fleet_request", "serve_fleet"]


class FleetCoordinator:
    """Orchestrator state machine for a labeling fleet.

    ``label(ctx, genomes)`` is the blocking batch call the
    ``EvalScheduler`` makes on its worker threads; everything else is
    the worker-facing protocol surface."""

    def __init__(
        self,
        *,
        lease_ttl_s: float = 30.0,
        heartbeat_ttl_s: float = 15.0,
        chunk_size: Optional[int] = None,
        max_requeues: int = 3,
        idle_wait_s: float = 0.25,
    ):
        self.lease_ttl_s = float(lease_ttl_s)
        self.heartbeat_ttl_s = float(heartbeat_ttl_s)
        self.chunk_size = None if chunk_size is None else max(1, int(chunk_size))
        self.max_requeues = int(max_requeues)
        self.idle_wait_s = float(idle_wait_s)
        # how often blocked label() threads wake to run expiry
        self._tick = min(1.0, max(0.05,
                                  min(lease_ttl_s, heartbeat_ttl_s) / 4.0))
        self._cv = threading.Condition()
        self._workers: Dict[str, WorkerRecord] = {}
        self._pending: deque = deque()             # Chunk
        self._leases: Dict[str, Lease] = {}        # lease id -> Lease
        self._retired: Dict[str, Lease] = {}       # expired, awaiting late results
        self._portable: Dict[str, bool] = {}       # ctx fp -> parent-side gate
        self._drifted: set = set()                 # fps every worker rejected
        self._stopped = False
        # counters — registry instruments (scrape-safe without _cv)
        reg = obs.REGISTRY
        self.n_batches = reg.counter(
            "repro_fleet_batches_total", "batches split across the fleet")
        self.n_chunks = reg.counter(
            "repro_fleet_chunks_total", "chunks created for leasing")
        self.n_requeues = reg.counter(
            "repro_fleet_requeues_total", "chunks requeued after a failure")
        self.n_expired_leases = reg.counter(
            "repro_fleet_expired_leases_total",
            "leases reclaimed on deadline/heartbeat expiry")
        self.n_dead_workers = reg.counter(
            "repro_fleet_dead_workers_total",
            "workers declared dead by heartbeat TTL")
        self.n_duplicate_results = reg.counter(
            "repro_fleet_duplicate_results_total",
            "late/duplicate results dropped idempotently")
        self.n_local_chunks = reg.counter(
            "repro_fleet_local_chunks_total",
            "starved chunks labeled in-process")
        self.n_remote_labels = reg.counter(
            "repro_fleet_remote_labels_total", "labels from fleet workers")
        self.n_local_labels = reg.counter(
            "repro_fleet_local_labels_total",
            "labels from the in-process reclaim path")
        self.live_gauge = reg.gauge(
            "repro_fleet_live_workers", "workers within heartbeat TTL")
        self.pending_gauge = reg.gauge(
            "repro_fleet_pending_chunks", "chunks awaiting a lease")
        self.leases_gauge = reg.gauge(
            "repro_fleet_leases_in_flight", "chunks currently leased")

    # ------------------------------------------------------------------
    # scheduler-facing
    # ------------------------------------------------------------------
    def eligible(self, ctx) -> bool:
        """True iff this batch should go to the fleet: the context is
        portable (the process-pool gate) and at least one live worker advertises
        capability for it.  An empty fleet answers False — the scheduler
        degrades to its in-process backend."""
        fp = ctx.fingerprint
        if fp in self._drifted:
            return False
        portable = self._portable.get(fp)
        if portable is None:
            # builds a reference context once per fingerprint; outside
            # the lock on purpose (first call pays an accelerator build)
            portable = context_is_portable(ctx)
            with self._cv:
                self._portable[fp] = portable
        if not portable:
            return False
        desc = ctx_descriptor(ctx)
        with self._cv:
            self._expire_locked(time.monotonic())
            return any(w.alive and w.can_serve(desc)
                       for w in self._workers.values())

    def label(self, ctx, genomes: np.ndarray) -> Dict[str, np.ndarray]:
        """Label a batch across the fleet (blocking).  Worker failures
        requeue; starved chunks are labeled in-process; the result is
        byte-identical to ``ctx.ground_truth(genomes)``."""
        genomes = np.atleast_2d(np.asarray(genomes, dtype=np.int64))
        desc = ctx_descriptor(ctx)
        with obs.span("fleet.batch", n=int(len(genomes))) as sp:
            # chunks carry the batch's trace context so lease-lifecycle
            # spans (granted on protocol threads) and worker-side spans
            # link back to the submitting campaign
            wire = obs.wire_context()
            with self._cv:
                live = sum(w.alive for w in self._workers.values())
                parts = self._split(len(genomes), live)
                batch = FleetBatch(ctx, len(parts))
                chunks = [
                    Chunk(batch=batch, index=i, desc=desc,
                          genomes=genomes[idx], wire=wire)
                    for i, idx in enumerate(parts)
                ]
                self._pending.extend(chunks)
                self.n_batches.inc()
                self.n_chunks.inc(len(chunks))
                self.pending_gauge.set(len(self._pending))
                self._cv.notify_all()
            sp.set(chunks=len(chunks), live_workers=live)
            n_local = 0
            while True:
                local: List[Chunk] = []
                with self._cv:
                    if batch.remaining == 0:
                        break
                    self._expire_locked(time.monotonic())
                    local = self._reclaim_locked(batch)
                    if not local and batch.remaining > 0:
                        self._cv.wait(timeout=self._tick)
                        continue
                for chunk in local:
                    # in-process fallback OUTSIDE the lock; complete()
                    # drops a racing late remote result for the chunk
                    with obs.span("fleet.local",
                                  n=int(len(chunk.genomes))):
                        labels = ctx.ground_truth(chunk.genomes)
                    with self._cv:
                        if batch.complete(chunk, {
                            k: np.asarray(v) for k, v in labels.items()
                        }):
                            chunk.worker = None
                            n_local += 1
                            self.n_local_chunks.inc()
                            self.n_local_labels.inc(len(chunk.genomes))
                        self._cv.notify_all()
            sp.set(local_chunks=n_local)
            return batch.assemble()

    def _split(self, n: int, live_workers: int) -> List[np.ndarray]:
        """Chunking mirrors the process pool: ~2 chunks per live worker
        (or fixed ``chunk_size`` rows) — small enough that a death
        requeues a slice, big enough to stay vectorized."""
        if self.chunk_size is not None:
            k = -(-n // self.chunk_size)
        else:
            k = max(1, 2 * max(live_workers, 1))
        return [c for c in np.array_split(np.arange(n), min(n, k)) if len(c)]

    def _reclaim_locked(self, batch: FleetBatch) -> List[Chunk]:
        """Pull this batch's starved chunks off the pending queue for
        in-process labeling: requeued past the cap, stranded with no
        live capable worker, or orphaned by shutdown."""
        keep: deque = deque()
        mine: List[Chunk] = []
        while self._pending:
            chunk = self._pending.popleft()
            if chunk.batch is not batch or chunk.state == "done":
                if chunk.state != "done":
                    keep.append(chunk)
                continue
            starved = (
                self._stopped
                or chunk.requeues > self.max_requeues
                or not any(w.alive and w.can_serve(chunk.desc)
                           for w in self._workers.values())
            )
            if starved:
                mine.append(chunk)
            else:
                keep.append(chunk)
        self._pending = keep
        return mine

    # ------------------------------------------------------------------
    # worker-facing protocol (JSON-safe dicts in and out)
    # ------------------------------------------------------------------
    def register(self, payload: Dict) -> Dict:
        """Join (or rejoin) the fleet.  Idempotent upsert by worker id;
        returns the cadence the worker should poll and heartbeat at."""
        proto = int(payload.get("protocol", PROTOCOL_VERSION))
        if proto != PROTOCOL_VERSION:
            return {"ok": False,
                    "error": f"protocol {proto} != {PROTOCOL_VERSION}"}
        wid = str(payload.get("worker") or f"w-{uuid.uuid4().hex[:8]}")
        now = time.monotonic()
        with self._cv:
            w = self._workers.get(wid)
            if w is None:
                w = WorkerRecord(id=wid)
                self._workers[wid] = w
            else:
                w.rejoin_count += 1
            w.alive = True
            w.last_seen = now
            w.host = str(payload.get("host", ""))
            w.pid = payload.get("pid")
            w.accels = set(payload.get("accels") or ["*"])
            w.fingerprints |= set(payload.get("fingerprints") or [])
            self._cv.notify_all()
        return {
            "ok": True,
            "worker": wid,
            "protocol": PROTOCOL_VERSION,
            "heartbeat_s": self.heartbeat_ttl_s / 3.0,
            "idle_wait_s": self.idle_wait_s,
            "lease_ttl_s": self.lease_ttl_s,
        }

    def heartbeat(self, payload: Dict) -> Dict:
        """Keep a worker alive; merges newly verified fingerprints.
        ``{"bye": true}`` is a polite leave: the worker is declared dead
        NOW and its in-flight leases requeue immediately, instead of the
        fleet waiting out the heartbeat TTL."""
        wid = str(payload.get("worker", ""))
        with self._cv:
            w = self._workers.get(wid)
            if payload.get("bye"):
                if w is not None and w.alive:
                    w.alive = False
                    self._expire_locked(time.monotonic())
                    self._cv.notify_all()
                return {"ok": True, "bye": True}
            if w is None or not w.alive:
                # orchestrator restarted (or the worker was declared
                # dead): tell it to re-register instead of silently
                # heartbeating into the void
                return {"ok": False, "reregister": True}
            w.last_seen = time.monotonic()
            w.fingerprints |= set(payload.get("fingerprints") or [])
        return {"ok": True}

    def lease(self, payload: Dict) -> Dict:
        """Hand the polling worker one pending chunk it can serve, or
        tell it how long to idle."""
        wid = str(payload.get("worker", ""))
        now = time.monotonic()
        with self._cv:
            self._expire_locked(now)
            w = self._workers.get(wid)
            if w is None or not w.alive:
                return {"ok": False, "reregister": True}
            w.last_seen = now
            chunk = None
            for i, cand in enumerate(self._pending):
                if w.can_serve(cand.desc):
                    chunk = cand
                    del self._pending[i]
                    break
            if chunk is None:
                return {"ok": True, "lease": None,
                        "idle_wait_s": self.idle_wait_s}
            lease = Lease(
                id=f"l-{uuid.uuid4().hex[:12]}", chunk=chunk, worker=wid,
                issued_at=now, deadline=now + self.lease_ttl_s,
            )
            chunk.state = "leased"
            self._leases[lease.id] = lease
            self.pending_gauge.set(len(self._pending))
            self.leases_gauge.set(len(self._leases))
            # grant→result/expiry lifecycle span, parented to the batch
            # that created the chunk (this thread is an HTTP handler, so
            # the ambient context is not the campaign's)
            with obs.attach(chunk.wire):
                lease.span = obs.start_span(
                    "fleet.lease", lease=lease.id, worker=wid,
                    n=int(len(chunk.genomes)), requeues=chunk.requeues,
                )
            f = faults.check("fleet.lease", worker=wid, lease=lease.id)
            if f is not None:
                if f.delay_s > 0:
                    time.sleep(f.delay_s)
                if f.kind in ("drop", "error"):
                    # grant lost in flight: the worker never sees it, so
                    # the lease rides the normal TTL-expiry requeue path
                    return {"ok": True, "lease": None,
                            "idle_wait_s": self.idle_wait_s}
            return {
                "ok": True,
                "lease": {
                    "id": lease.id,
                    "ctx": chunk.desc,
                    "genomes": chunk.genomes.tolist(),
                    "ttl_s": self.lease_ttl_s,
                    "trace": chunk.wire,
                },
            }

    def result(self, payload: Dict) -> Dict:
        """Accept a finished (or rejected) lease.  Duplicates and late
        results after a requeue are dropped idempotently — labels are
        deterministic, so whichever copy lands first is THE result."""
        f = faults.check("fleet.result", lease=payload.get("lease"),
                         worker=payload.get("worker"))
        if f is not None:
            if f.delay_s > 0:
                time.sleep(f.delay_s)  # late delivery past the TTL
            if f.kind in ("drop", "error"):
                # result lost before ingest: the lease expires, the
                # chunk requeues, and the (deterministic) labels are
                # recomputed — nothing is lost, only delayed
                return {"ok": True, "dropped": True}
            if f.kind == "duplicate":
                self._result_once(payload)  # second copy below dedupes
        return self._result_once(payload)

    def _result_once(self, payload: Dict) -> Dict:
        wid = str(payload.get("worker", ""))
        lid = str(payload.get("lease", ""))
        # worker-side spans piggyback on the result payload (the
        # process-pool idiom): fold them into the local ring/sink
        spans = payload.get("spans")
        if spans:
            obs.recorder().ingest(spans)
        with self._cv:
            w = self._workers.get(wid)
            if w is not None:
                w.last_seen = time.monotonic()
            lease = self._leases.pop(lid, None) or self._retired.pop(lid, None)
            self.leases_gauge.set(len(self._leases))
            if lease is None:
                self.n_duplicate_results.inc()
                return {"ok": True, "duplicate": True}
            chunk = lease.chunk
            lspan, lease.span = lease.span, None
            if payload.get("reject"):
                if lspan is not None:
                    lspan.end(outcome="rejected")
                # fingerprint drift: never lease this fp to this worker
                # again; once EVERY live worker has rejected it, pin the
                # fp off the fleet entirely
                fp = chunk.desc.get("fingerprint")
                if w is not None and fp:
                    w.rejected_fps.add(fp)
                live = [x for x in self._workers.values() if x.alive]
                if fp and live and all(fp in x.rejected_fps for x in live):
                    self._drifted.add(fp)
                self._requeue_locked(chunk)
                self._cv.notify_all()
                return {"ok": True, "rejected": True}
            try:
                labels = decode_labels(payload.get("labels") or {},
                                       n=len(chunk.genomes))
            except ValueError as exc:
                if lspan is not None:
                    lspan.end(outcome="error", error=str(exc)[:120])
                self._requeue_locked(chunk)
                self._cv.notify_all()
                return {"ok": False, "error": str(exc)}
            if chunk.batch.complete(chunk, labels):
                chunk.worker = wid
                self.n_remote_labels.inc(len(chunk.genomes))
                if w is not None:
                    w.labels += len(chunk.genomes)
                    w.chunks += 1
                    w.store_hits += int(payload.get("store_hits", 0))
                    w.busy_s += float(payload.get("busy_s", 0.0))
                    w.device = str(payload.get("device", w.device))
                    w.launches = dict(payload.get("launches") or w.launches)
                if lspan is not None:
                    lspan.end(outcome="ok")
            else:
                self.n_duplicate_results.inc()
                if lspan is not None:
                    lspan.end(outcome="duplicate")
            self._cv.notify_all()
        return {"ok": True}

    # ------------------------------------------------------------------
    def _requeue_locked(self, chunk: Chunk) -> None:
        if chunk.state == "done":
            return
        chunk.state = "pending"
        chunk.requeues += 1
        self.n_requeues.inc()
        self._pending.append(chunk)
        self.pending_gauge.set(len(self._pending))

    def _expire_locked(self, now: float) -> None:
        """Declare silent workers dead and requeue expired leases —
        called opportunistically from every protocol entry point and
        every blocked ``label()`` wake, so no reaper thread is needed."""
        n_live = 0
        for w in self._workers.values():
            if w.alive and now - w.last_seen > self.heartbeat_ttl_s:
                w.alive = False
                self.n_dead_workers.inc()
            n_live += w.alive
        self.live_gauge.set(n_live)
        expired = [
            lid for lid, lease in self._leases.items()
            if now > lease.deadline
            or not self._workers[lease.worker].alive
        ]
        for lid in expired:
            lease = self._leases.pop(lid)
            self.n_expired_leases.inc()
            if lease.span is not None:
                lease.span.end(outcome="expired")
                lease.span = None
            # keep the retired lease so a late result can still land
            self._retired[lid] = lease
            while len(self._retired) > 256:
                self._retired.pop(next(iter(self._retired)))
            self._requeue_locked(lease.chunk)
        if expired:
            self.leases_gauge.set(len(self._leases))
            self._cv.notify_all()

    # ------------------------------------------------------------------
    def stats(self) -> Dict:
        now = time.monotonic()
        with self._cv:
            # a monitoring read must not report workers live past their
            # heartbeat TTL (nothing else runs expiry on an idle fleet)
            self._expire_locked(now)
            workers = {
                w.id: {
                    "alive": w.alive,
                    "host": w.host,
                    "pid": w.pid,
                    "accels": sorted(w.accels),
                    "last_heartbeat_age_s": round(now - w.last_seen, 3),
                    "rejoins": w.rejoin_count,
                    "labels": w.labels,
                    "chunks": w.chunks,
                    "store_hits": w.store_hits,
                    "labels_per_sec": round(w.labels_per_sec(), 3),
                    "device": w.device,
                    "launches": dict(w.launches),
                }
                for w in self._workers.values()
            }
            return {
                "workers": workers,
                "registered": len(self._workers),
                "live": sum(w.alive for w in self._workers.values()),
                "leases_in_flight": len(self._leases),
                "pending_chunks": len(self._pending),
                "batches": int(self.n_batches.value),
                "chunks": int(self.n_chunks.value),
                "requeues": int(self.n_requeues.value),
                "expired_leases": int(self.n_expired_leases.value),
                "dead_workers": int(self.n_dead_workers.value),
                "duplicate_results": int(self.n_duplicate_results.value),
                "local_fallback_chunks": int(self.n_local_chunks.value),
                "remote_labels": int(self.n_remote_labels.value),
                "local_labels": int(self.n_local_labels.value),
                "drifted_fingerprints": len(self._drifted),
            }

    def shutdown(self, *, wait: bool = True) -> None:
        """Stop leasing; blocked ``label()`` calls reclaim their
        remaining chunks in-process and return complete labels."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()


# ---------------------------------------------------------------------------
# transport shims
# ---------------------------------------------------------------------------

_ACTIONS = ("register", "heartbeat", "lease", "result")


def handle_fleet_request(coordinator: Optional[FleetCoordinator],
                         action: str, payload: Dict) -> Tuple[int, Dict]:
    """Shared dispatch for ``POST /fleet/<action>`` — used by both the
    service front end and the standalone ``serve_fleet`` listener."""
    if coordinator is None:
        return 404, {"error": "fleet backend not enabled "
                              "(start with --eval-backend fleet)"}
    if action not in _ACTIONS:
        return 404, {"error": f"no fleet action {action!r}"}
    try:
        return 200, getattr(coordinator, action)(dict(payload or {}))
    except Exception as exc:  # noqa: BLE001 - JSON 500, keep serving
        return 500, {"error": f"{type(exc).__name__}: {exc}"}


def serve_fleet(coordinator: FleetCoordinator, host: str = "127.0.0.1",
                port: int = 0, *, quiet: bool = True):
    """Standalone HTTP listener for the four fleet routes (+ ``GET
    /fleet/stats`` and ``/healthz``), for scripts that embed the
    orchestrator without the campaign service.  Serves on a daemon
    thread; returns the ``ThreadingHTTPServer`` (``server_address[1]``
    carries the bound port; ``shutdown()`` stops it)."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: A003 - stdlib API
            if not quiet:
                super().log_message(fmt, *args)

        def _send(self, obj, code=200):
            body = json.dumps(obj, default=float).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - stdlib API
            if self.path.rstrip("/") == "/healthz":
                return self._send({"ok": True})
            if self.path.rstrip("/") == "/fleet/stats":
                return self._send(coordinator.stats())
            return self._send({"error": f"no route {self.path}"}, 404)

        def do_POST(self):  # noqa: N802 - stdlib API
            action = self.path.rstrip("/").rsplit("/", 1)[-1]
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._send({"error": "bad JSON"}, 400)
            code, obj = handle_fleet_request(coordinator, action, payload)
            return self._send(obj, code)

    srv = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=srv.serve_forever, name="fleet-http",
                     daemon=True).start()
    return srv
