"""Remote labeling worker: ``python -m repro_torch.fleet.worker``.

One worker process joins a fleet orchestrator over HTTP, pulls leased
genome chunks, labels them with the SAME batched ground-truth path every
other backend uses, and streams the results back:

    PYTHONPATH=src python -m repro_torch.fleet.worker \\
        --orchestrator http://127.0.0.1:8177 --device cuda \\
        --store runs/service_labels.jsonl \\
        --synth-cache runs/service_synth.jsonl

The worker labels on its own ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain PyTorch versions), never on the parent's: the
lease's descriptor carries the cost model, not the device.  Each result
carries the worker's cumulative kernel launch counts
(``_build.LAUNCHES``, which live per process), so the orchestrator's
``stats()`` shows which kernels every worker ran.

Warm start: pointing the worker at the shared ``JsonlLabelStore`` /
``JsonlSynthCache`` files means a joining worker answers already-labeled
genomes from the store replica without recomputing, and never recompiles
a deployment-graph structure any fleet member (or the service itself)
has run before.  Both are optional — a storeless worker simply
computes everything.

Safety: every leased chunk carries the parent's evaluation-context
fingerprint.  The worker rebuilds the context from the descriptor and
REJECTS the lease on any mismatch (the portability gate), so a drifted worker
can never poison the fleet's labels.  Heartbeats run on a daemon thread;
a ``kill -9`` simply stops them, and the orchestrator requeues the
in-flight lease after expiry — zero labels lost.
"""

from __future__ import annotations

import argparse
import os
import socket

import threading
import time
from typing import Dict, Optional

import numpy as np

from .. import faults, obs
from .http import CircuitBreaker, HttpError, request_json
from .protocol import PROTOCOL_VERSION, build_context, encode_labels

__all__ = ["FleetWorker", "main"]


class FleetWorker:
    """The worker loop: register -> poll leases -> label -> stream back,
    with a heartbeat thread keeping the registration alive."""

    def __init__(
        self,
        orchestrator: str,
        *,
        worker_id: Optional[str] = None,
        accels: Optional[list] = None,
        store_path: Optional[str] = None,
        synth_cache_path: Optional[str] = None,
        warm: bool = True,
        request_timeout_s: float = 30.0,
        verbose: bool = False,
        device=None,
    ):
        from ..device import resolve_device

        self.device = resolve_device(device)
        self.base = orchestrator.rstrip("/")
        self.worker_id = worker_id
        self.accels = list(accels) if accels else ["*"]
        self.store_path = store_path
        self.synth_cache_path = synth_cache_path
        self.warm = warm
        self.request_timeout_s = float(request_timeout_s)
        self.verbose = verbose
        # graceful degradation on the worker's one HTTP edge: fail fast
        # while the orchestrator is down (breaker) and never let one
        # call outlive a couple of lease TTLs (total deadline)
        self._breaker = CircuitBreaker(
            threshold=8, reset_s=5.0, name="worker")
        self._post_deadline_s = max(4 * self.request_timeout_s, 60.0)
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._heartbeat_s = 5.0
        self._idle_wait_s = 0.25
        self._library = None
        self._store = None
        self._ctxs: Dict[str, object] = {}      # fingerprint -> EvalContext
        self._verified_fps: set = set()
        self._fps_advertised: set = set()
        # counters (reported with results / heartbeats)
        reg = obs.REGISTRY
        self.n_leases = reg.counter(
            "repro_worker_leases_total", "leases served by this worker")
        self.n_labels = reg.counter(
            "repro_worker_labels_total", "genomes labeled by this worker")
        self.n_store_hits = reg.counter(
            "repro_worker_store_hits_total",
            "leased genomes answered from the shared store replica")
        self.n_rejects = reg.counter(
            "repro_worker_rejects_total",
            "leases rejected on fingerprint drift")
        self._logger = obs.get_logger("fleet.worker")
        if verbose:
            obs.setup_logging("info")

    # ------------------------------------------------------------------
    def _log(self, msg: str) -> None:
        self._logger.info("%s", msg)

    def _post(self, path: str, payload: Dict, *, retries: int = 4) -> Dict:
        return request_json(self.base + path, payload,
                            timeout=self.request_timeout_s, retries=retries,
                            breaker=self._breaker,
                            total_deadline_s=self._post_deadline_s)

    def _init_engine(self) -> None:
        """One-time per-process warmup, exactly the process-pool worker
        recipe: shared persistent synthesis cache first (before any
        run), then the library, its per-circuit label caches and the
        population engine on the worker's device."""
        from ..core.acl.library import default_library
        from ..core.features import synth
        from ..service.workers import init_device

        if self.synth_cache_path:
            # open_synth_cache resolves the path to whatever tier the
            # service uses (segmented root or legacy jsonl) WITHOUT
            # migrating — the service owns migration
            synth.set_shared_synth_cache(
                synth.open_synth_cache(self.synth_cache_path))
        init_device(self.device)
        self._library = default_library()
        if self.warm:
            from ..service.workers import warm_library

            warm_library(self._library, self.device)
        if self.store_path:
            from ..service.store import open_label_store

            # read-only replica of the shared store: leased genomes that
            # already have labels are answered without recomputing (the
            # orchestrator commits results, so the worker never appends)
            self._store = open_label_store(self.store_path)

    def register(self) -> str:
        resp = self._post("/fleet/register", {
            "protocol": PROTOCOL_VERSION,
            "worker": self.worker_id,
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "accels": self.accels,
            "fingerprints": sorted(self._verified_fps),
        })
        if not resp.get("ok"):
            raise RuntimeError(f"registration rejected: {resp.get('error')}")
        self.worker_id = resp["worker"]
        self._heartbeat_s = float(resp.get("heartbeat_s", 5.0))
        self._idle_wait_s = float(resp.get("idle_wait_s", 0.25))
        self._fps_advertised = set(self._verified_fps)
        self._log(f"registered (heartbeat every {self._heartbeat_s:.1f}s)")
        return self.worker_id

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self._heartbeat_s):
            try:
                f = faults.check("fleet.heartbeat", worker=self.worker_id)
                if f is not None:
                    if f.delay_s > 0:
                        time.sleep(f.delay_s)
                    if f.kind in ("drop", "error"):
                        continue  # beat lost in flight; TTL clock runs
                fresh = self._verified_fps - self._fps_advertised
                resp = self._post("/fleet/heartbeat", {
                    "worker": self.worker_id,
                    "fingerprints": sorted(fresh),
                }, retries=1)
                if resp.get("reregister"):
                    self.register()
                else:
                    self._fps_advertised |= fresh
            except Exception:  # noqa: BLE001 - next beat retries
                pass

    # ------------------------------------------------------------------
    def _context(self, desc: Dict):
        fp = desc["fingerprint"]
        ctx = self._ctxs.get(fp)
        if ctx is None:
            ctx = build_context(desc, library=self._library,
                                device=self.device)
            self._ctxs[fp] = ctx
            self._verified_fps.add(fp)
        return ctx

    def _label_chunk(self, ctx, genomes: np.ndarray):
        """Warm-start from the shared store, ground-truth the misses."""
        from ..service.store import LABEL_KEYS

        hits = {}
        if self._store is not None:
            self._store.refresh()
            for i, g in enumerate(genomes):
                rec = self._store.get(ctx.key(g))
                if rec is not None:
                    hits[i] = rec
        miss_idx = [i for i in range(len(genomes)) if i not in hits]
        if miss_idx:
            fresh = ctx.ground_truth(genomes[np.asarray(miss_idx)])
        out = {k: np.empty(len(genomes), dtype=np.float64)
               for k in LABEL_KEYS}
        for k in LABEL_KEYS:
            for i, rec in hits.items():
                out[k][i] = float(rec[k])
            for j, i in enumerate(miss_idx):
                out[k][i] = float(np.asarray(fresh[k])[j])
        return out, len(hits)

    def step(self) -> bool:
        """One poll: lease, label, stream back.  Returns True when a
        lease was served (False = idle poll)."""
        resp = self._post("/fleet/lease", {"worker": self.worker_id})
        if resp.get("reregister"):
            self.register()
            return False
        lease = resp.get("lease")
        if not lease:
            self._stop.wait(float(resp.get("idle_wait_s",
                                           self._idle_wait_s)))
            return False
        lid = lease["id"]
        genomes = np.asarray(lease["genomes"], dtype=np.int64)
        # adopt the lease's trace context: spans recorded here carry the
        # campaign/batch ids minted on the orchestrator side, and ride
        # back on the result payload for the orchestrator to ingest
        rec = obs.recorder()
        rec.clear()
        with obs.attach(lease.get("trace"), worker=self.worker_id,
                        lease=lid):
            try:
                ctx = self._context(lease["ctx"])
            except Exception as exc:  # noqa: BLE001 - drift/unknown name
                self.n_rejects.inc()
                with obs.span("worker.reject", lease=lid):
                    pass
                self._log(f"rejecting lease {lid}: {exc}")
                self._post("/fleet/result", {
                    "worker": self.worker_id, "lease": lid,
                    "reject": True, "error": str(exc),
                    "spans": rec.snapshot(),
                })
                rec.clear()
                return True
            t0 = time.perf_counter()
            with obs.span("worker.serve", n=int(len(genomes))) as sp:
                labels, store_hits = self._label_chunk(ctx, genomes)
                sp.set(store_hits=store_hits)
            busy = time.perf_counter() - t0
        self.n_leases.inc()
        self.n_labels.inc(len(genomes))
        self.n_store_hits.inc(store_hits)
        from .. import _build

        self._post("/fleet/result", {
            "worker": self.worker_id,
            "lease": lid,
            "labels": encode_labels(labels),
            "store_hits": store_hits,
            "busy_s": busy,
            "device": str(self.device),
            "launches": dict(_build.LAUNCHES),
            "spans": rec.snapshot(),
        })
        rec.clear()
        self._log(f"lease {lid}: {len(genomes)} labels "
                  f"({store_hits} store hits) in {busy:.2f}s")
        return True

    def run(self, *, max_leases: Optional[int] = None,
            max_idle_s: Optional[float] = None) -> None:
        """Register and serve until stopped (or ``max_leases`` chunks /
        ``max_idle_s`` of continuous idleness, for tests and scripts)."""
        self._init_engine()
        self.register()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="fleet-heartbeat", daemon=True)
        self._hb_thread.start()
        idle_since = time.monotonic()
        try:
            while not self._stop.is_set():
                if self.step():
                    idle_since = time.monotonic()
                    if (max_leases is not None
                            and self.n_leases.value >= max_leases):
                        return
                elif (max_idle_s is not None
                      and time.monotonic() - idle_since > max_idle_s):
                    return
        except HttpError as exc:
            # orchestrator gone for longer than the retry budget: exit
            # loudly — the supervisor (or the user) restarts us
            self._log(f"orchestrator unreachable, exiting: {exc}")
            raise
        finally:
            self._stop.set()
            try:
                # polite leave: lets the orchestrator requeue anything we
                # held without waiting out the heartbeat TTL.  Best
                # effort — a kill -9 skips this and the TTL path covers it
                self._post("/fleet/heartbeat",
                           {"worker": self.worker_id, "bye": True},
                           retries=0)
            except Exception:  # noqa: BLE001 - dying anyway
                pass

    def stop(self) -> None:
        self._stop.set()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet.worker",
        description="Remote ground-truth labeling worker: registers with "
                    "a fleet orchestrator, pulls leased genome chunks, "
                    "streams labels back with heartbeats",
    )
    ap.add_argument("--orchestrator", required=True,
                    help="orchestrator base URL, e.g. http://host:8177 "
                         "(the campaign service with --eval-backend fleet, "
                         "or a standalone serve_fleet listener)")
    ap.add_argument("--id", default=None,
                    help="stable worker id (default: generated; reusing an "
                         "id after a crash rejoins as the same worker)")
    ap.add_argument("--accels", default="*",
                    help="comma-separated accelerator names this worker "
                         "serves ('*' = any builtin)")
    ap.add_argument("--store", default=None,
                    help="shared JSONL label store to warm-start from "
                         "(read-only replica)")
    ap.add_argument("--synth-cache", default=None,
                    help="shared persistent structural compile cache")
    ap.add_argument("--device", default="cuda",
                    help="where this worker labels: cuda (the kernels) or "
                         "cpu (their plain PyTorch versions)")
    ap.add_argument("--no-warm", action="store_true",
                    help="skip the per-circuit table/SVD warmup (faster "
                         "start, slower first chunks)")
    ap.add_argument("--max-leases", type=int, default=None,
                    help="exit after serving N chunks (benchmarks/tests)")
    ap.add_argument("--max-idle-s", type=float, default=None,
                    help="exit after this long with no work")
    ap.add_argument("--log-level", default=None,
                    choices=["debug", "info", "warning", "error"],
                    help="structured log level (worker/campaign ids in "
                         "every record; default: warning, or info with "
                         "--verbose)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="also sink this worker's spans to a local JSONL "
                         "file (spans always ride back to the "
                         "orchestrator on result payloads)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    obs.setup_logging(args.log_level
                      or ("info" if args.verbose else "warning"))
    if args.trace:
        obs.set_sink(args.trace)
    worker = FleetWorker(
        args.orchestrator,
        worker_id=args.id,
        accels=[a.strip() for a in args.accels.split(",") if a.strip()],
        store_path=args.store,
        synth_cache_path=args.synth_cache,
        warm=not args.no_warm,
        verbose=args.verbose,
        device=args.device,
    )
    worker.run(max_leases=args.max_leases, max_idle_s=args.max_idle_s)


if __name__ == "__main__":
    main()
