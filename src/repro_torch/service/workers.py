"""Process-pool ground-truth labeler.

Behavioral simulation finishes on the host in numpy and deployment
synthesis does its bookkeeping in Python, both holding the GIL, so
thread workers give ZERO labeling parallelism on the host (the
scheduler's thread pool only overlaps I/O and device waits).  This
module fans whole coalesced label batches out to a pool of **spawned
worker processes**, each of which initializes once (library +
exhaustive product tables warmed at startup, the population engine
built on the worker's device, accelerators and evaluation contexts
cached per fingerprint) and then labels genome chunks with the same
batched ``EvalContext.ground_truth`` path the thread backend uses.

Labels are a pure function of the evaluation context fingerprint and the
genome, so process-backend labels are byte-identical to thread-backend
labels (tests pin this).

Nothing heavyweight is pickled: workers rebuild the context from its
wire descriptor (``fleet.protocol.ctx_descriptor``: the accelerator's
NAME, the QoR signature and the cost model's name) via
``make_accelerator`` and the default library from scratch.  A context
is process-safe exactly when a fresh process would derive the SAME
context fingerprint from the descriptor — ``can_label`` checks that in
the parent (resolving the name with the registry bypassed, since
``register_accelerator`` entries don't exist in a spawned child) and the
scheduler falls back to in-process labeling when it fails (ad-hoc
registered pipelines, subset libraries, parameterized accelerators,
unnamed cost models), counting each fallback.

Under CUDA:

* the pool always starts its children with ``spawn`` (a child forked
  from a parent that holds a CUDA context cannot use the card);
* each child is its own CUDA context on the pool's ``device`` and runs
  torch on its share of the host's cores and BLAS on one thread, so the
  children do not fight each other for the cores (two children whose
  OpenBLAS spun on all 8 cores of a host warmed the library twenty
  times slower than one); the BLAS setting is an environment variable
  read when the child loads numpy, so the pool starts its children at
  construction, with the variables set for their start only;
* the parent builds every kernel (``_build.build()``) before the pool
  starts, so two children never run ``nvcc`` at once;
* launch counts (``_build.LAUNCHES``) live per process: each chunk's
  result carries its child's launches (the chunk's own and the child's
  cumulative counts), and ``stats()`` sums them, as it sums the
  children's synthesis and population-engine counters;
* a child whose kernel fails to build or launch fails its chunk, and
  with it the batch: it never hands back labels from the plain
  versions.
"""

from __future__ import annotations

import contextlib
import math
import multiprocessing as mp
import os
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from .. import obs
from .store import LABEL_KEYS, EvalContext

__all__ = ["ProcessPoolLabeler", "init_device", "warm_library"]

# per-worker-process state: the device, the warm library and the
# contexts built so far
_WORKER_STATE: Dict = {}

# BLAS thread counts a child reads when it loads numpy
_CHILD_BLAS_ENV = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS",
                   "MKL_NUM_THREADS")
_ENV_LOCK = threading.Lock()


@contextlib.contextmanager
def _child_env(**env):
    """``env`` in ``os.environ`` for the processes started inside the
    block (a spawned child copies the environment when it starts), the
    parent's own values restored after."""
    with _ENV_LOCK:
        keep = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            yield
        finally:
            for k, v in keep.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def _ready() -> int:
    return os.getpid()


def init_device(device=None):
    """Resolve ``device`` (None: ``"cuda"``) for this process and make a
    CUDA device current, so every launch of the process goes to it."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return dev


def warm_library(lib, device=None) -> None:
    """Build every multiplier circuit's labeling-side caches: the
    exhaustive product table (the batched sim's LUT source), the error
    table, its effective rank and the deployment-rank SVD factors.  A
    cold labeler pays these lazily INSIDE its first batches (one
    256x256 SVD per circuit); warming them once up front keeps them out
    of the steady-state label stream.  With a ``device``, the population
    engine (its verified adder twins and tables) is built there too."""
    for kind in ("mul8u", "mul8s"):
        for c in lib.kind(kind):
            c.table
            c.etab
            r = c.deploy_rank
            if r > 0:
                c.factors(r)
    if device is not None:
        from ..accel import fused

        fused.build_engine(lib, device)


def _init_worker(device: str, torch_threads: int,
                 synth_cache_path: str = "") -> None:
    """Run once per spawned process: pin torch's CPU threads and the
    device, then build the library and warm the per-circuit labeling
    caches so the first labeled chunk doesn't pay them.  With a
    ``synth_cache_path`` the worker joins the pool-wide persistent
    synthesis cache (one file appended by every worker AND the parent),
    so no structure ever runs twice across the pool."""
    import torch

    torch.set_num_threads(torch_threads)
    from ..core.acl.library import default_library
    from ..core.features import synth

    dev = init_device(device)
    if synth_cache_path:
        # non-migrating open: the parent already owns (and may have
        # migrated) this path; replicas must never rename it
        synth.set_shared_synth_cache(
            synth.open_synth_cache(synth_cache_path))
    lib = default_library()
    warm_library(lib, dev)
    _WORKER_STATE["device"] = dev
    _WORKER_STATE["library"] = lib
    _WORKER_STATE["ctxs"] = {}


def _worker_label(
    desc: Dict,
    genomes: np.ndarray,
    wire: Optional[Dict] = None,
) -> Dict[str, np.ndarray]:
    """Label one genome chunk inside a worker process."""
    if "library" not in _WORKER_STATE:
        raise RuntimeError("process-pool worker was not initialized")
    from .. import _build
    from ..accel import fused
    from ..core.features import synth
    from ..fleet.protocol import build_context

    fp = desc["fingerprint"]
    ctx = _WORKER_STATE["ctxs"].get(fp)
    if ctx is None:
        # raises on fingerprint drift: the parent's gate should make it
        # unreachable, but a drifted worker must never poison the store
        ctx = build_context(desc, _WORKER_STATE["library"],
                            device=_WORKER_STATE["device"])
        _WORKER_STATE["ctxs"][fp] = ctx
    scache = synth.shared_synth_cache()
    if hasattr(scache, "refresh"):
        # pick up runs that sibling workers / the parent appended
        scache.refresh()
    # adopt the parent's trace context so this chunk's spans (and the
    # synth spans under it) link to the submitting campaign; the worker
    # handles one chunk at a time, so the ring holds exactly this
    # chunk's spans between clear() and snapshot(), and the launch
    # counts' difference is this chunk's launches
    rec = obs.recorder()
    rec.clear()
    before = dict(_build.LAUNCHES)
    with obs.attach(wire, worker=f"pool-{os.getpid()}"):
        with obs.span("labeler.chunk", n=int(len(genomes)),
                      accel=desc["accel"]):
            labels = ctx.ground_truth(np.asarray(genomes, dtype=np.int64))
    total = dict(_build.LAUNCHES)
    out = {k: np.asarray(labels[k]) for k in LABEL_KEYS}
    # piggyback this worker's cumulative counters AND the chunk's
    # finished spans on the result so the parent can aggregate/ingest
    # them without an extra round trip
    out["_synth_stats"] = {"pid": os.getpid(), **scache.stats()}
    out["_sim_stats"] = {"pid": os.getpid(), **fused.stats()}
    out["_launches"] = {
        "pid": os.getpid(), "device": str(_WORKER_STATE["device"]),
        "total": total,
        "chunk": {k: total[k] - before.get(k, 0) for k in total},
    }
    out["_spans"] = rec.snapshot()
    rec.clear()
    return out


class ProcessPoolLabeler:
    """Chunked batch fan-out to spawn-safe worker processes on
    ``device`` (None: ``"cuda"``).

    ``label`` splits a genome batch into ~``2 x n_workers`` chunks (or
    fixed ``chunk_size`` rows) and reassembles the per-chunk label dicts
    in order.  ``can_label`` gates which contexts may cross the process
    boundary; callers fall back to in-process labeling otherwise."""

    def __init__(
        self,
        n_workers: int = 2,
        *,
        chunk_size: Optional[int] = None,
        device=None,
        synth_cache_path: Optional[str] = None,
    ):
        from ..device import resolve_device

        self.n_workers = max(1, int(n_workers))
        self.chunk_size = None if chunk_size is None else max(1, int(chunk_size))
        self.synth_cache_path = synth_cache_path
        self.device = resolve_device(device)
        # each child's torch CPU threads: its share of the host's cores
        self.torch_threads = max(1, (os.cpu_count() or 1) // self.n_workers)
        if self.device.type == "cuda":
            from .. import _build

            # one nvcc per kernel, here, before any child could start one
            _build.build()
        self._pool = ProcessPoolExecutor(
            self.n_workers,
            mp_context=mp.get_context("spawn"),
            initializer=_init_worker,
            initargs=(str(self.device), self.torch_threads,
                      synth_cache_path or ""),
        )
        # start every child now (one per submit while none is idle yet),
        # under the BLAS setting, and wait for their initialization
        with _child_env(**{k: "1" for k in _CHILD_BLAS_ENV}):
            ready = [self._pool.submit(_ready)
                     for _ in range(self.n_workers)]
        for f in ready:
            f.result()
        self._lock = threading.Lock()
        self._safe_fps: Dict[str, bool] = {}   # ctx fingerprint -> verdict
        self._worker_synth: Dict[int, Dict] = {}  # pid -> latest counters
        self._worker_sim: Dict[int, Dict] = {}    # pid -> latest engine counters
        self._worker_launches: Dict[int, Dict] = {}  # pid -> cumulative launches
        # chunks in which each kernel launched at least once
        self._chunks_launching: Dict[str, int] = {}
        self.n_chunks = obs.REGISTRY.counter(
            "repro_labeler_chunks_total", "chunks sent to worker processes")
        self.n_labeled = obs.REGISTRY.counter(
            "repro_labeler_labeled_total",
            "genomes labeled by the process pool")
        self.batch_seconds = obs.REGISTRY.histogram(
            "repro_labeler_batch_seconds",
            "wall seconds per process-pool batch fan-out")

    # ------------------------------------------------------------------
    def can_label(self, ctx: EvalContext) -> bool:
        """True iff a fresh process on the pool's device, given only the
        context's descriptor, would rebuild a context with the SAME
        fingerprint (identical labels and store keys).  Cached per
        fingerprint.  The check itself is the fleet's portability gate —
        one rule decides what may cross a process OR host boundary."""
        fp = ctx.fingerprint
        with self._lock:
            if fp in self._safe_fps:
                return self._safe_fps[fp]
        from ..fleet.protocol import context_is_portable

        verdict = context_is_portable(ctx, device=self.device)
        with self._lock:
            self._safe_fps[fp] = verdict
        return verdict

    def _chunks(self, n: int) -> int:
        if self.chunk_size is not None:
            return max(1, math.ceil(n / self.chunk_size))
        # ~2 chunks per worker: keeps the pool busy when chunk costs are
        # uneven without shredding the batched-sim vectorization
        return min(n, 2 * self.n_workers)

    def label(self, ctx: EvalContext, genomes: np.ndarray) -> Dict[str, np.ndarray]:
        """Label a genome batch across the pool (caller must have
        checked ``can_label``)."""
        from ..fleet.protocol import ctx_descriptor

        genomes = np.atleast_2d(np.asarray(genomes, dtype=np.int64))
        parts = [
            c for c in np.array_split(genomes, self._chunks(len(genomes)))
            if len(c)
        ]
        desc = ctx_descriptor(ctx)
        t0 = time.perf_counter()
        with obs.span("labeler.batch", n=int(len(genomes)),
                      chunks=len(parts)):
            wire = obs.wire_context()
            futures = [self._pool.submit(_worker_label, desc, chunk, wire)
                       for chunk in parts]
            results = [f.result() for f in futures]
        self.batch_seconds.observe(time.perf_counter() - t0)
        self.n_chunks.inc(len(parts))
        self.n_labeled.inc(len(genomes))
        self.merge(results)
        return {
            k: np.concatenate([r[k] for r in results]) for k in LABEL_KEYS
        }

    def merge(self, results: List[Dict]) -> None:
        """Fold the counters and spans the chunks' results carry into
        this labeler's view: counters are cumulative per process, so the
        latest per pid wins; chunk launches count the chunks in which
        each kernel ran."""
        rec = obs.recorder()
        with self._lock:
            for r in results:
                ws = r.get("_synth_stats")
                if ws:
                    self._worker_synth[ws["pid"]] = ws
                sim = r.get("_sim_stats")
                if sim:
                    self._worker_sim[sim["pid"]] = sim
                la = r.get("_launches")
                if la:
                    self._worker_launches[la["pid"]] = dict(la["total"])
                    for k, v in la["chunk"].items():
                        if v > 0:
                            self._chunks_launching[k] = (
                                self._chunks_launching.get(k, 0) + 1)
        for r in results:
            rec.ingest(r.get("_spans") or ())

    def stats(self) -> Dict[str, int]:
        """Pool counters + the aggregated counters of every worker
        process: synthesis (runs paid, identity/structural cache hits,
        verification runs, pinned families), the population engine, and
        kernel launches (summed, and the chunks in which each kernel
        launched)."""
        with self._lock:
            per_worker = list(self._worker_synth.values())
            per_worker_sim = list(self._worker_sim.values())
            per_worker_launches = list(self._worker_launches.values())
            chunks_launching = dict(self._chunks_launching)
        synth_agg = {k: sum(int(w.get(k, 0)) for w in per_worker)
                     for k in ("compiles", "verify_compiles",
                               "identity_hits", "structural_hits",
                               "pinned_families")}
        # cache sizes are shared state when the pool rides one cache
        # file: report the widest view, not the (double-counting) sum
        for k in ("entries", "structures"):
            synth_agg[k] = max((int(w.get(k, 0)) for w in per_worker),
                               default=0)
        served = synth_agg["identity_hits"] + synth_agg["structural_hits"]
        total = served + synth_agg["compiles"]
        synth_agg["hit_rate"] = (served / total) if total else 0.0
        synth_agg["workers_reporting"] = len(per_worker)
        sim_agg = {k: sum(int(w.get(k, 0)) for w in per_worker_sim)
                   for k in ("fused_calls", "fused_qor_calls")}
        sim_agg["workers_reporting"] = len(per_worker_sim)
        launches: Dict[str, int] = {}
        for w in per_worker_launches:
            for k, v in w.items():
                launches[k] = launches.get(k, 0) + int(v)
        return {
            "workers": self.n_workers,
            "device": str(self.device),
            "torch_threads": self.torch_threads,
            "chunks": int(self.n_chunks.value),
            "labeled": int(self.n_labeled.value),
            "synth_cache_path": self.synth_cache_path,
            "synth": synth_agg,
            "sim": sim_agg,
            "launches": launches,
            "chunks_launching": chunks_launching,
        }

    def shutdown(self, *, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)
