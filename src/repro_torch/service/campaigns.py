"""Campaign manager + warm surrogate registry.

A *campaign* is one three-stage DSE owned by the service.  It is NOT a
blocking ``run_dse`` call on a dedicated thread: the manager steps
``core.strategies.Campaign`` state machines cooperatively — one executor
task per tick (a label request, one ask/tell strategy round, or one
label delivery) — so N campaigns multiplex over a small worker pool and
a campaign whose ground truth is in flight holds no thread at all.
Every tick boundary snapshots the campaign state, which is what backs
``cancel``/``resume`` (``POST /campaigns/<id>/resume`` continues a
killed campaign, cross-process when ``snapshot_path`` is set).

Ground-truth labeling runs through the shared ``EvalScheduler`` (store
reuse + in-flight dedup + coalesced batches) and surrogate fits go
through the ``SurrogateRegistry`` (warm fitted models keyed by
``(eval context, pipeline, objective, model, seed)``).

Warm-surrogate modes (``CampaignSpec.warm_surrogates``):

  * ``"reuse"`` (default) — an exact match on the training-set digest
    returns the already-fitted model with NO refit; results stay
    bit-identical to a cold run (same data -> same fit).
  * ``"accumulate"`` — a key match with NEW data refits on the union of
    everything the registry has seen for that key (incremental refit
    instead of a from-scratch retrain on a larger, redundant sample).
    Deliberately trades bit-reproducibility for surrogate quality.
  * ``"off"`` — always fit fresh.

The port's copy of the JAX package's manager.  It takes ``device`` and
``hw`` and hands both to every ``EvalContext`` it builds (and the
device to every ``lm:<arch>`` accelerator and to the process pool), so
its campaigns label on that device with that cost model; fleet workers
label on their own devices with the context's cost model.
"""

from __future__ import annotations

import hashlib
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..core.dse import DSEConfig, DSEResult
from ..core.hw import H100_SXM, Hardware
from ..core.nsga2 import NSGA2Config
from ..core.pareto import non_dominated_mask
from ..core.surrogates import make
from .scheduler import EvalScheduler
from .store import LABEL_KEYS, EvalContext, InMemoryLabelStore, LabelStore

_log = obs.get_logger("service.campaigns")

__all__ = [
    "CampaignSpec",
    "HierarchicalSpec",
    "CampaignManager",
    "SurrogateRegistry",
    "make_accelerator",
    "register_accelerator",
    "unregister_accelerator",
]

# extension point: custom accelerator factories by name (used by
# repro_torch.hierarchy to make ad-hoc pipelines resolvable by the campaign
# workers; also handy for tests)
_REGISTRY: Dict[str, callable] = {}


def register_accelerator(name: str, factory) -> None:
    """Register a zero-arg factory so ``make_accelerator(name)`` (and
    hence campaign specs) can resolve a custom accelerator.  The entry
    lives for the process (run_hierarchical relies on the name staying
    resolvable for its stage campaigns); reclaim retired names with
    ``unregister_accelerator``."""
    _REGISTRY[name] = factory


def unregister_accelerator(name: str) -> bool:
    """Drop a registered factory (no-op on unknown names).  Only do this
    once no in-flight campaign still resolves the name."""
    return _REGISTRY.pop(name, None) is not None


def make_accelerator(name: str, *, builtin_only: bool = False,
                     device=None):
    """Accelerator factory for service requests.

    ``mcm1``..``mcm4`` (HEVC DCT rows), ``hevc_dct4x4``, ``gaussian3x3``,
    ``smoothed_dct`` (the staged Gaussian->DCT pipeline),
    ``<pipeline>/stage<i>`` (one stage of a staged pipeline, QoR in situ)
    and ``lm:<arch>`` (the reduced config of a ported arch, its model on
    ``device``; the image accelerators take the device per call).  Names
    registered via ``register_accelerator`` take precedence unless
    ``builtin_only``."""
    if not builtin_only and name in _REGISTRY:
        return _REGISTRY[name]()
    if "/stage" in name:
        base, _, idx = name.rpartition("/stage")
        pipe = make_accelerator(base, builtin_only=builtin_only,
                                device=device)
        if not hasattr(pipe, "stage_views"):
            raise ValueError(f"{base!r} is not a staged pipeline")
        views = pipe.stage_views()
        if not idx.isdigit() or int(idx) >= len(views):
            raise ValueError(
                f"unknown stage {name!r}: {base!r} has stages "
                f"0..{len(views) - 1}"
            )
        return views[int(idx)]
    from ..accel import GaussianFilter, HEVCDct, MCMAccelerator

    if name.startswith("mcm"):
        try:
            row = int(name[3:]) - 1
        except ValueError:
            raise ValueError(f"unknown accelerator {name!r}") from None
        if not 0 <= row < 4:
            raise ValueError(f"unknown MCM accelerator {name!r}")
        return MCMAccelerator(row)
    if name == "hevc_dct4x4":
        return HEVCDct()
    if name == "gaussian3x3":
        return GaussianFilter()
    if name == "smoothed_dct":
        from ..accel.smoothed_dct import SmoothedDct

        return SmoothedDct()
    if name.startswith("lm:"):
        from ..accel.lm import LMAccelerator
        from ..configs import get_config

        try:
            config = get_config(name[3:])
        except KeyError as exc:
            # ValueError is the factory's contract (-> HTTP 400)
            raise ValueError(f"unknown accelerator {name!r}: {exc}") from exc
        return LMAccelerator(config, device=device)
    raise ValueError(f"unknown accelerator {name!r}")


@dataclass(frozen=True)
class CampaignSpec:
    """A serializable DSE request (what the HTTP API accepts)."""

    accel: str = "mcm2"
    pipeline: str = "D"
    qor_model: str = "random_forest"
    hw_model: str = "bayesian_ridge"
    strategy: str = "nsga2"         # explorer (core.strategies registry)
    objectives: Tuple[str, ...] = ("qor", "energy")
    n_train: int = 80
    n_qor_samples: int = 4
    rank_genes: bool = False
    warm_start: bool = True
    pop_size: int = 48
    n_parents: int = 16
    n_generations: int = 10
    seed: int = 0
    warm_surrogates: str = "reuse"   # "reuse" | "accumulate" | "off"

    def __post_init__(self):
        if self.warm_surrogates not in ("reuse", "accumulate", "off"):
            raise ValueError(
                f"warm_surrogates must be 'reuse', 'accumulate' or 'off', "
                f"got {self.warm_surrogates!r}"
            )

    def validate(self) -> None:
        """Submit-time validation: reject unknown accelerators and
        malformed sizes with a ValueError (HTTP 400) instead of letting
        the campaign fail asynchronously in a worker thread."""
        _validate_sizes(self)
        from ..core.strategies import available_strategies

        if self.strategy not in available_strategies():
            raise ValueError(
                f"unknown strategy {self.strategy!r}; known: "
                f"{available_strategies()}"
            )
        make_accelerator(self.accel)  # raises ValueError if unknown

    def dse_config(self) -> DSEConfig:
        return DSEConfig(
            pipeline=self.pipeline,
            hw_model=self.hw_model,
            qor_model=self.qor_model,
            strategy=self.strategy,
            objectives=tuple(self.objectives),
            n_train=self.n_train,
            n_qor_samples=self.n_qor_samples,
            rank_genes=self.rank_genes,
            warm_start=self.warm_start,
            nsga=NSGA2Config(
                pop_size=self.pop_size,
                n_parents=self.n_parents,
                n_generations=self.n_generations,
                seed=self.seed,
            ),
            seed=self.seed,
        )

    @classmethod
    def from_dict(cls, d: Dict) -> "CampaignSpec":
        d = dict(d)
        d.pop("hierarchical", None)   # an explicit false is still valid
        if "objectives" in d:
            d["objectives"] = tuple(d["objectives"])
        return cls(**d)


def _validate_sizes(spec) -> None:
    """Shared size/objective sanity checks for campaign-like specs."""
    from .store import LABEL_KEYS

    for name in ("n_train", "n_qor_samples", "pop_size", "n_parents"):
        v = getattr(spec, name)
        if not isinstance(v, int) or v <= 0:
            raise ValueError(f"{name} must be a positive integer, got {v!r}")
    if not isinstance(spec.n_generations, int) or spec.n_generations < 0:
        raise ValueError(
            f"n_generations must be a non-negative integer, "
            f"got {spec.n_generations!r}"
        )
    if spec.n_parents > spec.pop_size:
        raise ValueError(
            f"n_parents ({spec.n_parents}) cannot exceed pop_size "
            f"({spec.pop_size})"
        )
    objs = tuple(spec.objectives)
    if not objs:
        raise ValueError("objectives cannot be empty")
    unknown = sorted(set(objs) - set(LABEL_KEYS))
    if unknown:
        raise ValueError(
            f"unknown objectives {unknown}; known: {sorted(LABEL_KEYS)}"
        )


@dataclass(frozen=True)
class HierarchicalSpec:
    """A serializable hierarchical-search request: per-stage campaign
    budget + composition knobs over a staged pipeline accelerator
    (``POST /campaigns`` with ``{"hierarchical": true, ...}``)."""

    accel: str = "smoothed_dct"
    stages: Tuple[Dict, ...] = ()     # optional per-stage spec overrides
    pipeline: str = "D"
    qor_model: str = "random_forest"
    hw_model: str = "bayesian_ridge"
    strategy: str = "nsga2"           # explorer for every stage campaign
    objectives: Tuple[str, ...] = ("qor", "energy")
    n_train: int = 48
    n_qor_samples: int = 2
    rank_genes: bool = False
    warm_start: bool = True
    pop_size: int = 24
    n_parents: int = 12
    n_generations: int = 6
    seed: int = 0
    k_per_stage: Optional[int] = 12
    max_candidates: int = 64

    def validate(self) -> None:
        _validate_sizes(self)
        if self.max_candidates <= 0:
            raise ValueError("max_candidates must be positive")
        if self.k_per_stage is not None and self.k_per_stage <= 0:
            raise ValueError("k_per_stage must be positive or null")
        accel = make_accelerator(self.accel)
        if not hasattr(accel, "stage_views"):
            raise ValueError(
                f"{self.accel!r} is not a staged pipeline (hierarchical "
                f"search needs stages)"
            )
        n_stages = len(accel.stages)
        if self.stages and len(self.stages) != n_stages:
            raise ValueError(
                f"stages has {len(self.stages)} override entries; "
                f"{self.accel!r} has {n_stages} stages"
            )
        # validate the overridden per-stage specs too, so a bad override
        # is a 400 at submit, not an async failure in the hier worker
        cfg = self.hier_config()
        for i in range(n_stages):
            try:
                spec = cfg.stage_spec(
                    f"{self.accel}/stage{i}",
                    self.stages[i] if self.stages else None,
                )
            except TypeError as exc:
                raise ValueError(f"bad stage {i} override: {exc}") from exc
            try:
                spec.validate()
            except ValueError as exc:
                raise ValueError(f"bad stage {i} spec: {exc}") from exc

    def hier_config(self):
        # field-name intersection, so a knob added to both dataclasses
        # flows through without a hand-maintained copy list
        import dataclasses

        from ..hierarchy.search import HierarchicalConfig

        names = {f.name for f in dataclasses.fields(HierarchicalConfig)}
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name in names}
        d["objectives"] = tuple(self.objectives)
        return HierarchicalConfig(**d)

    @classmethod
    def from_dict(cls, d: Dict) -> "HierarchicalSpec":
        d = dict(d)
        d.pop("hierarchical", None)
        if "objectives" in d:
            d["objectives"] = tuple(d["objectives"])
        if "stages" in d:
            stages = d["stages"]
            if not isinstance(stages, (list, tuple)) or not all(
                isinstance(s, dict) for s in stages
            ):
                raise ValueError("stages must be a list of override objects")
            d["stages"] = tuple(dict(s) for s in stages)
        return cls(**d)


class SurrogateRegistry:
    """Fitted surrogates kept warm across campaigns."""

    def __init__(self, max_models: int = 64):
        self._lock = threading.Lock()
        self._models: Dict[Tuple, Dict] = {}   # key -> {digest, model, ...}
        self._data: Dict[Tuple, Dict[bytes, Tuple]] = {}  # key -> row pool
        # service is long-lived: bound retention (dict order = insertion
        # order, so eviction drops the oldest key and its row pool)
        self.max_models = int(max_models)
        self.fits = 0
        self.refits = 0
        self.reuse_hits = 0

    def _store_model(self, key: Tuple, ent: Dict) -> None:
        """Insert under the lock, evicting the oldest beyond max_models."""
        self._models.pop(key, None)  # re-insert moves key to newest
        self._models[key] = ent
        while len(self._models) > self.max_models:
            oldest = next(iter(self._models))
            del self._models[oldest]
            self._data.pop(oldest, None)

    @staticmethod
    def _digest(X: np.ndarray, y: np.ndarray) -> str:
        h = hashlib.sha256(np.ascontiguousarray(X).tobytes())
        h.update(np.ascontiguousarray(y).tobytes())
        return h.hexdigest()[:24]

    def provider(self, ctx_fp: str, spec: CampaignSpec):
        """A ``surrogate_provider(obj, model_name, X, y)`` for run_dse,
        bound to one evaluation context + campaign settings."""
        mode = spec.warm_surrogates

        def provide(obj: str, model_name: str, X: np.ndarray, y: np.ndarray):
            if mode == "off":
                with self._lock:
                    self.fits += 1
                return make(model_name, seed=spec.seed).fit(X, y)
            key = (ctx_fp, spec.pipeline, obj, model_name, spec.seed)
            digest = self._digest(X, y)
            with self._lock:
                ent = self._models.get(key)
                if ent is not None and ent["digest"] == digest:
                    self.reuse_hits += 1
                    self._store_model(key, ent)  # refresh LRU recency
                    return ent["model"]
            if mode == "accumulate":
                with self._lock:
                    pool = self._data.setdefault(key, {})
                    for xi, yi in zip(X, y):
                        # key rows by (x, y) so distinct genomes mapping
                        # to one feature vector but different ground
                        # truth both survive instead of last-write-wins
                        rk = (np.ascontiguousarray(xi).tobytes(),
                              float(yi).hex())
                        pool[rk] = (xi, yi)
                    rows = list(pool.values())
                Xa = np.stack([r[0] for r in rows])
                ya = np.array([r[1] for r in rows])
                model = make(model_name, seed=spec.seed).fit(Xa, ya)
                with self._lock:
                    refit = key in self._models
                    self.refits += int(refit)
                    self.fits += int(not refit)
                    self._store_model(key, {"digest": digest, "model": model,
                                            "rows": len(rows)})
                return model
            # mode == "reuse": fit on exactly this data, cache by digest
            model = make(model_name, seed=spec.seed).fit(X, y)
            with self._lock:
                self.fits += 1
                self._store_model(key, {"digest": digest, "model": model,
                                        "rows": len(X)})
            return model

        return provide

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "models": len(self._models),
                "fits": self.fits,
                "refits": self.refits,
                "reuse_hits": self.reuse_hits,
            }


@dataclass
class _Campaign:
    id: str
    spec: object                     # CampaignSpec | HierarchicalSpec
    kind: str = "dse"                # dse | hierarchical
    state: str = "queued"            # queued | running | done | failed | cancelled
    submitted_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    error: Optional[str] = None
    result: Optional[DSEResult] = None
    done_evt: threading.Event = field(default_factory=threading.Event)
    # cooperative-stepping machinery (kind == "dse" only)
    driver: Optional[object] = None          # core.strategies.Campaign
    ctx: Optional[EvalContext] = None
    inbox: Optional[Tuple] = None            # (LabelRequest, labels) to deliver
    restore_state: Optional[Dict] = None     # snapshot to install on build
    cancel_requested: bool = False
    steps: int = 0


class _CompactResult:
    """What remains of a campaign result after retention compaction: the
    Pareto front and summary stats; the heavy train/search arrays
    (train genomes/labels, full NSGA-II population, stage fronts and
    candidate labels for hierarchical jobs) are dropped."""

    def __init__(self, res):
        self.accel_name = res.accel_name
        self.config = res.config
        self.val_pcc = res.val_pcc
        self.timings = res.timings
        self.front_genomes = np.array(res.front_genomes)
        self.front_objectives = np.array(res.front_objectives)
        self.true_objectives = self.front_objectives
        self.front_mask = np.ones(len(self.front_genomes), dtype=bool)
        self.n_designs = int(len(res.true_objectives))
        # hierarchical summary fields (status() reads them off the result)
        for attr in ("stage_campaign_ids", "ground_truth_calls",
                     "flat_space_size", "max_concurrent_stages"):
            if hasattr(res, attr):
                setattr(self, attr, getattr(res, attr))


class CampaignManager:
    """Owns the store, the scheduler, the surrogate registry and a pool
    of campaign-runner threads.  The HTTP front end (``api.py``) is a
    thin shell over this object; tests drive it in-process."""

    def __init__(
        self,
        store: Optional[LabelStore] = None,
        *,
        scheduler: Optional[EvalScheduler] = None,
        eval_workers: int = 2,
        eval_backend: str = "thread",
        process_workers: Optional[int] = None,
        chunk_size: Optional[int] = None,
        fleet_fallback: str = "thread",
        lease_ttl_s: float = 30.0,
        heartbeat_ttl_s: float = 15.0,
        fleet_chunk: Optional[int] = None,
        campaign_workers: int = 2,
        hier_workers: int = 1,
        max_batch: int = 32,
        max_wait_s: float = 0.02,
        keep_results: int = 128,
        keep_campaigns: int = 2048,
        snapshot_every: int = 1,
        snapshot_path: Optional[str] = None,
        synth_cache: Optional[object] = None,
        serving: Optional[Dict] = None,
        device=None,
        hw: Hardware = H100_SXM,
    ):
        # every EvalContext this manager builds labels on ``device``
        # (None: "cuda") with the cost model ``hw``
        self.device = device
        self.hw = hw
        self.store = store if store is not None else InMemoryLabelStore()
        # persistent structural compile cache (core.features.synth): a
        # path opens the segmented synthesis cache shared by every
        # campaign AND (by path) every process-pool labeler worker; a
        # SynthCache object is used as-is; None keeps the
        # process-default in-memory sharing
        self._owns_synth_cache = isinstance(synth_cache, str)
        if self._owns_synth_cache:
            from ..core.features.synth import open_synth_cache

            self.synth_cache = open_synth_cache(synth_cache, migrate=True)
        else:
            self.synth_cache = synth_cache
        self.scheduler = scheduler or EvalScheduler(
            self.store, n_workers=eval_workers,
            max_batch=max_batch, max_wait_s=max_wait_s,
            backend=eval_backend, process_workers=process_workers,
            chunk_size=chunk_size,
            fleet_fallback=fleet_fallback,
            lease_ttl_s=lease_ttl_s, heartbeat_ttl_s=heartbeat_ttl_s,
            fleet_chunk=fleet_chunk,
            synth_cache_path=getattr(self.synth_cache, "path", None),
            device=device,
        )
        self.registry = SurrogateRegistry()
        # per-campaign search telemetry, sampled at tick boundaries and
        # served by GET /campaigns/<id>/timeline
        self.timeline = obs.Timeline()
        # campaign workers STEP campaigns cooperatively: one executor
        # task is one tick (a label request, one strategy round, or one
        # label delivery), so N campaigns multiplex over few threads and
        # a campaign waiting on ground truth holds no thread at all
        self._pool = ThreadPoolExecutor(
            campaign_workers, thread_name_prefix="campaign"
        )
        # hierarchical jobs wait on campaigns they submit to _pool, so
        # they get their own (small) pool to rule out self-deadlock
        self._hier_pool = ThreadPoolExecutor(
            max(1, hier_workers), thread_name_prefix="hier"
        )
        self._lock = threading.Lock()
        self._campaigns: Dict[str, _Campaign] = {}
        self._seq = 0
        # the service is long-lived: beyond the newest keep_results
        # finished campaigns, results are compacted to their fronts;
        # beyond keep_campaigns, records are dropped entirely
        self.keep_results = int(keep_results)
        self.keep_campaigns = int(keep_campaigns)
        # snapshots: latest per-campaign state at tick boundaries, for
        # POST /campaigns/<id>/resume.  In-memory always; with
        # snapshot_path also appended as JSON lines (last record per id
        # wins on replay), so a campaign killed WITH its process can be
        # resumed by a fresh manager pointed at the same file
        self.snapshot_every = max(1, int(snapshot_every))
        self.snapshot_path = snapshot_path
        self._snapshots: Dict[str, Dict] = {}
        self._snap_lock = threading.Lock()
        self._snap_fh = None
        self._snap_lines = 0
        if snapshot_path:
            self._replay_snapshots(snapshot_path)
        # serving tier: front-update listeners (ServingEngine.attach /
        # ServingHub) fire whenever a campaign completes, so an engine
        # serving an accelerator hot-swaps in the improved front; the
        # hub itself is created lazily on first POST /serve
        self._front_listeners: List = []
        self._serving = None
        self._serving_kw = dict(serving or {})
        self._serving_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _admit(self, spec, kind: str) -> _Campaign:
        """Validate, record and return a new campaign (raises ValueError
        on a bad spec BEFORE any worker thread is involved)."""
        spec.validate()
        # pick up labels other processes appended to a shared store file
        if hasattr(self.store, "refresh"):
            self.store.refresh()
        with self._lock:
            self._seq += 1
            cid = f"c{self._seq:04d}-{uuid.uuid4().hex[:6]}"
            c = _Campaign(id=cid, spec=spec, kind=kind)
            self._campaigns[cid] = c
        return c

    def submit(self, spec: CampaignSpec) -> str:
        c = self._admit(spec, "dse")
        _log.info("campaign %s submitted: accel=%s strategy=%s",
                  c.id, spec.accel, spec.strategy)
        self._enqueue(c)
        return c.id

    def submit_hierarchical(self, spec: HierarchicalSpec) -> str:
        """Run a hierarchical search as a service job.  The job itself
        occupies a dedicated small pool — its per-stage campaigns go
        through the regular campaign pool, so a hierarchical job can
        never deadlock waiting on workers it is itself occupying."""
        c = self._admit(spec, "hierarchical")
        self._hier_pool.submit(self._run_hier, c)
        return c.id

    # ------------------------------------------------------------------
    # cooperative stepping: one executor task == one campaign tick
    # ------------------------------------------------------------------
    def _enqueue(self, c: _Campaign) -> None:
        self._pool.submit(self._step, c)

    def _build_driver(self, c: _Campaign) -> None:
        from ..core.acl.library import default_library
        from ..core.strategies.campaign import Campaign as DseCampaign

        spec = c.spec
        accel = make_accelerator(spec.accel, device=self.device)
        library = default_library()
        c.ctx = EvalContext(
            accel, library,
            rank_genes=spec.rank_genes,
            n_qor_samples=spec.n_qor_samples,
            synth_cache=self.synth_cache,
            device=self.device, hw=self.hw,
        )
        provider = self.registry.provider(c.ctx.fingerprint, spec)
        c.driver = DseCampaign(
            accel, library, spec.dse_config(), surrogate_provider=provider,
        )
        if c.restore_state is not None:
            c.driver.restore(c.restore_state)
            c.restore_state = None

    def _step(self, c: _Campaign) -> None:
        """One cooperative tick.  Re-enqueues itself while runnable;
        parks (holding NO thread) while labels are in flight — the
        gather callback re-enqueues on delivery.

        The tick runs under the campaign's trace context (trace id ==
        campaign id), so every span it causes — strategy rounds, label
        batches, synth compiles — correlates back to the
        campaign in the exported trace."""
        try:
            with obs.context(campaign=c.id, trace_id=c.id), \
                    obs.span("campaign.tick", step=c.steps,
                             kind=c.kind) as sp:
                self._tick(c, sp)
        except Exception as exc:  # noqa: BLE001 - campaign isolation
            self._fail(c, exc)

    def _tick(self, c: _Campaign, sp) -> None:
        _log.debug("tick %d state=%s", c.steps, c.state)
        if c.state == "queued":
            c.state = "running"
            if c.started_at is None:
                c.started_at = time.time()
        if c.cancel_requested:
            self._save_snapshot(c)
            c.state = "cancelled"
            c.finished_at = time.time()
            sp.set(action="cancel")
            _log.info("campaign %s cancelled at tick %d", c.id, c.steps)
            c.done_evt.set()
            return
        if c.driver is None:
            self._build_driver(c)
        if c.inbox is not None:
            req, labels = c.inbox
            c.inbox = None
            sp.set(action="deliver", stage=req.stage)
            c.driver.deliver(req, labels)
            self._save_snapshot(c)
        elif not c.driver.done:
            req = c.driver.step()
            if req is not None:
                sp.set(action="request", stage=req.stage,
                       n=int(len(req.genomes)))
                self._sample_timeline(c)
                self._dispatch_labels(c, req)
                return
            sp.set(action="round")
            c.steps += 1
            if c.steps % self.snapshot_every == 0:
                self._save_snapshot(c)
        self._sample_timeline(c)
        if c.driver.done:
            c.result = c.driver.result()
            c.state = "done"
            self._drop_snapshot(c.id)
            c.finished_at = time.time()
            sp.set(done=True)
            _log.info("campaign %s done: %d ticks in %.1fs", c.id,
                      c.steps, c.finished_at - (c.started_at or c.finished_at))
            c.done_evt.set()
            self._evict()
            self._notify_front(c.spec.accel)
        else:
            self._enqueue(c)

    def _sample_timeline(self, c: _Campaign) -> None:
        """One search-telemetry sample at a tick boundary.  Best-effort
        by design: telemetry must never fail a campaign."""
        d = c.driver
        if d is None:
            return
        try:
            fields: Dict = {}
            prog = d.progress()
            fields["stage"] = prog.get("stage")
            fields["labels_requested"] = prog.get("labels_requested", 0)
            if "generation" in prog:
                fields["generation"] = prog["generation"]
            sched = self.scheduler.campaign_stats(c.id)
            if sched:
                fields["labels_served"] = sched.get("labeled", 0)
                fields["store_hits"] = sched.get("store_hits", 0)
                req = sched.get("requests", 0)
                hits = (sched.get("store_hits", 0)
                        + sched.get("inflight_hits", 0))
                fields["label_reuse_rate"] = (hits / req) if req else 0.0
            front = (d.front_estimate()
                     if hasattr(d, "front_estimate") else None)
            self.timeline.sample(c.id, objectives=front, **fields)
        except Exception:  # noqa: BLE001 - telemetry is best-effort
            pass

    def _dispatch_labels(self, c: _Campaign, req) -> None:
        """Fan the request out through the scheduler and park the
        campaign; the last-resolved future re-enqueues it."""
        from .scheduler import gather_futures

        futures = self.scheduler.submit(c.ctx, req.genomes, campaign=c.id)

        def _delivered(recs, exc):
            # runs as a Future done-callback, where raised exceptions are
            # swallowed — every failure must route through _fail or the
            # campaign would park in "running" forever
            try:
                if exc is not None:
                    self._fail(c, exc)
                    return
                labels = {
                    k: np.array([float(r[k]) for r in recs])
                    for k in LABEL_KEYS
                }
                c.inbox = (req, labels)
                self._enqueue(c)
            except Exception as cb_exc:  # noqa: BLE001 - campaign isolation
                self._fail(c, cb_exc)

        gather_futures(futures, _delivered)

    def _fail(self, c: _Campaign, exc: BaseException) -> None:
        c.state = "failed"
        c.error = f"{type(exc).__name__}: {exc}"
        _log.warning("campaign %s failed: %s", c.id, c.error)
        c.finished_at = time.time()
        c.done_evt.set()
        self._evict()

    # ------------------------------------------------------------------
    # cancel / resume
    # ------------------------------------------------------------------
    def cancel(self, cid: str) -> None:
        """Request cancellation; takes effect at the campaign's next
        tick boundary (its snapshot is kept for ``resume``)."""
        c = self._get(cid)
        if c.kind != "dse":
            raise RuntimeError(
                f"campaign {cid} is {c.kind}; only dse campaigns cancel "
                f"(cancel its stage campaigns instead)"
            )
        if c.state in ("done", "failed", "cancelled"):
            raise RuntimeError(f"campaign {cid} already {c.state}")
        c.cancel_requested = True

    def resume(self, cid: str) -> str:
        """Continue a cancelled/failed campaign from its latest snapshot
        (same id).  Unknown ids are looked up in the persistent snapshot
        file, so a campaign killed with its process resumes on a fresh
        manager pointed at the same ``snapshot_path``.  Ground truth the
        campaign re-requests is answered by the label store, so the
        replayed portion is cheap."""
        with self._lock:
            c = self._campaigns.get(cid)
            snap = self._snapshots.get(cid)
        if c is None:
            if snap is None:
                raise KeyError(cid)
            spec = CampaignSpec.from_dict(snap["spec"])
            with self._lock:
                c = _Campaign(id=cid, spec=spec, kind="dse")
                self._campaigns[cid] = c
        else:
            if c.kind != "dse":
                raise RuntimeError(f"campaign {cid} is {c.kind}; "
                                   f"only dse campaigns resume")
            if c.state not in ("cancelled", "failed"):
                raise RuntimeError(
                    f"campaign {cid} is {c.state}; only cancelled/failed "
                    f"campaigns resume"
                )
        c.state = "queued"
        c.error = None
        c.finished_at = None
        c.cancel_requested = False
        c.inbox = None
        c.driver = None          # rebuilt from the snapshot on next tick
        c.restore_state = snap["campaign"] if snap is not None else None
        c.done_evt = threading.Event()
        self._enqueue(c)
        return cid

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------
    def _append_snap(self, rec: Dict) -> None:
        """Append one snapshot record (called under _snap_lock).  Every
        tick appends the FULL campaign state, so the log is rewritten
        down to one line per live campaign whenever it holds >4x as many
        lines as ids (the JsonlLabelStore compaction idiom) — without
        this, snapshot files would grow quadratically per campaign and
        accumulate across service runs forever."""
        import json
        import os

        if self._snap_fh is None:
            d = os.path.dirname(os.path.abspath(self.snapshot_path))
            os.makedirs(d, exist_ok=True)
            self._snap_fh = open(self.snapshot_path, "a")
        self._snap_fh.write(json.dumps(rec, default=float) + "\n")
        self._snap_fh.flush()
        self._snap_lines += 1
        if self._snap_lines > max(16, 4 * len(self._snapshots)):
            self._snap_fh.close()
            tmp = self.snapshot_path + ".compact.tmp"
            with open(tmp, "w") as f:
                for snap in self._snapshots.values():
                    f.write(json.dumps(snap, default=float) + "\n")
            os.replace(tmp, self.snapshot_path)
            self._snap_fh = open(self.snapshot_path, "a")
            self._snap_lines = len(self._snapshots)

    def _save_snapshot(self, c: _Campaign) -> None:
        if c.driver is None or c.driver.done:
            return
        snap = {
            "id": c.id,
            "kind": c.kind,
            "t": time.time(),
            "spec": {**asdict(c.spec),
                     "objectives": list(c.spec.objectives)},
            "campaign": c.driver.state(),
        }
        with self._snap_lock:
            self._snapshots[c.id] = snap
            if self.snapshot_path:
                self._append_snap(snap)

    def _drop_snapshot(self, cid: str) -> None:
        with self._snap_lock:
            dropped = self._snapshots.pop(cid, None) is not None
            if dropped and self.snapshot_path:
                # tombstone so a later replay does not resurrect a
                # finished campaign as resumable
                self._append_snap({"id": cid, "done": True})

    def _replay_snapshots(self, path: str) -> None:
        import json
        import os

        if not os.path.exists(path):
            return
        with open(path) as f:
            for line in f:
                if not line.endswith("\n"):
                    break              # torn tail from a killed writer
                self._snap_lines += 1
                try:
                    snap = json.loads(line)
                    if snap.get("done"):
                        self._snapshots.pop(snap["id"], None)
                    else:
                        self._snapshots[snap["id"]] = snap   # last wins
                except (json.JSONDecodeError, KeyError):
                    continue

    def snapshot_ids(self) -> List[str]:
        """Campaign ids with a resumable snapshot."""
        with self._snap_lock:
            return sorted(self._snapshots)

    def _run_hier(self, c: _Campaign) -> None:
        c.state = "running"
        c.started_at = time.time()
        try:
            from ..hierarchy.search import run_hierarchical

            spec = c.spec
            pipeline = make_accelerator(spec.accel)
            # the job span covers the whole hierarchical run; its stage
            # campaigns tick under their OWN trace ids (one trace per
            # campaign), linked back here by the parent attribute
            with obs.context(campaign=c.id, trace_id=c.id), \
                    obs.span("campaign.hier", accel=spec.accel):
                c.result = run_hierarchical(
                    pipeline, cfg=spec.hier_config(), manager=self,
                    stage_overrides=spec.stages or None,
                )
            c.state = "done"
        except Exception as exc:  # noqa: BLE001 - campaign isolation
            c.state = "failed"
            c.error = f"{type(exc).__name__}: {exc}"
        finally:
            c.finished_at = time.time()
            c.done_evt.set()
            self._evict()
            if c.state == "done":
                self._notify_front(c.spec.accel)

    def _evict(self) -> None:
        """Bound retention: compact old finished campaigns to their
        fronts, drop the very oldest records (and their scheduler
        accounting) entirely."""
        dropped = []
        with self._lock:
            finished = sorted(
                (c for c in self._campaigns.values()
                 if c.state in ("done", "failed") and c.finished_at),
                key=lambda c: c.finished_at,
            )
            n_drop = max(0, len(finished) - self.keep_campaigns)
            for c in finished[:n_drop]:
                del self._campaigns[c.id]
                dropped.append(c.id)
            for c in finished[n_drop:max(0, len(finished)
                                         - self.keep_results)]:
                if c.result is not None and not isinstance(c.result,
                                                           _CompactResult):
                    c.result = _CompactResult(c.result)
        for cid in dropped:
            self.scheduler.forget_campaign(cid)
            self.timeline.forget(cid)

    # ------------------------------------------------------------------
    def _get(self, cid: str) -> _Campaign:
        with self._lock:
            if cid not in self._campaigns:
                raise KeyError(cid)
            return self._campaigns[cid]

    def wait(self, cid: str, timeout: Optional[float] = None) -> str:
        c = self._get(cid)
        c.done_evt.wait(timeout)
        return c.state

    def status(self, cid: str) -> Dict:
        c = self._get(cid)
        out = {
            "id": c.id,
            "state": c.state,
            "kind": c.kind,
            "spec": {**asdict(c.spec),
                     "objectives": list(c.spec.objectives)},
            "submitted_at": c.submitted_at,
            "started_at": c.started_at,
            "finished_at": c.finished_at,
            "error": c.error,
        }
        # live progress from the stepped campaign state machine (stage,
        # strategy, generation, labels requested) — not just queued/done
        if c.driver is not None and c.result is None:
            try:
                out["progress"] = c.driver.progress()
            except Exception:  # noqa: BLE001 - progress is best-effort
                pass
        sched = self.scheduler.campaign_stats(c.id)
        if sched:
            out["labeling"] = sched
        if c.result is not None:
            # _run sets c.result before the finally that stamps
            # finished_at, so a concurrent poll can land between the two
            fin = c.finished_at
            out["wall_s"] = (fin if fin is not None
                             else time.time()) - c.started_at
            out["val_pcc"] = c.result.val_pcc
            out["timings"] = c.result.timings
            out["front_size"] = int(c.result.front_mask.sum())
            if c.kind == "hierarchical":
                out["stage_campaigns"] = list(c.result.stage_campaign_ids)
                out["ground_truth_calls"] = dict(c.result.ground_truth_calls)
                out["flat_space_size"] = float(c.result.flat_space_size)
                out["max_concurrent_stages"] = int(
                    c.result.max_concurrent_stages)
        return out

    def campaign_timeline(self, cid: str) -> Dict:
        """Per-tick search telemetry series for one campaign (backs
        ``GET /campaigns/<id>/timeline``): hypervolume against the
        frozen per-campaign reference, front size, labels requested/
        served, store reuse rate, stage progress."""
        c = self._get(cid)
        out = {
            "id": cid,
            "state": c.state,
            "samples": self.timeline.series(cid),
        }
        ref = self.timeline.reference(cid)
        if ref is not None:
            out["hv_reference"] = ref
        return out

    def list_campaigns(self) -> List[Dict]:
        with self._lock:
            return [{"id": c.id, "state": c.state, "kind": c.kind,
                     "accel": c.spec.accel,
                     "strategy": getattr(c.spec, "strategy", None)}
                    for c in self._campaigns.values()]

    def result(self, cid: str) -> DSEResult:
        c = self._get(cid)
        if c.state == "failed":
            raise RuntimeError(f"campaign {cid} failed: {c.error}")
        if c.result is None:
            raise RuntimeError(f"campaign {cid} not finished (state={c.state})")
        return c.result

    def front(self, cid: str) -> Dict:
        """The campaign's true Pareto front as JSON-ready lists."""
        res = self.result(cid)
        return {
            "id": cid,
            "accel": res.accel_name,
            "objectives": list(res.config.objectives),
            "genomes": res.front_genomes.tolist(),
            "front": res.front_objectives.tolist(),
        }

    def global_front(self, accel: str,
                     objectives: Tuple[str, ...] = ("qor", "energy")) -> Dict:
        """Merged non-dominated front over every completed campaign for
        one accelerator (the service's cumulative Pareto knowledge)."""
        genomes: List[np.ndarray] = []
        objs: List[np.ndarray] = []
        sources: List[str] = []
        with self._lock:
            done = [c for c in self._campaigns.values()
                    if c.state == "done" and c.result is not None
                    and c.spec.accel == accel
                    and tuple(c.spec.objectives) == tuple(objectives)]
            # labels are only comparable within one evaluation context
            # (rank_genes changes genome width, n_qor_samples changes
            # qor values): merge the most recent campaign's context only
            if done:
                latest = max(done, key=lambda c: c.finished_at or 0.0)
                ctx = (latest.spec.rank_genes, latest.spec.n_qor_samples)
                done = [
                    c for c in done
                    if (c.spec.rank_genes, c.spec.n_qor_samples) == ctx
                ]
        for c in done:
            genomes.append(c.result.front_genomes)
            objs.append(c.result.front_objectives)
            sources += [c.id] * len(c.result.front_genomes)
        if not genomes:
            return {"accel": accel, "objectives": list(objectives),
                    "genomes": [], "front": [], "campaigns": []}
        G = np.concatenate(genomes)
        O = np.concatenate(objs)
        # dedupe identical genomes, then keep the non-dominated set
        _, uniq = np.unique(G, axis=0, return_index=True)
        G, O = G[uniq], O[uniq]
        src = [sources[i] for i in uniq]
        mask = non_dominated_mask(O)
        return {
            "accel": accel,
            "objectives": list(objectives),
            "genomes": G[mask].tolist(),
            "front": O[mask].tolist(),
            "campaigns": sorted({s for s, m in zip(src, mask) if m}),
        }

    # ------------------------------------------------------------------
    # serving tier
    # ------------------------------------------------------------------
    def subscribe_front(self, callback) -> None:
        """Register ``callback(accel_name)`` to fire after a campaign
        completes successfully — the serving tier's hot-swap signal."""
        with self._lock:
            self._front_listeners.append(callback)

    def _notify_front(self, accel: str) -> None:
        """Fire front listeners OUTSIDE the manager lock (a listener
        rebuilds a catalog via global_front, which takes it).  Listener
        failures never fail the campaign that triggered them."""
        with self._lock:
            listeners = list(self._front_listeners)
        for cb in listeners:
            try:
                cb(accel)
            except Exception:  # noqa: BLE001 - campaign isolation
                _log.exception("front listener failed for %s", accel)

    @property
    def serving(self):
        """The lazily-created ServingHub (one engine per accelerator)
        behind POST /serve; its engines run on the manager's device.
        Uses a dedicated lock: a serving request arriving while a
        campaign ticks must not contend on _lock."""
        with self._serving_lock:
            if self._serving is None:
                from ..serving import ServingHub

                kw = {"device": self.device, **self._serving_kw}
                self._serving = ServingHub(self, **kw)
            return self._serving

    def serving_stats(self) -> Dict:
        """GET /serving/stats without forcing the hub into existence."""
        with self._serving_lock:
            hub = self._serving
        return hub.stats() if hub is not None else {"engines": {}}

    def stats(self) -> Dict:
        """The service's whole labeling economy in one JSON blob: label-
        store hits, in-flight dedup hits, coalesced batches (scheduler);
        per-backend labeler counters incl. the process pool's aggregated
        worker synthesis, engine and launch counters and the fleet's
        (scheduler.labeler, scheduler.fleet); synth-cache hit rate and
        verification state (synth); population engine counters for THIS
        process (sim.fused — worker-process counters ride the labeler
        stats); the serving engines, once the hub exists."""
        from ..accel import fused
        from ..core.features import synth as synth_mod

        with self._lock:
            by_state: Dict[str, int] = {}
            for c in self._campaigns.values():
                by_state[c.state] = by_state.get(c.state, 0) + 1
        cache = (self.synth_cache if self.synth_cache is not None
                 else synth_mod.shared_synth_cache())
        out = {
            "campaigns": by_state,
            "scheduler": self.scheduler.stats(),
            "surrogates": self.registry.stats(),
            "synth": {
                "structural_keys": synth_mod.STRUCTURAL_KEYS,
                "persistent": hasattr(cache, "path"),
                "cache": cache.stats(),
            },
            "sim": {
                "fused": fused.stats(),
            },
            "obs": {
                "tracing": obs.enabled(),
                "recorder": obs.recorder().stats(),
                "timeline_campaigns": len(self.timeline.campaigns()),
            },
        }
        with self._serving_lock:
            hub = self._serving
        if hub is not None:
            out["serving"] = hub.stats()
        return out

    def health(self) -> Dict:
        """Readiness/liveness in one JSON blob (``GET /health``): is
        the label store writable, is the scheduler's batcher thread
        alive, how many fleet workers are live (fleet backend only),
        which serving engines are up, and whether a fault plan is
        armed.  ``ok`` is the AND of the store and scheduler checks —
        an empty fleet or an idle serving hub is degraded, not dead."""
        from .. import faults

        store_h = self.store.health()
        sched_alive = self.scheduler._batcher.is_alive()
        out = {
            "store": store_h,
            "scheduler": {
                "alive": sched_alive,
                "backend": self.scheduler.backend,
            },
            "faults": faults.stats(),
        }
        fleet = getattr(self.scheduler, "fleet", None)
        if fleet is not None:
            fs = fleet.stats()
            out["fleet"] = {
                "registered": fs["registered"],
                "live": fs["live"],
                "leases_in_flight": fs["leases_in_flight"],
                "pending_chunks": fs["pending_chunks"],
            }
        with self._serving_lock:
            hub = self._serving
        if hub is not None:
            engines = {}
            with hub._lock:
                for name, eng in hub._engines.items():
                    engines[name] = {
                        "alive": eng._thread.is_alive(),
                        "queue_depth": len(eng._queue),
                    }
            out["serving"] = {"engines": engines}
        out["ok"] = bool(store_h.get("writable")) and sched_alive
        return out

    def shutdown(self, *, wait: bool = True) -> None:
        with self._serving_lock:
            hub, self._serving = self._serving, None
        if hub is not None:
            hub.close()
        self._hier_pool.shutdown(wait=wait)
        self._pool.shutdown(wait=wait)
        self.scheduler.shutdown(wait=wait)
        if self._owns_synth_cache and self.synth_cache is not None:
            self.synth_cache.close()
        with self._snap_lock:
            if self._snap_fh is not None:
                self._snap_fh.close()
                self._snap_fh = None
