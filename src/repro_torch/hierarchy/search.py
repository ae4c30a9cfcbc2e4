"""Hierarchical multi-stage search over a ``StagedPipeline``.

The paper's scalability strategy (§V), on top of the in-process
campaign service (``repro_torch.service``):

  1. **Per-stage campaigns** — one full three-stage DSE per pipeline
     stage, submitted concurrently through a ``CampaignManager``
     (shared label store, coalesced evaluation batches).  Each stage's
     QoR is measured in situ with every other stage exact
     (``StageView``); its hardware labels are the stage's own deployment.
  2. **Composition** — the surviving per-stage fronts are composed with
     incremental non-dominated pruning (compose.py); the flat product
     space is never enumerated.
  3. **End-to-end verification** — only the composed candidates are
     re-labeled through the chained behavioral simulation + chained
     rank-k deployment (the ``run_dse`` stage-3 analogue), yielding the
     verified application-level front.

Every label of all three steps runs on the manager's device with its
cost model (``CampaignManager(device=..., hw=...)``).

``HierarchicalResult`` carries per-stage timings, composition stats and
ground-truth-call counts against the flat-equivalent space size.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.acl.library import Library, default_library
from ..core.dse import _objective_matrix, label_unique
from ..core.hw import H100_SXM, Hardware
from ..core.pareto import non_dominated_mask
from ..service.campaigns import (
    CampaignManager,
    CampaignSpec,
    register_accelerator,
)
from ..service.store import EvalContext
from .compose import ComposeStats, StageFront, compose_fronts
from .staged import StagedPipeline

__all__ = ["HierarchicalConfig", "HierarchicalResult", "run_hierarchical"]


@dataclass(frozen=True)
class HierarchicalConfig:
    """Per-stage campaign budget + composition knobs."""

    # per-stage campaign (CampaignSpec fields)
    pipeline: str = "D"                   # feature pipeline, paper's winner
    qor_model: str = "random_forest"
    hw_model: str = "bayesian_ridge"
    strategy: str = "nsga2"               # explorer for every stage campaign
    objectives: Tuple[str, ...] = ("qor", "energy")
    n_train: int = 48
    n_qor_samples: int = 2
    rank_genes: bool = False
    warm_start: bool = True
    pop_size: int = 24
    n_parents: int = 12
    n_generations: int = 6
    seed: int = 0
    # composition
    k_per_stage: Optional[int] = 12       # per-stage front truncation
    max_candidates: int = 64              # end-to-end re-label budget
    stage_timeout_s: float = 3600.0       # per-stage campaign wait

    def stage_spec(self, accel_name: str, overrides: Optional[Dict] = None
                   ) -> CampaignSpec:
        d = dict(
            accel=accel_name,
            pipeline=self.pipeline,
            qor_model=self.qor_model,
            hw_model=self.hw_model,
            strategy=self.strategy,
            objectives=tuple(self.objectives),
            n_train=self.n_train,
            n_qor_samples=self.n_qor_samples,
            rank_genes=self.rank_genes,
            warm_start=self.warm_start,
            pop_size=self.pop_size,
            n_parents=self.n_parents,
            n_generations=self.n_generations,
            seed=self.seed,
        )
        d.update(overrides or {})
        return CampaignSpec(**d)


@dataclass
class HierarchicalResult:
    pipeline_name: str
    config: HierarchicalConfig
    # stage campaigns
    stage_campaign_ids: List[str]
    stage_fronts: List[StageFront]
    val_pcc: Dict[str, float]             # {"stage<i>/<obj>": pcc}
    # composition
    compose_stats: ComposeStats
    est_objectives: np.ndarray            # composed estimates (pre-dedup)
    # end-to-end verification
    candidate_genomes: np.ndarray         # unique pipeline genomes relabeled
    final_labels: Dict[str, np.ndarray]
    true_objectives: np.ndarray
    front_mask: np.ndarray
    # accounting
    timings: Dict[str, float] = field(default_factory=dict)
    ground_truth_calls: Dict[str, int] = field(default_factory=dict)
    flat_space_size: float = 0.0
    max_concurrent_stages: int = 0

    @property
    def accel_name(self) -> str:
        return self.pipeline_name

    @property
    def front_genomes(self) -> np.ndarray:
        return self.candidate_genomes[self.front_mask]

    @property
    def front_objectives(self) -> np.ndarray:
        return self.true_objectives[self.front_mask]


def _max_overlap(intervals: Sequence[Tuple[float, float]]) -> int:
    """Max number of intervals simultaneously open (campaign concurrency)."""
    events = []
    for a, b in intervals:
        if a is None or b is None:
            continue
        events.append((a, 1))
        events.append((b, -1))
    best = cur = 0
    for _, d in sorted(events):
        cur += d
        best = max(best, cur)
    return best


def run_hierarchical(
    pipeline: StagedPipeline,
    library: Optional[Library] = None,
    cfg: Optional[HierarchicalConfig] = None,
    *,
    manager: Optional[CampaignManager] = None,
    stage_overrides: Optional[Sequence[Dict]] = None,
    verbose: bool = False,
    device=None,
    hw: Optional[Hardware] = None,
) -> HierarchicalResult:
    """Hierarchical search: concurrent per-stage campaigns -> composed
    front -> end-to-end verification.  Uses the given ``manager`` (and
    its label store) or owns a temporary one.  The per-stage campaigns
    ride the manager's cooperative ask/tell stepping, so stages share
    the campaign worker pool with everything else the service runs (and
    ``cfg.strategy`` picks each stage's explorer).  An owned manager
    labels on ``device`` (default ``"cuda"``) with the cost model ``hw``
    (default the H100's); a given manager labels on its own, and
    ``device``/``hw`` must then be left unset."""
    cfg = cfg if cfg is not None else HierarchicalConfig()
    library = library or default_library()
    n_stages = len(pipeline.stages)
    overrides = list(stage_overrides or [])
    if overrides and len(overrides) != n_stages:
        raise ValueError(
            f"stage_overrides has {len(overrides)} entries for "
            f"{n_stages} stages"
        )

    # make the pipeline resolvable by name for the campaign workers.
    # The stage campaigns search whatever the name resolves to, so if the
    # name currently resolves to a DIFFERENT structure (e.g. the pipeline
    # was edited and re-run in a live process), re-register THIS object —
    # latest wins, and the campaigns stay consistent with the end-to-end
    # verification below
    from ..service.campaigns import make_accelerator

    try:
        resolved = make_accelerator(pipeline.name)
        same = (getattr(resolved, "label_fingerprint", lambda: None)()
                == pipeline.label_fingerprint())
    except ValueError:
        same = False
    if not same:
        register_accelerator(pipeline.name, lambda: pipeline)

    own_manager = manager is None
    if own_manager:
        manager = CampaignManager(
            eval_workers=2, campaign_workers=max(2, n_stages),
            device=device, hw=hw if hw is not None else H100_SXM,
        )
    elif device is not None or hw is not None:
        raise ValueError(
            "device and hw configure an owned manager; a given manager "
            "labels on its own (CampaignManager(device=..., hw=...))"
        )
    timings: Dict[str, float] = {}
    t_total = time.perf_counter()
    try:
        # ---- 1. one concurrent campaign per stage ------------------------
        t0 = time.perf_counter()
        cids = [
            manager.submit(cfg.stage_spec(
                f"{pipeline.name}/stage{i}",
                overrides[i] if overrides else None,
            ))
            for i in range(n_stages)
        ]
        for i, cid in enumerate(cids):
            state = manager.wait(cid, timeout=cfg.stage_timeout_s)
            if state == "failed":
                raise RuntimeError(
                    f"stage {i} campaign {cid} failed: "
                    f"{manager.status(cid).get('error')}"
                )
            if state != "done":
                raise RuntimeError(
                    f"stage {i} campaign {cid} still {state} after "
                    f"{cfg.stage_timeout_s:.0f}s (raise "
                    f"HierarchicalConfig.stage_timeout_s; the stage "
                    f"campaigns keep running on the manager and can be "
                    f"collected via their ids {cids})"
                )
        timings["stage_campaigns"] = time.perf_counter() - t0

        statuses = [manager.status(cid) for cid in cids]
        max_conc = _max_overlap(
            [(s["started_at"], s["finished_at"]) for s in statuses]
        )
        val_pcc: Dict[str, float] = {}
        fronts: List[StageFront] = []
        stage_labeled = 0
        for i, cid in enumerate(cids):
            res = manager.result(cid)
            timings[f"stage{i}"] = statuses[i]["wall_s"]
            for k, v in res.val_pcc.items():
                val_pcc[f"stage{i}/{k}"] = v
            fronts.append(StageFront(
                genomes=np.asarray(res.front_genomes),
                objectives=np.asarray(res.front_objectives),
            ))
            lab = manager.scheduler.campaign_stats(cid)
            stage_labeled += int(lab["labeled"]) if lab else 0
        if verbose:
            sizes = [len(f.genomes) for f in fronts]
            print(f"[hier:{pipeline.name}] stage fronts {sizes}, "
                  f"max {max_conc} campaigns in flight")

        # ---- 2. composition ----------------------------------------------
        t0 = time.perf_counter()
        qor_index = (cfg.objectives.index("qor")
                     if "qor" in cfg.objectives else None)
        comp = compose_fronts(
            fronts,
            qor_index=qor_index,
            k_per_stage=cfg.k_per_stage,
            max_survivors=cfg.max_candidates,
        )
        genomes = np.stack([
            pipeline.assemble_genome(
                [comp.stage_genomes[s][comp.indices[t, s]]
                 for s in range(n_stages)],
                rank_genes=cfg.rank_genes,
            )
            for t in range(len(comp.indices))
        ])
        # anchor with the exact reference design, dedupe before labeling
        exact = pipeline.exact_genome(library, rank_genes=cfg.rank_genes)
        genomes = np.unique(
            np.concatenate([genomes, exact[None, :]]), axis=0
        )
        timings["compose"] = time.perf_counter() - t0
        if verbose:
            print(f"[hier:{pipeline.name}] composed "
                  f"{comp.stats.pairs_evaluated} pairs of a "
                  f"{comp.stats.cross_product_size:.0f}-product -> "
                  f"{len(genomes)} candidates")

        # ---- 3. end-to-end verification ----------------------------------
        t0 = time.perf_counter()
        final_tag = f"{pipeline.name}/final-{cids[0]}"
        ctx = EvalContext(
            pipeline, library,
            rank_genes=cfg.rank_genes, n_qor_samples=cfg.n_qor_samples,
            synth_cache=getattr(manager, "synth_cache", None),
            device=manager.device, hw=manager.hw,
        )

        def labeler(g):
            return manager.scheduler.label(ctx, g, campaign=final_tag)

        final_labels = label_unique(labeler, genomes)
        timings["final_eval"] = time.perf_counter() - t0
        true_obj = _objective_matrix(final_labels, cfg.objectives)
        front_mask = non_dominated_mask(true_obj)

        final_stats = manager.scheduler.campaign_stats(final_tag)
        final_labeled = int(final_stats["labeled"]) if final_stats else 0
        # the tag is not a campaign id, so the manager's retention would
        # never reclaim its accounting — drop it now that it's been read
        manager.scheduler.forget_campaign(final_tag)
        flat_space = float(np.prod([
            float(s) for s in
            pipeline.gene_sizes(library, rank_genes=cfg.rank_genes)
        ]))
        timings["total"] = time.perf_counter() - t_total
        if verbose:
            print(f"[hier:{pipeline.name}] verified front "
                  f"{int(front_mask.sum())}/{len(genomes)}; ground truth "
                  f"{stage_labeled}+{final_labeled} calls vs flat space "
                  f"{flat_space:.2e}")

        return HierarchicalResult(
            pipeline_name=pipeline.name,
            config=cfg,
            stage_campaign_ids=cids,
            stage_fronts=fronts,
            val_pcc=val_pcc,
            compose_stats=comp.stats,
            est_objectives=comp.objectives,
            candidate_genomes=genomes,
            final_labels=final_labels,
            true_objectives=true_obj,
            front_mask=front_mask,
            timings=timings,
            ground_truth_calls={
                "stage_campaigns": stage_labeled,
                "final": final_labeled,
                "total": stage_labeled + final_labeled,
            },
            flat_space_size=flat_space,
            max_concurrent_stages=max_conc,
        )
    finally:
        if own_manager:
            manager.shutdown()
