"""Hierarchical multi-stage search (paper §V, the scalability strategy).

Multi-stage applications (pre-filter -> transform pipelines, chained
kernels) make the flat DSE genome the *product* of the stage spaces.
This package implements the paper's hierarchical decomposition on top of
the in-process campaign service (``repro_torch.service``):

  * ``staged``   — ``StagedPipeline``: N stage accelerators composed into
                   one ``Accelerator`` (chained population sim on the
                   device, chained rank-k deployment, per-stage
                   re-quantization couplings), plus ``StageView``: one
                   stage exposed as a standalone accelerator whose QoR is
                   measured in situ (all other stages exact),
  * ``compose``  — per-stage Pareto fronts composed into application
                   candidates with incremental non-dominated pruning (the
                   cross-product is never fully materialized),
  * ``search``   — ``run_hierarchical``: one concurrent DSE campaign per
                   stage through the ``CampaignManager`` (shared label
                   store), composition, then end-to-end re-labeling of
                   only the surviving candidates.
"""

from .staged import Coupling, StagedPipeline, StageView
from .compose import ComposeResult, StageFront, compose_fronts, truncate_front
from .search import HierarchicalConfig, HierarchicalResult, run_hierarchical

__all__ = [
    "Coupling",
    "StagedPipeline",
    "StageView",
    "StageFront",
    "ComposeResult",
    "compose_fronts",
    "truncate_front",
    "HierarchicalConfig",
    "HierarchicalResult",
    "run_hierarchical",
]
