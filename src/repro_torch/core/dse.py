"""End-to-end DSE loop — the three framework stages of paper Fig. 2:

  1. Model Training       sample + label n_train random variants (device
                          synthesis + behavioral sim), build the pipeline's
                          feature extractor, fit the two surrogates.
  2. Architecture          NSGA-II over the genome space, objectives
     Exploration           evaluated by the surrogates only.
  3. Final Evaluation      the surviving parent set is re-synthesized and
                          re-simulated; the *true* Pareto front is returned.

Every stage is timed; the result object carries everything the Fig. 5/7/8/9
benchmarks need.

The loop itself lives in ``core.strategies`` as an ask/tell state machine
(``Campaign`` + pluggable ``SearchStrategy``); ``run_dse`` and
``random_search`` are its drive-to-completion wrappers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # avoid circular import (accel depends on core.acl)
    from ..accel.base import Accelerator
from ..device import resolve_device
from .acl.library import Library, default_library
from .features import synth
from .hw import H100_SXM, Hardware
from .nsga2 import NSGA2Config, NSGA2Result
from .pareto import non_dominated_mask

__all__ = ["DSEConfig", "DSEResult", "run_dse", "random_search",
           "default_labeler", "label_unique"]

# A labeler maps a (n, g) genome batch to the ground-truth label dict of
# synth.label_variants.  run_dse takes one by injection so the labeling
# substrate is swappable; the default is the in-process path (per-call
# synthesis cache, discarded at return).


def default_labeler(
    accel: "Accelerator",
    library: Library,
    *,
    rank_genes: bool = False,
    n_qor_samples: int = 4,
    qor_seed: int = synth.DEFAULT_QOR_SEED,
    cache: Optional[dict] = None,
    synth_cache: Optional[synth.SynthCache] = None,
    device=None,
    hw: Hardware = H100_SXM,
):
    """The in-process labeler ``run_dse`` uses when none is injected; it
    labels on ``device`` (default ``"cuda"``) with the hardware cost
    model ``hw`` (default the H100's; ``hw.V5E`` gives the JAX package's
    labels), through ``synth_cache`` (default the process-wide
    ``synth.shared_synth_cache()``)."""
    dev = resolve_device(device)
    ctx_cache = {} if cache is None else cache
    qor_inputs = accel.sample_inputs(n_qor_samples, seed=qor_seed)

    def labeler(genomes: np.ndarray) -> Dict[str, np.ndarray]:
        return synth.label_variants(
            accel, genomes, library,
            rank_genes=rank_genes, qor_inputs=qor_inputs, cache=ctx_cache,
            synth_cache=synth_cache, device=dev, hw=hw,
        )

    return labeler


def label_unique(labeler, genomes: np.ndarray) -> Dict[str, np.ndarray]:
    """Label a batch paying ground truth only for UNIQUE genomes.

    NSGA-II survivor sets routinely contain repeated genomes (elitism
    keeps copies of strong designs); labels are a pure function of the
    genome, so duplicates are labeled once and scattered back."""
    genomes = np.atleast_2d(genomes)
    uniq, inverse = np.unique(genomes, axis=0, return_inverse=True)
    labels = labeler(uniq)
    # scatter back (also undoes np.unique's row sort)
    return {k: np.asarray(v)[inverse] for k, v in labels.items()}


@dataclass(frozen=True)
class DSEConfig:
    pipeline: str = "D"                     # paper's winner
    hw_model: str = "bayesian_ridge"        # paper Fig. 6: best for power
    qor_model: str = "random_forest"        # paper Fig. 6: best for QoR
    strategy: str = "nsga2"                 # explorer (strategies registry)
    objectives: Tuple[str, ...] = ("qor", "energy")  # qor auto-negated
    n_train: int = 1000                     # paper: 1000 random variants
    n_qor_samples: int = 4
    rank_genes: bool = False                # beyond-paper axis
    # beyond-paper: seed half the NSGA-II population from the
    # circuit-level Pareto subspace (the SoA's pre-filter, used as a
    # warm start instead of a hard restriction) — on the TPU the slot
    # costs are separable, so that subspace is a strong prior while the
    # full-space search still covers interactions the pre-filter misses
    warm_start: bool = True
    nsga: NSGA2Config = field(default_factory=NSGA2Config)
    seed: int = 0


@dataclass
class DSEResult:
    accel_name: str
    config: DSEConfig
    # stage 1
    train_genomes: np.ndarray
    train_labels: Dict[str, np.ndarray]
    val_pcc: Dict[str, float]
    # stage 2
    search: NSGA2Result
    est_objectives: np.ndarray          # surrogate objectives of parents
    # stage 3
    final_labels: Dict[str, np.ndarray]
    true_objectives: np.ndarray
    front_mask: np.ndarray
    timings: Dict[str, float]

    @property
    def front_genomes(self) -> np.ndarray:
        return self.search.genomes[self.front_mask]

    @property
    def front_objectives(self) -> np.ndarray:
        return self.true_objectives[self.front_mask]


def _objective_matrix(labels: Dict[str, np.ndarray], names: Sequence[str]) -> np.ndarray:
    cols = []
    for nm in names:
        v = np.asarray(labels[nm], dtype=np.float64)
        cols.append(-v if nm == "qor" else v)  # maximize QoR -> minimize -QoR
    return np.stack(cols, axis=1)


def run_dse(
    accel: Accelerator,
    library: Optional[Library] = None,
    cfg: Optional[DSEConfig] = None,
    *,
    labeler=None,
    surrogate_provider=None,
    strategy=None,
    verbose: bool = False,
    device=None,
) -> DSEResult:
    """The three-stage DSE, driven to completion.  ``labeler`` (genomes
    -> label dict) and ``surrogate_provider`` ((obj, model_name, X, y) ->
    fitted model) are injectable so the service layer can swap in its
    persistent label store / coalescing scheduler / warm surrogate
    registry; ``strategy`` picks the explorer (a ``strategies`` registry
    name, a factory, or None for ``cfg.strategy``).  The defaults
    reproduce the classic one-shot in-process behavior exactly.

    This is now a thin wrapper over the ask/tell ``strategies.Campaign``
    state machine — interruptible callers (the campaign service) step
    and snapshot the campaign themselves.  The default labeler runs on
    ``device`` (default ``"cuda"``)."""
    from .strategies.campaign import Campaign, drive

    dev = resolve_device(device)
    cfg = cfg if cfg is not None else DSEConfig()
    library = library or default_library()
    if labeler is None:
        labeler = default_labeler(
            accel, library,
            rank_genes=cfg.rank_genes, n_qor_samples=cfg.n_qor_samples,
            device=dev,
        )
    campaign = Campaign(
        accel, library, cfg,
        strategy=strategy,
        surrogate_provider=surrogate_provider,
        verbose=verbose,
    )
    return drive(campaign, labeler)


def random_search(
    accel: Accelerator,
    library: Optional[Library] = None,
    *,
    n: int = 1000,
    objectives: Tuple[str, ...] = ("qor", "energy"),
    rank_genes: bool = False,
    seed: int = 0,
    labeler=None,
    device=None,
    hw: Hardware = H100_SXM,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Baseline for Figs. 8/9: label n random variants, return
    (genomes, objectives, front_mask).

    Drives a ``RandomStrategy`` through a ground-truth ``Campaign`` (no
    surrogates, no final stage) — one ask covering the whole budget, so
    the labeler sees one unique batch.  The default labeler is
    ``run_dse``'s, on ``device`` (default ``"cuda"``) and ``hw``."""
    from .strategies.campaign import Campaign, drive
    from .strategies.random import RandomStrategy

    dev = resolve_device(device)
    library = library or default_library()
    # same default labeler as run_dse (QoR inputs from DEFAULT_QOR_SEED),
    # so injected-labeler and in-process baselines are apples-to-apples
    if labeler is None:
        labeler = default_labeler(accel, library, rank_genes=rank_genes,
                                  device=dev, hw=hw)
    cfg = DSEConfig(objectives=tuple(objectives), rank_genes=rank_genes,
                    seed=seed)
    campaign = Campaign(
        accel, library, cfg,
        strategy=lambda sizes, _cfg, init=None: RandomStrategy(
            sizes, n_total=n, seed=seed),
        ground_truth_explore=True,
    )
    genomes, obj, mask, _labels = drive(campaign, labeler)
    return genomes, obj, mask
