"""The six model-training pipelines of paper Fig. 3 (A)–(F).

  A: exhaustive — every variant synthesized (no surrogate).  PCC = 1 by
     construction; time = |space| x t_synth.
  B: per-AC features from *synthesis* (Vivado -> one deployment run of
     each circuit on the device), composed to variant features;
     surrogate trained on synth-labeled sample.
  C: per-AC features from the *cheap* extractor (ABC analogue), composed.
  D: cheap per-AC features + cheap accelerator-level features (the
     paper's winner).
  E: synth per-AC features + cheap accelerator-level features.
  F: cheap accelerator-level features only.

``build_extractor`` returns a vectorized genomes->X function plus its
setup cost; ``evaluate_pipeline`` reproduces one Fig. 5 bar: train the
surrogate on a labeled sample, report test PCC and per-variant
exploration time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # avoid circular import
    from ...accel.base import Accelerator
from ...core.acl.library import Library
from ..surrogates import make, pcc
from ..hw import H100_SXM, Hardware
from . import cheap, synth

__all__ = ["PIPELINES", "Extractor", "build_extractor", "evaluate_pipeline"]

PIPELINES = ("A", "B", "C", "D", "E", "F")


@dataclass
class Extractor:
    pipeline: str
    extract: Callable[[np.ndarray], np.ndarray]   # genomes -> (n, d)
    setup_time: float                              # one-time feature setup
    per_variant_time: float = 0.0                  # measured at first call

    def __call__(self, genomes: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        X = self.extract(np.atleast_2d(genomes))
        dt = time.perf_counter() - t0
        self.per_variant_time = dt / max(len(np.atleast_2d(genomes)), 1)
        return X


def _ac_feature_tables(
    accel: Accelerator, library: Library, mode: str, *, device=None,
    hw: Hardware = H100_SXM,
) -> Dict[str, np.ndarray]:
    """{kind: (n_circuits, d)} per-AC feature tables, cheap or synth (one
    deployment run of each circuit on ``device``, costed on ``hw``)."""
    kinds = sorted({s.kind for s in accel.slots})
    out = {}
    for kind in kinds:
        rows = []
        for c in library.kind(kind):
            if mode == "cheap":
                rows.append(cheap.circuit_features_cheap(c))
            else:
                rows.append(synth.circuit_features_synth(
                    c, device=device, hw=hw)[:-1])  # drop wall
        out[kind] = np.stack(rows)
    return out


def build_extractor(
    pipeline: str,
    accel: Accelerator,
    library: Library,
    *,
    rank_genes: bool = False,
    device=None,
    hw: Hardware = H100_SXM,
) -> Extractor:
    """The pipeline's feature extractor; B and E run each circuit's
    deployment on ``device`` (default ``"cuda"``) and cost it on
    ``hw``."""
    pipeline = pipeline.upper()
    assert pipeline in PIPELINES
    t0 = time.perf_counter()
    ac_tables = None
    accel_level = pipeline in ("D", "E", "F")
    if pipeline in ("B", "E"):
        ac_tables = _ac_feature_tables(accel, library, "synth",
                                       device=device, hw=hw)
    elif pipeline in ("C", "D"):
        ac_tables = _ac_feature_tables(accel, library, "cheap")
    setup = time.perf_counter() - t0

    if pipeline == "A":
        def extract(genomes):
            raise RuntimeError(
                "pipeline A has no feature extractor: every variant is "
                "synthesized (use features.synth.label_variants)"
            )
        return Extractor("A", extract, setup)

    def extract(genomes):
        return cheap.variant_features(
            accel,
            genomes,
            library,
            ac_features=ac_tables,
            accel_level=accel_level,
            rank_genes=rank_genes,
        )

    return Extractor(pipeline, extract, setup)


@dataclass
class PipelineReport:
    pipeline: str
    pcc_hw: float                  # correlation on the hardware target
    pcc_qor: float
    setup_time: float
    per_variant_time: float        # feature+predict per variant (s)
    train_time: float
    explore_time_1m: float         # extrapolated exploration of 1e6 variants
    details: dict = field(default_factory=dict)


def evaluate_pipeline(
    pipeline: str,
    accel: Accelerator,
    library: Library,
    train_genomes: np.ndarray,
    train_labels: Dict[str, np.ndarray],
    test_genomes: np.ndarray,
    test_labels: Dict[str, np.ndarray],
    *,
    hw_target: str = "energy",
    hw_model: str = "bayesian_ridge",
    qor_model: str = "random_forest",
    rank_genes: bool = False,
    synth_time_per_variant: Optional[float] = None,
    device=None,
    hw: Hardware = H100_SXM,
) -> PipelineReport:
    """One Fig. 5 bar: PCC + exploration-time for a pipeline (B and E
    build their features on ``device`` and ``hw``)."""
    if pipeline == "A":
        tpv = synth_time_per_variant or float(
            np.mean(train_labels["synth_time"] + train_labels["sim_time"])
        )
        return PipelineReport(
            pipeline="A",
            pcc_hw=1.0,
            pcc_qor=1.0,
            setup_time=0.0,
            per_variant_time=tpv,
            train_time=0.0,
            explore_time_1m=tpv * 1e6,
        )

    ext = build_extractor(pipeline, accel, library, rank_genes=rank_genes,
                          device=device, hw=hw)
    Xtr = ext(train_genomes)
    Xte = ext(test_genomes)

    t0 = time.perf_counter()
    m_hw = make(hw_model).fit(Xtr, train_labels[hw_target])
    m_qor = make(qor_model).fit(Xtr, train_labels["qor"])
    train_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    pred_hw = m_hw.predict(Xte)
    pred_qor = m_qor.predict(Xte)
    predict_time = (time.perf_counter() - t0) / max(len(test_genomes), 1)

    per_variant = ext.per_variant_time + predict_time
    return PipelineReport(
        pipeline=pipeline,
        pcc_hw=pcc(test_labels[hw_target], pred_hw),
        pcc_qor=pcc(test_labels["qor"], pred_qor),
        setup_time=ext.setup_time,
        per_variant_time=per_variant,
        train_time=train_time,
        explore_time_1m=ext.setup_time + train_time + per_variant * 1e6,
        details={"hw_model": hw_model, "qor_model": qor_model},
    )
