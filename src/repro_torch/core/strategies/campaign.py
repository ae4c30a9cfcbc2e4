"""``Campaign`` — the paper's Fig. 2 loop (train surrogates -> explore ->
final evaluation) as an interruptible state machine.

The legacy ``run_dse`` was one blocking call that owned its labeler for
its whole life; a ``Campaign`` instead *yields* labeling requests and is
stepped from outside:

    campaign = Campaign(accel, library, cfg)
    while not campaign.done:
        req = campaign.step()                 # advance one tick
        if req is not None:                   # ground truth needed
            campaign.deliver(req, labeler(req.genomes))
    res = campaign.result()                   # a DSEResult

One ``step()`` is one cooperative tick: the TRAIN tick returns the
training-set label request, each EXPLORE tick runs exactly one strategy
round (ask -> surrogate evaluation -> tell), the FINAL tick returns the
survivor-set request.  Between ticks the full campaign state — stage,
training data, strategy internals — is capturable with ``state()`` and
re-installable with ``restore()``, which is what makes service
campaigns multiplexable over a small worker pool and resumable after a
kill (surrogates are refit deterministically from the snapshotted
training set; ground truth re-requested on resume is answered by the
label store).

``drive()`` runs a campaign to completion against a blocking labeler —
``run_dse`` is now that one-liner.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ... import obs
from ..nsga2 import NSGA2Result
from ..pareto import non_dominated_mask
from ..surrogates import make as make_surrogate
from ..surrogates import pcc
from .base import (
    SearchStrategy,
    decode_array,
    encode_array,
    make_strategy,
)

__all__ = ["LabelRequest", "Campaign", "drive"]

CAMPAIGN_STATE_VERSION = 1


@dataclass
class LabelRequest:
    """A batch of UNIQUE genomes whose ground truth the campaign needs.

    ``genomes`` is ``np.unique``-sorted — byte-identical to what the
    legacy ``label_unique`` handed the labeler — so store keys, batch
    contents and cache behavior are unchanged.  ``deliver`` scatters the
    unique labels back over the requesting batch via ``inverse``."""

    stage: str                      # "train" | "explore" | "final"
    genomes: np.ndarray             # (u, g) unique rows
    inverse: np.ndarray = field(repr=False, default=None)
    issued_at: float = field(default_factory=time.perf_counter, repr=False)


def _unique_request(stage: str, genomes: np.ndarray) -> LabelRequest:
    genomes = np.atleast_2d(np.asarray(genomes, dtype=np.int64))
    uniq, inverse = np.unique(genomes, axis=0, return_inverse=True)
    return LabelRequest(stage=stage, genomes=uniq, inverse=inverse)


class Campaign:
    """Stage machine TRAIN -> EXPLORE -> FINAL -> DONE over a pluggable
    ``SearchStrategy``.

    ``strategy`` may be a registry name, a ``SearchStrategy`` *factory*
    ``(gene_sizes, cfg, *, init=None) -> strategy``, or None (use
    ``cfg.strategy``).  ``surrogate_provider`` is the run_dse seam
    unchanged.  With ``ground_truth_explore=True`` the TRAIN and FINAL
    stages are skipped and every EXPLORE round is labeled with ground
    truth directly (how ``random_search`` rides the protocol)."""

    def __init__(
        self,
        accel,
        library=None,
        cfg=None,
        *,
        strategy=None,
        surrogate_provider=None,
        ground_truth_explore: bool = False,
        objectives: Optional[tuple] = None,
        verbose: bool = False,
        keep_history: bool = True,
    ):
        from ..acl.library import default_library
        from ..dse import DSEConfig

        self.accel = accel
        self.library = library or default_library()
        self.cfg = cfg if cfg is not None else DSEConfig()
        self.objectives = tuple(objectives or self.cfg.objectives)
        self.verbose = verbose
        self.keep_history = keep_history
        self.ground_truth_explore = bool(ground_truth_explore)
        self._strategy_arg = strategy
        self.strategy_name = (
            strategy if isinstance(strategy, str) else
            getattr(self.cfg, "strategy", "nsga2")
        )
        if surrogate_provider is None:
            def surrogate_provider(obj, name, X, y):
                return make_surrogate(name, seed=self.cfg.seed).fit(X, y)
        self._provider = surrogate_provider

        self.gene_sizes = accel.gene_sizes(self.library,
                                           rank_genes=self.cfg.rank_genes)
        self._rng = np.random.default_rng(self.cfg.seed)
        self.stage = "explore" if self.ground_truth_explore else "train"
        self.strategy: Optional[SearchStrategy] = None
        self.timings: Dict[str, float] = {}
        self.val_pcc: Dict[str, float] = {}
        self.labels_requested = 0
        # stage artifacts
        self.train_genomes: Optional[np.ndarray] = None
        self.train_labels: Optional[Dict[str, np.ndarray]] = None
        self._extractor = None
        self._models: Optional[Dict] = None
        self._search: Optional[NSGA2Result] = None
        self._gt_labels: List[Dict[str, np.ndarray]] = []  # gt-explore mode
        self._req: Optional[LabelRequest] = None
        self._result = None
        if self.ground_truth_explore:
            self._make_strategy(init=None)

    # ------------------------------------------------------------------
    @property
    def done(self) -> bool:
        return self.stage == "done"

    def _make_strategy(self, init: Optional[np.ndarray]) -> None:
        s = self._strategy_arg
        if isinstance(s, SearchStrategy):
            self.strategy = s
            self.strategy_name = s.name
        elif callable(s) and not isinstance(s, str):
            self.strategy = s(self.gene_sizes, self.cfg, init=init)
            self.strategy_name = getattr(self.strategy, "name",
                                         self.strategy_name)
        else:
            name = s if isinstance(s, str) else getattr(self.cfg, "strategy",
                                                        "nsga2")
            self.strategy = make_strategy(name, self.gene_sizes, self.cfg,
                                          init=init)
            self.strategy_name = name
        if not self.keep_history:
            self.strategy.keep_history = False

    # ------------------------------------------------------------------
    def step(self) -> Optional[LabelRequest]:
        """Advance one tick.  Returns a ``LabelRequest`` when ground
        truth is needed (the campaign then blocks until ``deliver``);
        None after a self-contained tick (an EXPLORE round, or nothing
        left to do).  Idempotent while a request is outstanding."""
        if self._req is not None:
            return self._req
        if self.stage == "train":
            if self.train_genomes is None:
                self.train_genomes = self._rng.integers(
                    0, self.gene_sizes[None, :],
                    size=(self.cfg.n_train, len(self.gene_sizes)),
                )
                # the exact reference design anchors surrogates and front
                self.train_genomes[0] = self.accel.exact_genome(
                    self.library, rank_genes=self.cfg.rank_genes
                )
            self._req = _unique_request("train", self.train_genomes)
            return self._req
        if self.stage == "explore":
            if self.strategy.done:
                self._finish_explore()
                return self.step() if self.stage == "final" else None
            genomes = self.strategy.ask()
            if self.ground_truth_explore:
                if len(genomes) == 0:
                    self.strategy.tell(genomes, np.zeros(
                        (0, len(self.objectives))))
                    return None
                self._req = _unique_request("explore", genomes)
                return self._req
            t0 = time.perf_counter()
            with obs.span("campaign.round", stage="explore",
                          strategy=self.strategy_name, n=int(len(genomes))):
                obj = (self._evaluate(genomes) if len(genomes)
                       else np.zeros((0, len(self.objectives))))
                self.strategy.tell(genomes, obj)
            self.timings["explore"] = (
                self.timings.get("explore", 0.0) + time.perf_counter() - t0
            )
            if self.strategy.done:
                self._finish_explore()
            return None
        if self.stage == "final":
            self._req = _unique_request("final", self._search.genomes)
            return self._req
        return None

    def deliver(self, req: LabelRequest, labels: Dict[str, np.ndarray]
                ) -> None:
        """Hand the ground truth for ``req.genomes`` back; advances the
        stage machine.  ``labels`` maps label name -> (u,) array aligned
        with the request's unique genomes."""
        if req is not self._req:
            raise ValueError("deliver() got a request that is not pending")
        with obs.span("campaign.deliver", stage=req.stage,
                      n=int(len(req.genomes))):
            full = {k: np.asarray(v)[req.inverse] for k, v in labels.items()}
            # counted on delivery, not issue: a request outstanding at
            # snapshot time is re-issued on resume and must not count twice
            self.labels_requested += len(req.genomes)
            self._req = None
            if req.stage == "train":
                self.timings["label"] = (
                    self.timings.get("label", 0.0)
                    + time.perf_counter() - req.issued_at
                )
                self.train_labels = full
                self._fit_surrogates()
            elif req.stage == "explore":
                from ..dse import _objective_matrix

                self._gt_labels.append(full)
                self.strategy.tell(
                    self.strategy.ask(),
                    _objective_matrix(full, self.objectives),
                )
                if self.strategy.done:
                    self._finish_explore()
            elif req.stage == "final":
                self.timings["final_eval"] = (
                    self.timings.get("final_eval", 0.0)
                    + time.perf_counter() - req.issued_at
                )
                self._finalize(full)

    # ------------------------------------------------------------------
    def _fit_surrogates(self) -> None:
        """Stage-1 tail: features, validation PCC, provider refit, then
        warm-start init + strategy construction (moves to EXPLORE)."""
        from ..features.pipelines import build_extractor

        t0 = time.perf_counter()
        cfg = self.cfg
        self._extractor = build_extractor(
            cfg.pipeline, self.accel, self.library, rank_genes=cfg.rank_genes
        )
        X = self._extractor(self.train_genomes)
        n_val = max(cfg.n_train // 5, 1)
        tr, va = slice(n_val, None), slice(0, n_val)
        models = {}
        for obj in self.objectives:
            name = cfg.qor_model if obj == "qor" else cfg.hw_model
            m = make_surrogate(name, seed=cfg.seed).fit(
                X[tr], self.train_labels[obj][tr])
            models[obj] = m
            self.val_pcc[obj] = pcc(self.train_labels[obj][va],
                                    m.predict(X[va]))
        # refit on everything via the provider (warm surrogate registry)
        for obj in self.objectives:
            name = cfg.qor_model if obj == "qor" else cfg.hw_model
            models[obj] = self._provider(obj, name, X,
                                         self.train_labels[obj])
        self._models = models
        self.timings["train"] = (
            self.timings.get("train", 0.0) + time.perf_counter() - t0
        )
        if self.verbose:
            print(f"[dse:{self.accel.name}] val PCC: "
                  + ", ".join(f"{k}={v:.3f}"
                              for k, v in self.val_pcc.items()))
        init = self.train_genomes[: cfg.nsga.pop_size].copy()
        if cfg.warm_start and len(init) >= 4:
            from ...accel.approxfpgas import circuit_level_front

            half = len(init) // 2
            per_slot_choices = []
            for slot in self.accel.slots:
                front = circuit_level_front(self.library, slot.kind)
                per_slot_choices.append(
                    [self.library.index(slot.kind, c.name) for c in front]
                )
            for t in range(half):
                for j, choices in enumerate(per_slot_choices):
                    init[t, j] = choices[self._rng.integers(0, len(choices))]
        self._make_strategy(init=init)
        self.stage = "explore"

    def _evaluate(self, genomes: np.ndarray) -> np.ndarray:
        from ..dse import _objective_matrix

        Xg = self._extractor(genomes)
        labels = {obj: self._models[obj].predict(Xg)
                  for obj in self.objectives}
        return _objective_matrix(labels, self.objectives)

    def _finish_explore(self) -> None:
        self._search = self.strategy.result()
        if self.ground_truth_explore:
            # objectives ARE ground truth: assemble the result directly
            labels = {
                k: np.concatenate([d[k] for d in self._gt_labels])
                for k in self._gt_labels[0]
            } if self._gt_labels else {}
            self._finalize_gt(labels)
        else:
            self.stage = "final"

    def _finalize(self, final_labels: Dict[str, np.ndarray]) -> None:
        from ..dse import DSEResult, _objective_matrix

        cfg = self.cfg
        search = self._search
        all_genomes = np.concatenate([search.genomes, self.train_genomes])
        all_labels = {
            k: np.concatenate([final_labels[k], self.train_labels[k]])
            for k in final_labels
        }
        true_obj = _objective_matrix(all_labels, self.objectives)
        mask = non_dominated_mask(true_obj)
        self._result = DSEResult(
            accel_name=self.accel.name,
            config=cfg,
            train_genomes=self.train_genomes,
            train_labels=self.train_labels,
            val_pcc=self.val_pcc,
            search=NSGA2Result(
                genomes=all_genomes,
                objectives=np.concatenate(
                    [search.objectives,
                     _objective_matrix(self.train_labels, self.objectives)]
                ),
                front_mask=mask,
                history=search.history,
                n_evaluated=search.n_evaluated,
            ),
            est_objectives=search.objectives,
            final_labels=all_labels,
            true_objectives=true_obj,
            front_mask=mask,
            timings=self.timings,
        )
        self.stage = "done"

    def _finalize_gt(self, labels: Dict[str, np.ndarray]) -> None:
        from ..dse import _objective_matrix

        obs_g = np.concatenate(
            [h.genomes for h in self.strategy.history]
        ) if self.strategy.history else self._search.genomes
        true_obj = _objective_matrix(labels, self.objectives)
        self._result = (obs_g, true_obj, non_dominated_mask(true_obj),
                        labels)
        self.stage = "done"

    def result(self):
        if self._result is None:
            raise RuntimeError(f"campaign not finished (stage={self.stage})")
        return self._result

    def front_estimate(self) -> Optional[np.ndarray]:
        """The strategy's current survivor-set objective matrix (est.),
        or None before the first evaluated population.  Cheap enough to
        sample at every tick — the service's telemetry timeline derives
        live hypervolume/front-size from it."""
        if self.strategy is None:
            return None
        try:
            res = self.strategy.result()
        except Exception:  # noqa: BLE001 - no population evaluated yet
            return None
        return np.asarray(res.objectives, dtype=np.float64)

    # ------------------------------------------------------------------
    def progress(self) -> Dict:
        """JSON-safe live progress for the service's status endpoint."""
        out = {
            "stage": self.stage,
            "strategy": self.strategy_name,
            "labels_requested": int(self.labels_requested),
        }
        if self.val_pcc:
            out["val_pcc"] = dict(self.val_pcc)
        if self.strategy is not None:
            out.update(self.strategy.progress())
        return out

    # ------------------------------------------------------------------
    def state(self) -> Dict:
        """JSON-serializable snapshot at a tick boundary.  Surrogates and
        the feature extractor are NOT serialized: they are refit
        deterministically from the snapshotted training set on restore
        (note: a provider in 'accumulate' mode may refit on a larger
        pool — resume reproducibility holds for 'reuse'/'off')."""
        from dataclasses import asdict

        return {
            "version": CAMPAIGN_STATE_VERSION,
            "stage": self.stage,
            "cfg": asdict(self.cfg),
            "objectives": list(self.objectives),
            "strategy_name": self.strategy_name,
            "ground_truth_explore": self.ground_truth_explore,
            "rng": self._rng.bit_generator.state,
            "train_genomes": encode_array(self.train_genomes),
            "train_labels": (
                None if self.train_labels is None else
                {k: encode_array(np.asarray(v))
                 for k, v in self.train_labels.items()}
            ),
            "gt_labels": [
                {k: encode_array(np.asarray(v)) for k, v in d.items()}
                for d in self._gt_labels
            ],
            "labels_requested": int(self.labels_requested),
            "timings": dict(self.timings),
            "strategy": (self.strategy.state()
                         if self.strategy is not None else None),
        }

    def restore(self, state: Dict) -> "Campaign":
        """Re-install a snapshot onto a freshly constructed campaign for
        the SAME accelerator/library/config.  An outstanding label
        request at snapshot time is simply re-issued by the next
        ``step()`` (the label store makes the re-ask cheap)."""
        if state.get("version") != CAMPAIGN_STATE_VERSION:
            raise ValueError(
                f"campaign snapshot version {state.get('version')!r} "
                f"unsupported (want {CAMPAIGN_STATE_VERSION})"
            )
        g = len(self.gene_sizes)
        self.stage = state["stage"]
        self.objectives = tuple(state["objectives"])
        self.ground_truth_explore = state["ground_truth_explore"]
        self._rng = np.random.default_rng()
        self._rng.bit_generator.state = state["rng"]
        self.train_genomes = decode_array(state["train_genomes"], width=g)
        self.train_labels = (
            None if state["train_labels"] is None else
            {k: decode_array(v, dtype=np.float64)
             for k, v in state["train_labels"].items()}
        )
        self._gt_labels = [
            {k: decode_array(v, dtype=np.float64) for k, v in d.items()}
            for d in state["gt_labels"]
        ]
        self.labels_requested = state["labels_requested"]
        self._req = None
        self._result = None
        strat_state = state["strategy"]
        if self.stage in ("explore", "final") or (
                self.ground_truth_explore and strat_state is not None):
            if not self.ground_truth_explore:
                # replay the deterministic stage-1 tail (fits + warm
                # start init + strategy construction), then overwrite
                # the strategy's loop state with the snapshot
                rng_save = self._rng
                self._rng = np.random.default_rng()  # consumed by replay
                self._fit_surrogates()
                self._rng = rng_save
                self.stage = state["stage"]
            self.strategy.restore(strat_state)
            if self.stage == "final":
                self._search = self.strategy.result()
        # reinstate AFTER the replay so the refit's wall time does not
        # double-count into the snapshotted "train" entry
        self.timings = dict(state["timings"])
        if self.stage == "done":
            raise ValueError("refusing to restore a finished campaign "
                             "(its result was not serialized)")
        return self

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Campaign({self.accel.name}, strategy="
                f"{self.strategy_name}, stage={self.stage})")


def drive(campaign: Campaign, labeler) -> object:
    """Run a campaign to completion against a blocking labeler
    (genomes -> label dict).  The legacy one-shot entry points are thin
    wrappers over this."""
    while not campaign.done:
        req = campaign.step()
        if req is not None:
            campaign.deliver(req, labeler(req.genomes))
    return campaign.result()
