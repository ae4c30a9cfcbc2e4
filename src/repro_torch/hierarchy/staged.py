"""Staged pipeline accelerators: N stages composed into one application.

A ``StagedPipeline`` implements the full ``Accelerator`` protocol over
the concatenation of its stages' slots, so the *flat joint-genome*
baseline runs through the existing ``run_dse`` unchanged.  Between stage
*i* and stage *i+1* a ``Coupling`` applies the application's
re-quantization (clip/shift/re-blocking) in both the behavioral domain
(numpy) and the deployment domain (torch), mirroring how a real pipeline
re-quantizes the intermediate signal back into the next stage's input
format.  A population batch of the chain runs on the device as one
chained plan (``accel.fused.staged_plan``, registered below).

``StageView`` exposes ONE stage as a standalone accelerator for the
hierarchical per-stage campaigns: its QoR is measured *in situ* (the
pipeline runs end-to-end with every other stage exact) while its
hardware labels are the stage's own deployment cost — exactly the
per-component decomposition of autoAx-style hierarchical search, with
the composed front re-verified end-to-end afterwards (the JAX package's
``hierarchy.search``, not in this port yet).

Genome layout of a pipeline with stages A, B, ... (rank_genes=True):

    [A slot genes][B slot genes]...[A rank genes][B rank genes]...

``split_genome`` / ``assemble_genome`` convert between this layout and
the per-stage layouts ``[slot genes][rank genes]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..accel import fused
from ..accel.base import Accelerator, Slot
from ..core.acl.library import Circuit
from ..device import resolve_device

__all__ = ["Coupling", "StagedPipeline", "StageView"]


@dataclass(frozen=True)
class Coupling:
    """Re-quantization hook between consecutive stages.

    ``sim``: numpy map from stage-i behavioral output to stage-(i+1)
    behavioral input.  ``deploy``: torch map from stage-i deployment output
    to stage-(i+1) deployment *activation* (the preprocessed matmul
    operand, e.g. im2col windows or block rows).  ``name`` participates
    in the label-store fingerprint so editing a coupling re-keys labels.
    ``sim`` must be elementwise/broadcast-safe: the batched population
    path pushes intermediates with a leading genome axis through it.
    """

    name: str = "identity"
    sim: Optional[Callable] = None
    deploy: Optional[Callable] = None

    def apply_sim(self, x):
        return x if self.sim is None else self.sim(x)

    def apply_deploy(self, y):
        return y if self.deploy is None else self.deploy(y)


class StagedPipeline(Accelerator):
    """Compose stage accelerators into one application accelerator.

    ``simulate_batch`` (the base class's) runs the chain's population on
    the device: every stage's plan chained through the couplings' torch
    twins, the per-genome intermediate stack never leaving the device
    (``fused.staged_plan``, which raises if a stage or coupling has no
    device form)."""

    def __init__(
        self,
        name: str,
        stages: Sequence[Accelerator],
        couplings: Optional[Sequence[Coupling]] = None,
    ):
        assert len(stages) >= 1, "a pipeline needs at least one stage"
        self.name = name
        self.stages = list(stages)
        self.couplings = list(
            couplings if couplings is not None
            else [Coupling()] * (len(stages) - 1)
        )
        assert len(self.couplings) == len(self.stages) - 1, (
            "need exactly one coupling between each pair of stages"
        )
        self.slots: List[Slot] = []
        for st in self.stages:
            self.slots += [
                Slot(f"{st.name}.{s.name}", s.kind, s.weight) for s in st.slots
            ]

    @property
    def batched_sim(self) -> bool:
        """The chain handles a leading genome axis iff every stage does
        (couplings are elementwise by contract)."""
        return all(getattr(st, "batched_sim", False) for st in self.stages)

    # --- genome layout ----------------------------------------------------
    def stage_slot_counts(self) -> List[int]:
        return [len(st.slots) for st in self.stages]

    def stage_mul_counts(self) -> List[int]:
        return [len(st.mul_slot_indices()) for st in self.stages]

    def split_genome(
        self, genome: np.ndarray, *, rank_genes: bool = False
    ) -> List[np.ndarray]:
        """Pipeline genome -> per-stage genomes in each stage's layout."""
        genome = np.asarray(genome)
        out = []
        s_off, r_off = 0, len(self.slots)
        for ns, nm in zip(self.stage_slot_counts(), self.stage_mul_counts()):
            parts = [genome[s_off : s_off + ns]]
            if rank_genes:
                parts.append(genome[r_off : r_off + nm])
            out.append(np.concatenate(parts))
            s_off += ns
            r_off += nm
        return out

    def assemble_genome(
        self, stage_genomes: Sequence[np.ndarray], *, rank_genes: bool = False
    ) -> np.ndarray:
        """Per-stage genomes -> one pipeline genome (split_genome inverse)."""
        assert len(stage_genomes) == len(self.stages)
        slot_parts, rank_parts = [], []
        for st, g in zip(self.stages, stage_genomes):
            g = np.asarray(g)
            ns = len(st.slots)
            slot_parts.append(g[:ns])
            if rank_genes:
                rank_parts.append(g[ns:])
        return np.concatenate(slot_parts + rank_parts).astype(np.int64)

    def split_circuits(self, circuits: Sequence[Circuit]) -> List[Sequence[Circuit]]:
        out, off = [], 0
        for ns in self.stage_slot_counts():
            out.append(list(circuits[off : off + ns]))
            off += ns
        return out

    def split_per_mul(self, values: Sequence) -> List[List]:
        """Split a per-multiplier-slot sequence (ranks, deploy specs) into
        per-stage lists (pipeline mul order is stage-major)."""
        out, off = [], 0
        for nm in self.stage_mul_counts():
            out.append(list(values[off : off + nm]))
            off += nm
        return out

    # --- behavior ---------------------------------------------------------
    def sample_inputs(self, n: int, seed: int = 0) -> np.ndarray:
        return self.stages[0].sample_inputs(n, seed=seed)

    def stage_inputs(self, inputs: np.ndarray, index: int) -> np.ndarray:
        """Stage ``index``'s in-situ input: the pipeline input propagated
        through the preceding stages run exact."""
        x = inputs
        for i in range(index):
            x = self.couplings[i].apply_sim(self.stages[i].exact_output(x))
        return x

    def simulate_with_stage(
        self, index: int, circuits: Sequence[Circuit], inputs: np.ndarray
    ) -> np.ndarray:
        """End-to-end behavioral output with stage ``index`` under the
        given slot assignment and every OTHER stage exact."""
        x = inputs
        for i, st in enumerate(self.stages):
            y = st.simulate(circuits, x) if i == index else st.exact_output(x)
            x = self.couplings[i].apply_sim(y) if i < len(self.stages) - 1 else y
        return x

    def simulate(self, circuits: Sequence[Circuit], inputs: np.ndarray) -> np.ndarray:
        per_stage = self.split_circuits(circuits)
        x = inputs
        for i, st in enumerate(self.stages):
            y = st.simulate(per_stage[i], x)
            x = self.couplings[i].apply_sim(y) if i < len(self.stages) - 1 else y
        return x

    def exact_output(self, inputs: np.ndarray) -> np.ndarray:
        x = inputs
        for i, st in enumerate(self.stages):
            y = st.exact_output(x)
            x = self.couplings[i].apply_sim(y) if i < len(self.stages) - 1 else y
        return x

    # --- deployment -------------------------------------------------------
    def mul_slot_constants(self) -> List[Optional[int]]:
        out: List[Optional[int]] = []
        for st in self.stages:
            out += st.mul_slot_constants()
        return out

    def adjusted_compute(self, circuits, ranks, factor) -> float:
        """Dtype-aware matrix-unit cost of the chained deployment: the sum
        of the stages' costs (the coupling re-quantization is elementwise
        noise)."""
        from ..core.features.synth import _adjusted_compute

        total = 0.0
        for st, sc, sr in zip(
            self.stages, self.split_circuits(circuits), self.split_per_mul(ranks)
        ):
            total += _adjusted_compute(st, sc, sr, factor)
        return total

    def stage_deploy_inputs(self, inputs: Optional[np.ndarray] = None
                            ) -> List[np.ndarray]:
        """Each stage's example deploy input: the pipeline's deploy input
        propagated through the preceding stages run exact."""
        x = self.sample_inputs(1, seed=1) if inputs is None else inputs
        out = [np.asarray(x)]
        for i, st in enumerate(self.stages[:-1]):
            out.append(self.couplings[i].apply_sim(st.exact_output(out[-1])))
        return out

    def deploy_cost(self, specs, inputs: Optional[np.ndarray] = None):
        """The chained graph's count: every stage's own at its in-chain
        input (the couplings are elementwise and not counted)."""
        from ..core.features.synth import deploy_cost

        total = {"flops": 0.0, "hbm_bytes": 0.0}
        xs = self.stage_deploy_inputs(inputs)
        for st, sp, x in zip(self.stages, self.split_per_mul(specs), xs):
            c = deploy_cost(st, sp, inputs=x)
            for k in total:
                total[k] += c[k]
        return total

    def build_deploy(self, specs: Sequence, inputs: Optional[np.ndarray] = None,
                     *, device=None):
        """The chained rank-k deployment on ``device`` (default
        ``"cuda"``): stage fns composed with the couplings' deploy maps.
        ``fn(x0, *ws, path="mxu")`` passes ``path`` to every stage."""
        dev = resolve_device(device)
        per_stage_specs = self.split_per_mul(specs)
        fns, weights = [], []
        first_args = None
        for i, (st, x) in enumerate(
                zip(self.stages, self.stage_deploy_inputs(inputs))):
            # x is the stage's example input (its shapes only; at run
            # time its activation comes from the chain)
            fn_i, args_i = st.build_deploy(per_stage_specs[i], inputs=x,
                                           device=dev)
            fns.append(fn_i)
            weights.append(args_i[1])
            if i == 0:
                first_args = args_i

        couplings = self.couplings

        def fn(x0, *ws, path="mxu"):
            y = fns[0](x0, ws[0], path=path)
            for i in range(1, len(fns)):
                y = couplings[i - 1].apply_deploy(y)
                y = fns[i](y, ws[i], path=path)
            return y

        return fn, (first_args[0],) + tuple(weights)

    def label_fingerprint(self) -> str:
        """Per-stage structure + coupling names: a stage or coupling edit
        re-keys the label store instead of serving stale labels."""
        parts = []
        for st in self.stages:
            try:
                shape: Tuple = tuple(int(v) for v in st.matmul_shape())
            except NotImplementedError:
                shape = ()
            parts.append((
                st.name, shape,
                tuple((s.name, s.kind, float(s.weight)) for s in st.slots),
                int(getattr(st, "deploy_passes", 1)),
            ))
        return repr((parts, tuple(c.name for c in self.couplings)))

    def deploy_signature(self, specs):
        """The chained deployment's structural key: per-stage signatures
        composed with the coupling names.  Classes keep the stage
        boundaries (stage A's slots never permute into stage B); within
        a stage the stage's own signature decides interchangeability.
        Any stage opting out opts the whole chain out."""
        fams, classes = [], []
        for st, sp in zip(self.stages, self.split_per_mul(specs)):
            sig = st.deploy_signature(sp)
            if sig is None:
                return None
            f, c = sig
            fams.append(tuple(f))
            classes.append(tuple(c))
        family = ("staged", tuple(c.name for c in self.couplings),
                  tuple(fams))
        return family, tuple(classes)

    # --- hierarchy --------------------------------------------------------
    def stage_views(self) -> List["StageView"]:
        return [StageView(self, i) for i in range(len(self.stages))]


class StageView(Accelerator):
    """One pipeline stage as a standalone accelerator.

    QoR runs the WHOLE pipeline with every other stage exact (the stage's
    in-situ quality contribution); hardware labels are the stage's own
    deployment (so composed candidates sum per-stage hardware).  The
    hierarchical search labels the composed winners end-to-end afterwards
    — these per-stage labels only have to rank candidates, not be exact.
    """

    def __init__(self, pipeline: StagedPipeline, index: int):
        assert 0 <= index < len(pipeline.stages)
        self.pipeline = pipeline
        self.index = index
        self.stage = pipeline.stages[index]
        self.name = f"{pipeline.name}/stage{index}"
        self.slots = list(self.stage.slots)

    @property
    def deploy_passes(self) -> int:
        return int(getattr(self.stage, "deploy_passes", 1))

    def sample_inputs(self, n: int, seed: int = 0) -> np.ndarray:
        return self.pipeline.sample_inputs(n, seed=seed)

    def simulate(self, circuits: Sequence[Circuit], inputs: np.ndarray) -> np.ndarray:
        return self.pipeline.simulate_with_stage(self.index, circuits, inputs)

    def exact_output(self, inputs: np.ndarray) -> np.ndarray:
        return self.pipeline.exact_output(inputs)

    def simulate_batch(
        self,
        genomes: np.ndarray,
        library,
        inputs: np.ndarray,
        *,
        rank_genes: bool = False,
        per_genome_inputs: bool = False,
        device=None,
    ) -> np.ndarray:
        """In-situ population sim: exact prefix once for the whole
        population (numpy, on the host), this stage batched on ``device``
        (default ``"cuda"``), exact suffix over the per-genome
        intermediate stack (numpy)."""
        genomes = np.atleast_2d(np.asarray(genomes))
        if per_genome_inputs:
            # rare (a StageView nested inside another pipeline): one
            # population of one per genome, each still on the device
            return np.stack([
                self.simulate_batch(g[None], library, x,
                                    rank_genes=rank_genes, device=device)[0]
                for g, x in zip(genomes, inputs)
            ])
        pipe = self.pipeline
        x = pipe.stage_inputs(inputs, self.index)   # shared exact prefix
        y = self.stage.simulate_batch(
            genomes, library, x, rank_genes=rank_genes, device=device
        )
        for i in range(self.index, len(pipe.stages) - 1):
            x = pipe.couplings[i].apply_sim(y)
            y = pipe.stages[i + 1].exact_output_batch(x, per_genome_inputs=True)
        return y

    # hardware: the stage's own deployment, at its in-situ input
    def matmul_shape(self) -> Tuple[int, int, int]:
        return self.stage.matmul_shape()

    def slot_groups(self) -> List[Tuple[int, int]]:
        return self.stage.slot_groups()

    def mul_slot_constants(self):
        return self.stage.mul_slot_constants()

    def adjusted_compute(self, circuits, ranks, factor) -> float:
        from ..core.features.synth import _adjusted_compute

        return _adjusted_compute(self.stage, circuits, ranks, factor)

    def _deploy_input(self, inputs: Optional[np.ndarray]) -> np.ndarray:
        if inputs is None:
            inputs = self.pipeline.stage_inputs(
                self.pipeline.sample_inputs(1, seed=1), self.index
            )
        return np.asarray(inputs)

    def deploy_cost(self, specs, inputs: Optional[np.ndarray] = None):
        from ..core.features.synth import deploy_cost

        return deploy_cost(self.stage, specs,
                           inputs=self._deploy_input(inputs))

    def build_deploy(self, specs: Sequence, inputs: Optional[np.ndarray] = None,
                     *, device=None):
        return self.stage.build_deploy(specs, inputs=self._deploy_input(inputs),
                                       device=device)

    def deploy_signature(self, specs):
        """The stage's own signature — a stage view whose in-situ deploy
        input matches the standalone stage's native input shape (always
        true for stage 0) builds IDENTICAL graphs and shares the
        standalone accelerator's structural key; deeper stages, fed a
        different intermediate shape by the chain, get a shape-prefixed
        family of their own."""
        sig = self.stage.deploy_signature(specs)
        if sig is None:
            return None
        family, classes = sig
        native = getattr(self, "_native_shape_cache", None)
        if native is None:
            native = np.shape(self.stage.sample_inputs(1, seed=1))
            self._native_shape_cache = native
        if self._insitu_shape() != native:
            family = ("stage_view", self._insitu_shape()) + tuple(family)
        return family, classes

    def _insitu_shape(self) -> Tuple[int, ...]:
        """Shape of this stage's deploy example input (the pipeline input
        propagated through the exact prefix); cached — signature lookups
        must not re-run the prefix simulation per genome."""
        shape = getattr(self, "_insitu_shape_cache", None)
        if shape is None:
            shape = np.shape(self.pipeline.stage_inputs(
                self.pipeline.sample_inputs(1, seed=1), self.index
            ))
            self._insitu_shape_cache = shape
        return shape

    def label_fingerprint(self) -> str:
        return f"stage{self.index}@{self.pipeline.label_fingerprint()}"


# the whole chain on the device when every stage and coupling has a
# device form (registered here, after the class exists)
fused.register_fused(StagedPipeline)(fused.staged_plan)
