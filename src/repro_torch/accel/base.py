"""Accelerator abstraction: the paper's 'target application' objects.

An ``Accelerator`` exposes
  * ``slots`` — the approximable arithmetic sites (the DSE genome decodes
    one circuit per slot, optionally plus a correction-rank gene),
  * a bit-exact *behavioral* simulator (numpy, table-driven) for QoR,
    with a torch population engine (``accel.fused``) for genome batches,
  * a *deployment* constructor: the rank-k matmul graph whose analytic cost
    provides the hardware ground truth (the Vivado analogue; see
    core/features/synth.py),
  * deterministic sample inputs.

Genome convention: genes[i] indexes ``library.kind(slots[i].kind)``.
With ``rank_genes=True`` the genome doubles: genes[n_slots + i] selects a
correction rank in RANK_CHOICES for slot i (beyond-paper axis).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.acl.library import Circuit, Library

__all__ = ["Slot", "Accelerator", "RANK_CHOICES", "decode_genome",
           "gene_sizes", "grouped_deploy_signature"]

# rank gene vocabulary (beyond-paper DSE axis); index 0 = paper-faithful
# deterministic rank (circuit.eff_rank)
RANK_CHOICES: Tuple[Optional[int], ...] = (None, 0, 1, 2, 4, 8)


@dataclass(frozen=True)
class Slot:
    name: str
    kind: str        # "mul8u" | "mul8s" | "add16"
    weight: float    # relative MAC count of this slot per output element


class Accelerator:
    """Base class; subclasses define slots + simulate() + deploy info."""

    name: str = "base"
    slots: List[Slot] = []
    # True when simulate()/exact_output() accept inputs with an arbitrary
    # leading genome axis (vectorized accelerators set this; staged
    # pipelines use it to propagate per-genome intermediates exactly)
    batched_sim: bool = False

    # --- genome ---------------------------------------------------------
    def gene_sizes(self, library: Library, *, rank_genes: bool = False) -> np.ndarray:
        return gene_sizes(self.slots, library, rank_genes=rank_genes)

    def decode(
        self, genome: np.ndarray, library: Library, *, rank_genes: bool = False
    ) -> Tuple[List[Circuit], List[Optional[int]]]:
        return decode_genome(genome, self.slots, library, rank_genes=rank_genes)

    def exact_genome(self, library: Library, *, rank_genes: bool = False) -> np.ndarray:
        g = [library.exact_index(s.kind) for s in self.slots]
        if rank_genes:
            # one rank gene per MULTIPLIER slot; index 1 => rank 0
            g = g + [1] * len(self.mul_slot_indices())
        return np.array(g, dtype=np.int64)

    # --- behavior -------------------------------------------------------
    def sample_inputs(self, n: int, seed: int = 0) -> np.ndarray:
        raise NotImplementedError

    def simulate(self, circuits: Sequence[Circuit], inputs: np.ndarray) -> np.ndarray:
        """Bit-exact behavioral output under the slot assignment."""
        raise NotImplementedError

    def exact_output(self, inputs: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # --- population (genome-batch) behavior --------------------------------
    def simulate_batch(
        self,
        genomes: np.ndarray,
        library: Library,
        inputs: np.ndarray,
        *,
        rank_genes: bool = False,
        per_genome_inputs: bool = False,
        device=None,
    ) -> np.ndarray:
        """(G, ...) stacked behavioral outputs for a genome batch, run by
        the torch population engine (``accel.fused``) on ``device``
        (default ``"cuda"``).

        ``per_genome_inputs=True`` means ``inputs`` carries one input set
        per genome on a leading axis.  Bit-exact versus looping
        ``simulate`` per genome."""
        from . import fused

        return fused.simulate_batch(
            self, genomes, library, inputs, rank_genes=rank_genes,
            per_genome_inputs=per_genome_inputs, device=device,
        )

    def exact_output_batch(
        self, inputs: np.ndarray, *, per_genome_inputs: bool = False
    ) -> np.ndarray:
        """Exact output over a (G, ...) per-genome input stack."""
        if not per_genome_inputs or self.batched_sim:
            return self.exact_output(inputs)
        return np.stack([self.exact_output(x) for x in inputs])

    def qor_batch(
        self,
        genomes: np.ndarray,
        library: Library,
        inputs: np.ndarray,
        *,
        rank_genes: bool = False,
        peak: float | None = None,
        device=None,
    ) -> np.ndarray:
        """Per-genome QoR vector; the exact reference is computed ONCE
        for the whole population.  Where the accelerator's plan has an
        integer exact reference, the population's outputs and their
        integer SSE stay on ``device`` (default ``"cuda"``) and only the
        (G,) SSE vector comes back for the float64 PSNR finish.
        Otherwise the host takes ``psnr_batch`` of ``simulate_batch``
        (which runs on ``device``) against ``exact_output``: the split of
        an accelerator whose output is finished on the host in float64.
        An accelerator with no plan and no ``simulate_batch`` of its own
        raises."""
        from . import fused

        return fused.qor_batch(
            self, genomes, library, inputs, rank_genes=rank_genes,
            peak=peak, device=device,
        )

    # --- deployment (for synthesis) -----------------------------------------
    def matmul_shape(self) -> Tuple[int, int, int]:
        """(m, k, n) of the accelerator's canonical matmul deployment form
        (im2col for filters, transform matrix for DCT)."""
        raise NotImplementedError

    def deploy_signature(self, specs: Sequence) -> Optional[Tuple[tuple, tuple]]:
        """``(family, classes)`` structural key of ``build_deploy(specs)``'s
        graph.  Two spec lists with equal signatures build graphs of
        equal cost.

        ``family`` identifies the graph constructor + fixed geometry (the
        unit of verification); ``classes`` the per-slot deployment
        structure.  The default is conservative: family is this
        accelerator's labeling identity (name, shapes, group widths,
        passes, fingerprint extras) and classes are the ORDERED per-slot
        (rank, truncated bits, signedness) — circuits sharing a class
        interchange, slots do not.  Accelerators whose slots are
        interchangeable (equal-width grouped matmuls) override with
        ``grouped_deploy_signature``.  Return None to opt out of
        structural keying entirely."""
        try:
            shape: Tuple = tuple(int(v) for v in self.matmul_shape())
        except NotImplementedError:
            shape = ()
        try:
            widths: Tuple = tuple(int(e - s) for s, e in self.slot_groups())
        except NotImplementedError:
            widths = ()
        if hasattr(self, "label_fingerprint"):
            extra = str(self.label_fingerprint())
        else:
            extra = repr({
                k: repr(getattr(self, k))
                for k in ("seed", "batch", "seq") if hasattr(self, k)
            })
        family = (
            "accel", type(self).__name__, self.name, shape, widths,
            int(getattr(self, "deploy_passes", 1)),
            tuple((s.name, s.kind) for s in self.slots), extra,
        )
        classes = tuple(
            (int(sp.rank), int(sp.trunc_bits), bool(sp.signed))
            for sp in specs
        )
        return family, classes

    def slot_groups(self) -> List[Tuple[int, int]]:
        """K-ranges of each *multiplier* slot in the deployment matmul."""
        raise NotImplementedError

    def mul_slot_indices(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.kind.startswith("mul8")]

    def mul_slot_constants(self) -> List[Optional[int]]:
        """Per-multiplier-slot constant second operand (None = variable).
        Constant-operand slots get column-conditional error features in the
        cheap extractor."""
        return [None] * len(self.mul_slot_indices())

    # --- QoR --------------------------------------------------------------
    def qor(
        self, circuits: Sequence[Circuit], inputs: np.ndarray, peak: float | None = None
    ) -> float:
        from ..core import qor as qor_mod

        ref = self.exact_output(inputs)
        out = self.simulate(circuits, inputs)
        return qor_mod.psnr(ref, out, peak)


def grouped_deploy_signature(accel: "Accelerator", specs: Sequence
                             ) -> Tuple[tuple, tuple]:
    """Structural signature for plain ``grouped_matmul`` deployments
    (one rank-k matmul per K-slot-group, partials summed): the graph is
    a sum of per-group subgraphs whose shapes depend only on each
    group's width and spec class, so slots with equal widths PERMUTE
    freely — classes are the sorted multiset of (width, rank, trunc,
    signed).  Family drops the accelerator's NAME on purpose: a
    pipeline's stage view at the same geometry (e.g. ``smoothed_dct/
    stage0`` vs ``gaussian3x3``) shares the standalone accelerator's
    compiles."""
    family = (
        "grouped",
        tuple(int(v) for v in accel.matmul_shape()),
        int(getattr(accel, "deploy_passes", 1)),
    )
    classes = tuple(sorted(
        (int(e - s), int(sp.rank), int(sp.trunc_bits), bool(sp.signed))
        for (s, e), sp in zip(accel.slot_groups(), specs)
    ))
    return family, classes


def gene_sizes(
    slots: Sequence[Slot], library: Library, *, rank_genes: bool = False
) -> np.ndarray:
    sizes = [len(library.kind(s.kind)) for s in slots]
    if rank_genes:
        sizes += [len(RANK_CHOICES)] * len(
            [s for s in slots if s.kind.startswith("mul8")]
        )
    return np.array(sizes, dtype=np.int64)


def decode_genome(
    genome: np.ndarray,
    slots: Sequence[Slot],
    library: Library,
    *,
    rank_genes: bool = False,
) -> Tuple[List[Circuit], List[Optional[int]]]:
    """-> (circuit per slot, correction rank per *multiplier* slot)."""
    n = len(slots)
    circuits = [library.kind(s.kind)[int(genome[i])] for i, s in enumerate(slots)]
    mul_idx = [i for i, s in enumerate(slots) if s.kind.startswith("mul8")]
    if rank_genes:
        ranks = [RANK_CHOICES[int(genome[n + j])] for j in range(len(mul_idx))]
    else:
        ranks = [None] * len(mul_idx)
    return circuits, ranks
