"""'Synthesis' — our Vivado tool-chain analogue (ground-truth labels).

The paper's ground truth for one accelerator variant is a full Vivado
synthesis run: LUTs, power, delay.  Ours runs the variant's deployment
graph (``Accelerator.build_deploy``: rank-k matmuls, one launch per
grouped product) once on the device (that run is what ``synth_time``
times), costs the graph analytically, and turns the cost into roofline
latency and energy on a hardware cost model (``core/hw.py``: the H100 by
default, ``hw=V5E`` for the JAX package's TPU v5e model).  The QoR
ground truth is the bit-exact behavioural simulation
(``Accelerator.qor_batch``).

Cost of one grouped product (``grouped_cost``), per slot group g of
width w_g (its contraction columns), output m x n, spec rank r_g:

    flops     = sum_g 2*m*w_g*n*(1 + r_g)          base + r_g corrections
              + (n_groups - 1) * m*n                partial sums
    hbm_bytes = sum_g 4*(m*w_g + w_g*n + m*n)       operands, partial out
              + sum_g 2 * 256*r_g*4                 U and V tables

(int32 operands, float32 partials and tables, each read or written
once).  A plain deployment is one grouped product per pass; an
accelerator whose graph is more than that (the 2-D DCT's per-column
launches, a staged pipeline's chain) counts its own with a
``deploy_cost(specs, inputs=None)`` method.  These replace the JAX
package's XLA ``cost_analysis`` numbers, which have no torch meaning:
the two agree in rank order, not in value.  ``energy`` and the
dtype-adjusted compute are analytical; under ``hw=V5E`` they are
identical to the JAX package's.

Both this and the simulation are deliberately the *slow* path; the
whole point of the paper is to call them O(n_train + n_final) times
instead of O(|space|).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # avoid circular import
    from ...accel.base import Accelerator
from ...core.acl.library import Circuit, Library
from ...device import resolve_device
from ..hw import H100_SXM, Hardware, roofline

__all__ = [
    "SynthResult",
    "deploy_cost",
    "grouped_cost",
    "synthesize_batch",
    "label_variants",
    "LABEL_KEYS",
    "DEFAULT_QOR_SEED",
]

# the per-genome record label_variants produces (the same keys as the
# JAX package's, so label records interchange)
LABEL_KEYS = ("qor", "latency", "energy", "flops", "hbm_bytes",
              "synth_time", "sim_time")

# default seed for the QoR evaluation inputs (shared with the JAX
# package, so both label the same images)
DEFAULT_QOR_SEED = 1234


class SynthResult(dict):
    """{'flops', 'hbm_bytes', 'latency', 'energy', 'wall_time', ...}"""


def grouped_cost(m: int, n: int, groups, specs) -> Dict[str, float]:
    """Analytic {'flops', 'hbm_bytes'} of one grouped rank-k product:
    an (m, k) @ (k, n) matmul whose contraction is split into ``groups``
    with one spec each (the formula in the module docstring)."""
    flops = float((len(groups) - 1) * m * n)
    byts = 0.0
    for (s, e), sp in zip(groups, specs):
        w = e - s
        flops += 2.0 * m * w * n * (1 + sp.rank)
        byts += 4.0 * (m * w + w * n + m * n) + 2 * 256.0 * sp.rank * 4
    return {"flops": flops, "hbm_bytes": byts}


def deploy_cost(accel, specs, inputs=None) -> Dict[str, float]:
    """Analytic {'flops', 'hbm_bytes'} of ``build_deploy(specs, inputs)``'s
    graph: the accelerator's own count where it has one (``inputs``, the
    deploy input, sets its m), else one grouped product of
    ``matmul_shape()`` per deployment pass."""
    own = getattr(accel, "deploy_cost", None)
    if own is not None:
        return own(specs, inputs=inputs)
    m, _, n = accel.matmul_shape()
    passes = getattr(accel, "deploy_passes", 1)
    cost = grouped_cost(m, n, accel.slot_groups(), specs)
    return {k: v * passes for k, v in cost.items()}


def _adjusted_compute(accel, circuits, ranks, factor) -> float:
    """Dtype-aware MXU cost (bf16-MAC equivalents) of the variant's
    faithful deployment: per slot, 2*m*width*n * (factor(width) +
    rank) — truncation circuits deploy natively at narrow width (cheap),
    exotic circuits pay int8 base + bf16 corrections (DESIGN.md §2).
    ``factor`` is a cost model's ``dtype_cost_factor`` (time) or
    ``energy_factor``.  Reads ``matmul_shape()`` as the JAX package does,
    so that under ``V5E`` it is the reference's number."""
    if hasattr(accel, "adjusted_compute"):
        return accel.adjusted_compute(circuits, ranks, factor)
    mul_idx = accel.mul_slot_indices()
    m, ktot, n = accel.matmul_shape()
    groups = accel.slot_groups()
    passes = getattr(accel, "deploy_passes", 1)
    total = 0.0
    for (s0, e0), i, r in zip(groups, mul_idx, ranks):
        c = circuits[i]
        base = factor(c.deploy_width)
        rank = c.deploy_rank if r is None else (
            0 if c.native_width is not None else int(r)
        )
        total += 2.0 * m * (e0 - s0) * n * (base + rank)
    return total * passes


def _finish_record(accel, circuits, ranks, specs, synth: dict,
                   wall: float, cache_hit: bool,
                   hw: Hardware = H100_SXM) -> SynthResult:
    """Full per-variant label record from the graph's cost numbers;
    latency and energy are computed per variant from its circuits and
    ranks on the cost model ``hw``: latency at each width's rate,
    energy at each width's energy per MAC."""
    out = SynthResult()
    out["flops"] = synth["flops"]
    out["hbm_bytes"] = synth["hbm_bytes"]
    out["wall_time"] = wall
    adj = _adjusted_compute(accel, circuits, ranks, hw.dtype_cost_factor)
    out["mxu_flops_adjusted"] = adj
    rt = roofline(adj, out["hbm_bytes"], 0.0, hw=hw)
    out["latency"] = rt.t_serial
    # energy = the MARGINAL arithmetic energy of the variant (MXU MACs at
    # their dtype rate + the rank-k lookup-table traffic).  Input/output
    # streaming bytes are identical across variants of one accelerator
    # (board-level cost in the paper's terms) and would flatten the
    # objective to a ~0.2% spread on the small MCM matmuls.
    lut_bytes = sum(256.0 * 4 * 2 * sp.rank for sp in specs)
    adj_e = _adjusted_compute(accel, circuits, ranks, hw.energy_factor)
    out["energy"] = adj_e * hw.e_flop + lut_bytes * hw.e_hbm_byte
    out["cache_hit"] = cache_hit
    return out


def _identity_signature(accel, specs) -> tuple:
    """Exact per-slot circuit identity (the cache key: the cached graph
    counts do not depend on the cost model)."""
    return (accel.name,) + tuple(
        (s.name, s.rank, s.trunc_bits) for s in specs
    )


def _synthesize(accel, specs, device: torch.device) -> Tuple[dict, float]:
    """Run one variant's deployment graph once on ``device`` (the rank-k
    route) and cost it; returns ({'flops', 'hbm_bytes'}, wall seconds
    until the card has finished the graph)."""
    t0 = time.perf_counter()
    fn, args = accel.build_deploy(specs, device=device)
    with torch.no_grad():
        fn(*args, path="mxu")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return deploy_cost(accel, specs), wall


def synthesize_batch(
    accel: Accelerator,
    variants: Sequence[Tuple[Sequence[Circuit], Sequence[Optional[int]]]],
    *,
    cache: Optional[dict] = None,
    progress: Optional[callable] = None,
    device=None,
    hw: Hardware = H100_SXM,
) -> List[SynthResult]:
    """Population-scale synthesis: one call for a whole genome batch.

    ``variants`` is a list of decoded ``(circuits, ranks)`` pairs.  The
    batch is deduplicated on exact circuit identity before anything runs;
    each unique deployment runs once on ``device`` (default ``"cuda"``).
    The genome that paid a run carries its wall time, riders carry 0.0.
    ``cache`` (a dict) keeps each deployment's graph counts keyed on
    circuit identity across calls; latency and energy are made from
    them on ``hw`` at every hit, so one cache serves any cost model."""
    from ...kernels.approx_matmul import from_circuit

    dev = resolve_device(device)
    mul_idx = accel.mul_slot_indices()
    n = len(variants)
    results: List[Optional[SynthResult]] = [None] * n
    done = 0

    def _emit(t: int, rec: SynthResult) -> None:
        nonlocal done
        results[t] = rec
        done += 1
        if progress is not None:
            progress(done, n)

    for t, (circuits, ranks) in enumerate(variants):
        specs = [from_circuit(circuits[i], r) for i, r in zip(mul_idx, ranks)]
        ikey = _identity_signature(accel, specs)
        if cache is not None and ikey in cache:
            _emit(t, _finish_record(accel, circuits, ranks, specs,
                                    cache[ikey], 0.0, cache_hit=True, hw=hw))
            continue
        synth, wall = _synthesize(accel, specs, dev)
        if cache is not None:
            cache[ikey] = dict(synth)
        _emit(t, _finish_record(accel, circuits, ranks, specs, synth, wall,
                                cache_hit=False, hw=hw))
    return results


def label_variants(
    accel: Accelerator,
    genomes: np.ndarray,
    library: Library,
    *,
    rank_genes: bool = False,
    qor_inputs: Optional[np.ndarray] = None,
    cache: Optional[dict] = None,
    progress: Optional[callable] = None,
    device=None,
    hw: Hardware = H100_SXM,
) -> Dict[str, np.ndarray]:
    """Ground-truth labels for a genome batch on ``device`` (default
    ``"cuda"``) on the cost model ``hw`` (default the H100's; ``hw.V5E``
    gives the JAX package's labels): hardware via ``synthesize_batch``, QoR via ONE batched
    behavioural ``qor_batch`` call — values bit-exact versus the
    per-genome loop.  Returns arrays keyed
    {'qor','latency','energy','flops','hbm_bytes','synth_time','sim_time'}.
    ``sim_time`` is the batch's wall clock amortized evenly per genome."""
    dev = resolve_device(device)
    genomes = np.atleast_2d(genomes)
    n = len(genomes)
    if qor_inputs is None:
        qor_inputs = accel.sample_inputs(4, seed=DEFAULT_QOR_SEED)
    out = {k: np.zeros(n) for k in LABEL_KEYS}
    t0 = time.perf_counter()
    out["qor"][:] = accel.qor_batch(
        genomes, library, qor_inputs, rank_genes=rank_genes, device=dev
    )
    out["sim_time"][:] = (time.perf_counter() - t0) / max(n, 1)
    variants = [accel.decode(g, library, rank_genes=rank_genes)
                for g in genomes]
    records = synthesize_batch(
        accel, variants, cache=cache, progress=progress, device=dev, hw=hw,
    )
    for t, sr in enumerate(records):
        out["latency"][t] = sr["latency"]
        out["energy"][t] = sr["energy"]
        out["flops"][t] = sr["flops"]
        out["hbm_bytes"][t] = sr["hbm_bytes"]
        out["synth_time"][t] = sr["wall_time"]
    return out
