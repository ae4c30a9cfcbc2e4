"""The families that ``tests/test_torch_labels.py`` and
``tests/test_torch_labels_smoothed.py`` label in both packages, on the
JAX package's cost model (``hw=V5E``), and the checks both files run:
each family's ``qor`` and ``energy`` bit-identical, its analytic
``flops`` and ``hbm_bytes`` ranking designs as XLA's counts do.  A test
file imports ``family_labels`` (a module-scoped fixture) and defines
``test_family_labels_bit_identical`` and
``test_family_hardware_counts_keep_rank_order`` over its families with
``check_bits`` and ``check_rank``."""

import numpy as np
import pytest
from scipy.stats import spearmanr

from repro.accel import hevc_dct as ref_hevc
from repro.accel import smoothed_dct as ref_smoothed
from repro.core.acl.library import default_library as ref_library
from repro.core.features import synth as ref_synth
from repro_torch.accel import GaussianFilter, HEVCDct, MCMAccelerator
from repro_torch.accel import SmoothedDct
from repro_torch.core.acl.library import default_library
from repro_torch.core.features import synth
from repro_torch.core.hw import V5E

LIB = default_library()
RLIB = ref_library()

# (port accelerator, JAX package accelerator, genomes) of the families
# held on their own fixed sets (the JAX package compiles each unique
# variant with XLA, about 0.5-1.2 s a genome on a CPU)
FAMILIES = {
    **{f"mcm{r + 1}": (lambda r=r: (MCMAccelerator(r),
                                    ref_hevc.MCMAccelerator(r)), 8)
       for r in range(4)},
    "hevc_dct4x4": (lambda: (HEVCDct(), ref_hevc.HEVCDct()), 16),
    "smoothed_dct": (lambda: (SmoothedDct(), ref_smoothed.SmoothedDct()), 16),
}
# Spearman of the port's analytic counts against the JAX package's XLA
# counts, measured on each family's fixed set (in brackets; running this
# file prints them) with the floor held below it.
#
# The smoothed DCT's flops are held against the JAX package's XLA counts
# of its two stages, each compiled alone at its in-chain input, summed
# (``_ref_stage_flops``), not against the chained graph's count.  In the
# chained graph XLA duplicates the DCT's inter-pass renormalization
# (round, clip) and its correction-table gathers into every consumer
# fusion, on some variants and not on others: genome 1 of the set
# compiles to 54 fusions holding 26 rounds, 1.06e6 flops against
# 8.4e4 + 1.04e5 for its stages alone (the coupling adds 4268, its count
# on the exact design), while genome 2 compiles to 15 fusions with 2
# rounds (the coupling's and the inter-pass one), 1.52e5 against
# 1.03e5 + 4.5e4.  The chained count follows XLA's fusion choices, not
# the work the graph does: it has 0.23 Spearman against the per-stage
# sum, and the port's count -0.24 against it, 0.82 against the sum.
FAMILY_REFERENCE_KEY = {("smoothed_dct", "flops"): "flops_per_stage"}
FAMILY_MIN_SPEARMAN = {
    "mcm1": {"flops": 0.95, "hbm_bytes": 0.9},         # [0.994, 0.976]
    "mcm2": {"flops": 0.95, "hbm_bytes": 0.9},         # [0.994, 0.976]
    "mcm3": {"flops": 0.95, "hbm_bytes": 0.9},         # [0.994, 0.976]
    "mcm4": {"flops": 0.95, "hbm_bytes": 0.9},         # [0.994, 0.976]
    "hevc_dct4x4": {"flops": 0.7, "hbm_bytes": 0.7},   # [0.744, 0.744]
    "smoothed_dct": {"flops": 0.7, "hbm_bytes": 0.7},  # [0.824, 0.767]
}


def _genomes(n=64, seed=7, accel=None):
    accel = GaussianFilter() if accel is None else accel
    sizes = accel.gene_sizes(LIB)
    g = np.random.default_rng(seed).integers(0, sizes[None, :],
                                             size=(n, len(sizes)))
    g[0] = accel.exact_genome(LIB)
    return g


def _ref_stage_flops(ref, genomes):
    """The JAX package's XLA flops of each genome's staged deployment,
    every stage compiled alone at its in-chain input, summed."""
    from repro.core.features.synth import _compile_cost
    from repro.kernels.approx_matmul import from_circuit as ref_spec

    xs = [ref.sample_inputs(1, seed=1)]
    for c, st in zip(ref.couplings, ref.stages[:-1]):
        xs.append(c.apply_sim(st.exact_output(xs[-1])))
    out = []
    for g in genomes:
        circuits, ranks = ref.decode(g, RLIB)
        specs = [ref_spec(circuits[i], r)
                 for i, r in zip(ref.mul_slot_indices(), ranks)]
        out.append(sum(
            _compile_cost(*st.build_deploy(sp, inputs=x))["flops"]
            for st, sp, x in zip(ref.stages, ref.split_per_mul(specs), xs)))
    return np.array(out)


def _label_family(name):
    """(port labels, reference labels) of a family's fixed set; the
    reference's also carry each ``FAMILY_REFERENCE_KEY`` count."""
    make, n = FAMILIES[name]
    accel, ref = make()
    g = _genomes(n, accel=accel)
    x = accel.sample_inputs(2, seed=synth.DEFAULT_QOR_SEED)
    got = synth.label_variants(accel, g, LIB, qor_inputs=x, cache={},
                               device="cpu", hw=V5E)
    want = ref_synth.label_variants(ref, g, RLIB, qor_inputs=x, cache={})
    if (name, "flops") in FAMILY_REFERENCE_KEY:
        want["flops_per_stage"] = _ref_stage_flops(ref, g)
    return got, want


@pytest.fixture(scope="module")
def family_labels():
    """Each family's labels, made on first use and kept for the module."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = _label_family(name)
        return made[name]

    return get


def check_bits(family_labels, name, key):
    got, want = family_labels(name)
    assert got[key].dtype == want[key].dtype == np.float64
    assert got[key].tobytes() == want[key].tobytes()
    assert np.all(np.isfinite(got[key]))


def check_rank(family_labels, name, key):
    got, want = family_labels(name)
    rho = spearmanr(got[key],
                    want[FAMILY_REFERENCE_KEY.get((name, key), key)])[0]
    assert rho >= FAMILY_MIN_SPEARMAN[name][key], rho
