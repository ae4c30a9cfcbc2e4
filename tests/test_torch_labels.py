"""The port's ``label_variants`` against the JAX package's on a fixed
64-genome gaussian3x3 set.  ``qor`` and ``energy`` must be bit-identical.
``flops`` and ``hbm_bytes`` are counted analytically on the port's own
deployment graph where the JAX package reads XLA's cost analysis, so
they are held by rank order (Spearman) only."""

import numpy as np
import pytest
import torch
from scipy.stats import spearmanr

from repro.accel import GaussianFilter as RefGaussian
from repro.core.acl.library import default_library as ref_library
from repro.core.features import pipelines as ref_pipelines
from repro.core.features import synth as ref_synth
from repro_torch.accel import GaussianFilter
from repro_torch.core.acl.library import default_library
from repro_torch.core.features import pipelines, synth

LIB = default_library()
RLIB = ref_library()

# measured on this 64-genome set: flops 0.959, hbm_bytes 0.881
MIN_SPEARMAN = {"flops": 0.9, "hbm_bytes": 0.8}


def _genomes(n=64, seed=7):
    accel = GaussianFilter()
    sizes = accel.gene_sizes(LIB)
    g = np.random.default_rng(seed).integers(0, sizes[None, :],
                                             size=(n, len(sizes)))
    g[0] = accel.exact_genome(LIB)
    return g


def _label_both():
    """(port labels, reference labels) of the fixed 64-genome set."""
    g = _genomes()
    x = GaussianFilter().sample_inputs(2, seed=synth.DEFAULT_QOR_SEED)
    got = synth.label_variants(GaussianFilter(), g, LIB, qor_inputs=x,
                               cache={}, device="cpu")
    want = ref_synth.label_variants(RefGaussian(), g, RLIB, qor_inputs=x,
                                    cache={})
    return got, want


@pytest.fixture(scope="module")
def both_labels():
    return _label_both()


@pytest.mark.parametrize("key", ["qor", "energy"])
def test_labels_bit_identical(both_labels, key):
    got, want = both_labels
    assert got[key].dtype == want[key].dtype == np.float64
    assert got[key].tobytes() == want[key].tobytes()


@pytest.mark.parametrize("key", ["flops", "hbm_bytes"])
def test_hardware_counts_keep_rank_order(both_labels, key):
    got, want = both_labels
    rho = spearmanr(got[key], want[key])[0]
    assert rho >= MIN_SPEARMAN[key], rho


def test_label_keys_and_shapes(both_labels):
    got, want = both_labels
    assert tuple(got) == synth.LABEL_KEYS == ref_synth.LABEL_KEYS
    for k in synth.LABEL_KEYS:
        assert got[k].shape == want[k].shape
        assert np.all(np.isfinite(got[k]))


def test_synthesis_cache_and_deploy_error():
    accel = GaussianFilter()
    g = _genomes(6, seed=2)
    variants = [accel.decode(row, LIB) for row in g]
    cache = {}
    first = synth.synthesize_batch(accel, variants, cache=cache, device="cpu")
    again = synth.synthesize_batch(accel, variants, cache=cache, device="cpu")
    assert len(cache) == len({tuple(r) for r in g})
    assert all(r["cache_hit"] and r["wall_time"] == 0.0 for r in again)
    for a, b in zip(first, again):
        for k in ("flops", "hbm_bytes", "energy", "latency"):
            assert a[k] == b[k]
    # row 0 is the exact design: its deployment graph IS the behaviour
    from repro_torch.kernels.approx_matmul import from_circuit

    circuits, ranks = variants[0]
    specs = [from_circuit(circuits[i], r)
             for i, r in zip(accel.mul_slot_indices(), ranks)]
    fn, args = accel.build_deploy(specs, device="cpu")
    assert torch.equal(fn(*args, path="mxu"), fn(*args, path="lut"))


def test_deploy_cost_formula():
    from repro_torch.kernels.approx_matmul import from_circuit

    accel = GaussianFilter()
    specs = [from_circuit(LIB[n]) for n in
             ["mul8u_exact"] * 8 + ["mul8u_bam6"]]     # ranks 0 x8, 4
    m, _, n = accel.matmul_shape()
    cost = synth.deploy_cost(accel, specs)
    assert cost["flops"] == 8 * m * n + 9 * 2 * m * n + 4 * 2 * m * n
    assert cost["hbm_bytes"] == 9 * 4 * (2 * m * n + 1) + 2 * 256 * 4 * 4


@pytest.mark.parametrize("pipeline", ["C", "D", "F"])
def test_pipeline_features_match_reference(pipeline):
    g = _genomes(16, seed=5)
    ext = pipelines.build_extractor(pipeline, GaussianFilter(), LIB)
    ref = ref_pipelines.build_extractor(pipeline, RefGaussian(), RLIB)
    assert np.array_equal(ext(g), ref(g))


@pytest.mark.parametrize("pipeline", ["B", "E"])
def test_synth_feature_pipelines_wait_for_a_later_slice(pipeline):
    with pytest.raises(NotImplementedError, match="later slice"):
        pipelines.build_extractor(pipeline, GaussianFilter(), LIB)


if __name__ == "__main__":
    # prints the numbers PERF.md quotes: Spearman and median port /
    # reference ratio of the two hardware counts on the 64-genome set
    got, want = _label_both()
    for key in ("flops", "hbm_bytes"):
        print(f"{key}: spearman {spearmanr(got[key], want[key])[0]:.4f}, "
              f"median port/reference "
              f"{np.median(got[key] / want[key]):.4f}")
