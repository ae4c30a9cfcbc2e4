"""The port's ``label_variants`` against the JAX package's on a fixed
64-genome gaussian3x3 set (the smaller fixed sets of the MCM rows and
the HEVC DCT are ``tests/test_torch_labels_families.py``'s, the smoothed
DCT pipeline's ``tests/test_torch_labels_smoothed.py``'s, both through
``tests/_labels_family.py``), all on the JAX package's cost model
(``hw=V5E``).  ``qor`` and ``energy`` must be bit-identical.
``flops`` and ``hbm_bytes`` are counted analytically on the port's own
deployment graph where the JAX package reads XLA's cost analysis, so
they are held by rank order (Spearman) only."""

import numpy as np
import pytest
import torch
from scipy.stats import spearmanr

from repro.accel import GaussianFilter as RefGaussian
from repro.accel import smoothed_dct as ref_smoothed
from repro.core.features import pipelines as ref_pipelines
from repro.core.features import synth as ref_synth
from repro_torch.accel import GaussianFilter, SmoothedDct
from repro_torch.core.features import pipelines, synth
from repro_torch.core.hw import V5E

from _labels_family import (FAMILIES, FAMILY_REFERENCE_KEY, LIB, RLIB,
                            _genomes, _label_family)
from _torch_threads import bounded_torch_threads  # noqa: F401

# measured on this 64-genome set: flops 0.959, hbm_bytes 0.881
MIN_SPEARMAN = {"flops": 0.9, "hbm_bytes": 0.8}

def _label_both():
    """(port labels, reference labels) of the fixed 64-genome set."""
    g = _genomes()
    x = GaussianFilter().sample_inputs(2, seed=synth.DEFAULT_QOR_SEED)
    got = synth.label_variants(GaussianFilter(), g, LIB, qor_inputs=x,
                               cache={}, device="cpu", hw=V5E)
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
    """Pipelines B and E (per-circuit synthesis features) now build: on
    the CPU when asked, E with B's columns and the accelerator-level
    columns that D adds to C; with no device on a machine without a GPU
    they raise.  Their per-circuit features are held against the JAX
    package's in ``tests/test_torch_paper_figs.py``."""
    g = _genomes(8, seed=5)
    acc = GaussianFilter()
    X = pipelines.build_extractor(pipeline, acc, LIB, device="cpu",
                                  hw=V5E)(g)
    assert X.shape[0] == 8 and np.all(np.isfinite(X))
    if pipeline == "E":
        width = {p: pipelines.build_extractor(p, acc, LIB)(g).shape[1]
                 for p in ("C", "D")}
        b = pipelines.build_extractor("B", acc, LIB, device="cpu", hw=V5E)
        assert X.shape[1] == b(g).shape[1] + width["D"] - width["C"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipelines.build_extractor(pipeline, acc, LIB)


if __name__ == "__main__":
    # prints the numbers PERF.md quotes: Spearman and median port /
    # reference ratio of the two hardware counts on the 64-genome set
    for name in ["gaussian3x3"] + list(FAMILIES):
        got, want = (_label_both() if name == "gaussian3x3"
                     else _label_family(name))
        for key in ("flops", "hbm_bytes"):
            ref_key = FAMILY_REFERENCE_KEY.get((name, key), key)
            print(f"{name} {key}: spearman "
                  f"{spearmanr(got[key], want[ref_key])[0]:.4f}"
                  f" against {ref_key}, median port/reference "
                  f"{np.median(got[key] / want[ref_key]):.4f}")
            if ref_key != key:
                print(f"{name} {key}: spearman "
                      f"{spearmanr(got[key], want[key])[0]:.4f} against "
                      f"the chained graph's, whose against {ref_key}: "
                      f"{spearmanr(want[key], want[ref_key])[0]:.4f}")
    # the smoothed DCT's genomes 1 and 2: the chained graph's XLA flops,
    # fusions and copies of the inter-pass round, against its stages
    # compiled alone at their in-chain inputs
    import jax

    from repro.core.features.synth import _compile_cost
    from repro.kernels.approx_matmul import from_circuit as ref_spec

    pipe = ref_smoothed.SmoothedDct()
    x1 = pipe.couplings[0].apply_sim(
        pipe.stages[0].exact_output(pipe.sample_inputs(1, seed=1)))
    for i in (1, 2):
        circuits, ranks = pipe.decode(_genomes(16, accel=SmoothedDct())[i],
                                      RLIB)
        specs = [ref_spec(circuits[j], r)
                 for j, r in zip(pipe.mul_slot_indices(), ranks)]
        fn, args = pipe.build_deploy(specs)
        hlo = jax.jit(fn).lower(*args).compile().as_text()
        s0, s1 = pipe.split_per_mul(specs)
        print(f"smoothed_dct genome {i}: chained XLA flops "
              f"{_compile_cost(fn, args)['flops']:.6g}, "
              f"{hlo.count(' fusion(')} fusions, "
              f"{hlo.count('round-nearest')} rounds; stages alone "
              f"{_compile_cost(*pipe.stages[0].build_deploy(s0))['flops']:.6g}"
              f" + {_compile_cost(*pipe.stages[1].build_deploy(s1, inputs=x1))['flops']:.6g}")
