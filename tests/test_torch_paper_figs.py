"""The pieces of the paper's evaluation in the port against the JAX
package's, small and on the JAX package's cost model (``hw=V5E``), on
the CPU:

* Fig. 5's per-circuit synthesis features (pipelines B/E): flops,
  energy and rank of every multiplier circuit, and the adder row, are
  bit-identical; log-bytes and latency, counted on the port's own graph
  where the JAX package reads XLA's cost analysis, agree by rank order.
* All six pipelines build.
* Figs. 8/9's baselines on ``mcm2``: ``random_search`` and
  ``approxfpgas_search`` return the JAX package's genomes, objectives
  (bit for bit) and front masks; ``restricted_library`` holds the same
  circuits.
* Fig. 5's QoR surrogate: the port's regression tree never grows the
  empty child that gives the JAX package's NaN predictions."""

import numpy as np
import pytest
from scipy.stats import spearmanr

from repro.accel import MCMAccelerator as RefMCM
from repro.accel import approxfpgas as ref_approxfpgas
from repro.core import dse as ref_dse
from repro.core.acl.library import default_library as ref_library
from repro.core.features import synth as ref_synth
from repro_torch.accel import MCMAccelerator, approxfpgas
from repro_torch.core import dse
from repro_torch.core.acl.library import default_library
from repro_torch.core.features import pipelines, synth
from repro_torch.core.hw import V5E

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()
RLIB = ref_library()

# Spearman floors of the two columns the port counts on its own graph,
# over the 42 multiplier circuits (measured: see the printed values)
MIN_SPEARMAN = {"log10_bytes": 0.8, "latency": 0.8}
BUDGET = 12


@pytest.fixture(scope="module")
def circuit_features():
    names = [c.name for c in LIB.kind("mul8u") + LIB.kind("mul8s")]
    got = np.stack([synth.circuit_features_synth(LIB[n], device="cpu",
                                                 hw=V5E) for n in names])
    want = np.stack([ref_synth.circuit_features_synth(RLIB[n])
                     for n in names])
    return names, got, want


def test_circuit_features_bit_identical_in_flops_energy_rank(
        circuit_features):
    names, got, want = circuit_features
    assert len(names) == 42
    for col in (0, 3, 4):                      # flops, energy, rank
        assert got[:, col].tobytes() == want[:, col].tobytes(), col
    assert np.all(got[:, 5] > 0)               # the run's wall time


@pytest.mark.parametrize("col,key", [(1, "log10_bytes"), (2, "latency")])
def test_circuit_features_rank_order(circuit_features, col, key):
    _, got, want = circuit_features
    rho = spearmanr(got[:, col], want[:, col])[0]
    print(f"{key}: spearman {rho:.4f}")
    assert rho >= MIN_SPEARMAN[key], rho


def test_adder_row_is_the_reference_constant():
    for c, rc in zip(LIB.kind("add16"), RLIB.kind("add16")):
        got = synth.circuit_features_synth(c, device="cpu", hw=V5E)
        assert got.tobytes() == ref_synth.circuit_features_synth(rc).tobytes()


@pytest.mark.parametrize("pipeline", pipelines.PIPELINES)
def test_every_pipeline_builds(pipeline):
    acc = MCMAccelerator(1)
    ext = pipelines.build_extractor(pipeline, acc, LIB, device="cpu",
                                    hw=V5E)
    assert ext.pipeline == pipeline
    g = np.random.default_rng(2).integers(
        0, acc.gene_sizes(LIB)[None, :], size=(5, len(acc.slots)))
    if pipeline == "A":
        with pytest.raises(RuntimeError, match="no feature extractor"):
            ext(g)
        return
    X = ext(g)
    assert X.shape[0] == 5 and np.all(np.isfinite(X))


def test_restricted_library_names_match():
    got = [c.name for c in approxfpgas.restricted_library(LIB).circuits]
    want = [c.name for c in ref_approxfpgas.restricted_library(RLIB).circuits]
    assert got == want
    assert len(got) < len(LIB)


def test_random_search_matches_reference():
    acc, ref = MCMAccelerator(1), RefMCM(1)
    labeler = dse.default_labeler(acc, LIB, device="cpu", hw=V5E)
    got = dse.random_search(acc, LIB, n=BUDGET, seed=3, labeler=labeler,
                            device="cpu")
    want = ref_dse.random_search(ref, RLIB, n=BUDGET, seed=3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_approxfpgas_search_matches_reference():
    acc, ref = MCMAccelerator(1), RefMCM(1)
    x = acc.sample_inputs(2, seed=1234)
    g, obj, mask, rlib = approxfpgas.approxfpgas_search(
        acc, LIB, n_budget=BUDGET, seed=4, qor_inputs=x, device="cpu",
        hw=V5E)
    rg, robj, rmask, rrlib = ref_approxfpgas.approxfpgas_search(
        ref, RLIB, n_budget=BUDGET, seed=4, qor_inputs=x)
    assert np.array_equal(g, rg)
    assert obj.tobytes() == robj.tobytes()
    assert np.array_equal(mask, rmask) and mask.any()
    assert [c.name for c in rlib.circuits] == [c.name for c in rrlib.circuits]


def test_tree_split_never_leaves_an_empty_child():
    """Fig. 5's QoR surrogate (random forest) at n_train = 1000 meets
    split points between adjacent floats, whose midpoint rounds up to
    the upper value; the JAX package's CART then grows an empty child
    and predicts NaN there.  The port keeps the split it scored: equal
    predictions wherever the midpoint is exact, finite ones here."""
    from repro.core.surrogates.trees import CART as RefCART
    from repro_torch.core.surrogates.trees import CART

    a = 0.3
    b = np.nextafter(a, 1.0)
    assert 0.5 * (a + b) == b
    X = np.array([[a], [a], [b], [b]])
    y = np.array([0.0, 0.0, 1.0, 1.0])
    probe = np.array([[a], [b], [1.0]])
    got = CART(min_leaf=1).fit(X, y).predict(probe)
    assert np.array_equal(got, [0.0, 1.0, 1.0])
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        want = RefCART(min_leaf=1).fit(X, y).predict(probe)
    assert np.isnan(want[2])

    rng = np.random.default_rng(0)
    X = rng.integers(0, 50, (300, 6)) / 7.0
    y = X @ rng.random(6) + rng.random(300)
    from repro.core.surrogates import make as ref_make
    from repro_torch.core.surrogates import make

    got = make("random_forest", seed=0).fit(X, y).predict(X)
    want = ref_make("random_forest", seed=0).fit(X, y).predict(X)
    assert got.tobytes() == want.tobytes()
