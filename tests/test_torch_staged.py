"""The port's staged pipeline (``smoothed_dct``: gaussian3x3 -> HEVC DCT)
and its two stage views against the JAX package's: ``simulate_batch``
bytes and ``qor_batch`` float64 bits, the genome layout helpers, the
label fingerprint, the deployment coupling, and the refusals of a chain
that cannot run on the device."""

import numpy as np
import pytest
import torch

from repro.accel import fused as ref_fused
from repro.accel import smoothed_dct as ref_smoothed
from repro.core.acl.library import default_library as ref_library
from repro_torch.accel import GaussianFilter, HEVCDct, SmoothedDct
from repro_torch.accel import fused, smoothed_dct
from repro_torch.core.acl.library import default_library
from repro_torch.core.features import synth
from repro_torch.hierarchy import Coupling, StagedPipeline, StageView
from repro_torch.kernels.approx_matmul import from_circuit

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()
RLIB = ref_library()


def _both(view):
    """(port accelerator, reference accelerator): the pipeline for view
    None, else its stage view ``view``."""
    mine, ref = SmoothedDct(), ref_smoothed.SmoothedDct()
    if view is None:
        return mine, ref
    return mine.stage_views()[view], ref.stage_views()[view]


def _pop(accel, G, seed=0, rank_genes=False):
    sizes = accel.gene_sizes(LIB, rank_genes=rank_genes)
    g = np.random.default_rng(seed).integers(0, sizes[None, :],
                                             size=(G, len(sizes)))
    g[0] = accel.exact_genome(LIB, rank_genes=rank_genes)
    return g.astype(np.int64)


VIEWS = [None, 0, 1]


@pytest.mark.parametrize("view", VIEWS)
def test_simulate_batch_matches_reference_bytes(view):
    accel, ref = _both(view)
    g = _pop(accel, 5, seed=3)
    x = accel.sample_inputs(2, seed=2)
    got = accel.simulate_batch(g, LIB, x, device="cpu")
    want = ref_fused._numpy_reference("sim", ref, g, RLIB, x,
                                      rank_genes=False)
    assert got.shape == want.shape == (5, 2 * 49, 4, 4)
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("peak", [None, 255.0])
@pytest.mark.parametrize("view", VIEWS)
def test_qor_batch_matches_reference_bits(view, peak):
    accel, ref = _both(view)
    g = _pop(accel, 6, seed=8, rank_genes=True)
    x = accel.sample_inputs(2, seed=5)
    got = accel.qor_batch(g, LIB, x, rank_genes=True, peak=peak,
                          device="cpu")
    want = ref_fused._numpy_reference("qor", ref, g, RLIB, x,
                                      rank_genes=True, peak=peak)
    assert got.dtype == np.float64
    assert got.tobytes() == want.tobytes()
    assert got[0] == 100.0
    for t in range(2):
        circuits, _ = ref.decode(g[t], RLIB, rank_genes=True)
        assert got[t] == ref.qor(circuits, x, peak)


def test_stage_view_per_genome_inputs_match_reference():
    accel, ref = _both(1)
    g = _pop(accel, 3, seed=4)
    x = accel.sample_inputs(1, seed=6)
    xg = np.stack([x, np.clip(x + 3, 0, 255), np.clip(x - 5, 0, 255)])
    got = accel.simulate_batch(g, LIB, xg, per_genome_inputs=True,
                               device="cpu")
    want = ref_fused._numpy_reference("sim", ref, g, RLIB, xg,
                                      rank_genes=False,
                                      per_genome_inputs=True)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("rank_genes", [False, True])
def test_genome_layout_round_trips_as_reference(rank_genes):
    accel, ref = _both(None)
    g = _pop(accel, 1, seed=9, rank_genes=rank_genes)[0]
    parts = accel.split_genome(g, rank_genes=rank_genes)
    want = ref.split_genome(g, rank_genes=rank_genes)
    assert [p.tobytes() for p in parts] == [p.tobytes() for p in want]
    back = accel.assemble_genome(parts, rank_genes=rank_genes)
    assert back.dtype == np.int64 and np.array_equal(back, g)
    assert accel.stage_slot_counts() == [17, 28]
    assert accel.stage_mul_counts() == [9, 16]


@pytest.mark.parametrize("view", VIEWS)
def test_label_fingerprint_and_signature_match_reference(view):
    accel, ref = _both(view)
    assert accel.label_fingerprint() == ref.label_fingerprint()
    circuits, ranks = accel.decode(accel.exact_genome(LIB), LIB)
    specs = [from_circuit(circuits[i], r)
             for i, r in zip(accel.mul_slot_indices(), ranks)]
    from repro.kernels.approx_matmul import from_circuit as ref_from

    rc, rr = ref.decode(ref.exact_genome(RLIB), RLIB)
    rspecs = [ref_from(rc[i], r) for i, r in zip(ref.mul_slot_indices(), rr)]
    assert accel.deploy_signature(specs) == ref.deploy_signature(rspecs)


def test_deploy_coupling_matches_reference():
    rng = np.random.default_rng(0)
    # raw gaussian accumulations of two 32x32 images, ties at .5 included
    y = rng.integers(-200, 4500, size=(2 * 900, 1)).astype(np.float32)
    y[::7] += 0.5 * 16
    got = smoothed_dct._deploy_coupling(torch.from_numpy(y))
    want = np.asarray(ref_smoothed._deploy_coupling(y))
    assert got.dtype == torch.int32
    assert got.shape == want.shape == (2 * 49 * 4, 4)
    assert np.array_equal(got.numpy(), want)


def test_chained_deployment_runs_both_stages():
    """The exact chain's rank-k deployment equals its table route, its
    rows are the DCT's of the filtered image, and its count is the sum
    of the stages' at their in-chain inputs."""
    accel = SmoothedDct()
    circuits, ranks = accel.decode(accel.exact_genome(LIB), LIB)
    specs = [from_circuit(circuits[i], r)
             for i, r in zip(accel.mul_slot_indices(), ranks)]
    fn, args = accel.build_deploy(specs, device="cpu")
    assert len(args) == 3
    got = fn(*args, path="mxu")
    assert got.shape == (49 * 4, 4)
    assert torch.equal(got, fn(*args, path="lut"))
    g_specs, h_specs = accel.split_per_mul(specs)
    x1 = accel.stage_deploy_inputs()[1]
    assert x1.shape == (1, 30, 30)
    cost = synth.deploy_cost(accel, specs)
    want = synth.deploy_cost(GaussianFilter(), g_specs)
    h = HEVCDct().deploy_cost(h_specs, inputs=x1)
    assert cost == {k: want[k] + h[k] for k in want}
    # the in-situ DCT view counts its stage at the same input
    assert synth.deploy_cost(accel.stage_views()[1], h_specs) == h


def test_chain_without_a_device_form_raises():
    """A coupling without a torch twin, or a host-tailed plan feeding a
    later stage, is refused: no stage falls back to a numpy body."""
    g = _pop(SmoothedDct(), 2)
    x = GaussianFilter().sample_inputs(1)
    no_twin = StagedPipeline("p", [GaussianFilter(), HEVCDct()],
                             [Coupling(name="no_such_twin",
                                       sim=lambda y: y)])
    with pytest.raises(NotImplementedError, match="no torch twin"):
        no_twin.simulate_batch(g, LIB, x, device="cpu")
    tailed = StagedPipeline("q", [HEVCDct(), HEVCDct()])
    gq = _pop(tailed, 2)
    with pytest.raises(NotImplementedError, match="cannot feed"):
        tailed.qor_batch(gq, LIB, x, device="cpu")
    assert isinstance(SmoothedDct().stage_views()[0], StageView)
    assert fused._COUPLINGS["u8_clip_reblock"] is not None


def test_accelerator_without_plan_or_own_simulation_raises():
    """The host PSNR finish needs a ``simulate_batch``: an accelerator
    with no plan and none of its own still raises."""
    from repro_torch.accel.base import Accelerator

    class Planless(Accelerator):
        name = "planless"
        slots = GaussianFilter.slots

        def exact_output(self, inputs):
            return np.asarray(inputs)

    g = _pop(GaussianFilter(), 2)
    x = GaussianFilter().sample_inputs(1)
    for call in (Planless().qor_batch, Planless().simulate_batch):
        with pytest.raises(NotImplementedError, match="no population plan"):
            call(g, LIB, x, device="cpu")
