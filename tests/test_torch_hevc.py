"""The port's MCM rows and 2-D HEVC DCT against the JAX package's numpy
engine and per-genome loop: the same shapes, dtype and bytes for
``simulate_batch`` (shared and per-genome inputs), the same float64 bits
for ``qor_batch`` (with and without rank genes, with ``peak``), the same
``signed16`` and ``_blocks``; plus the range checks that keep the
population gather inside its tables, and the deployment graph."""

import numpy as np
import pytest
import torch

from repro.accel import fused as ref_fused
from repro.accel import hevc_dct as ref_hevc
from repro.accel.base import Accelerator as RefAccelerator
from repro.core.acl.library import default_library as ref_library
from repro_torch.accel import HEVCDct, MCMAccelerator, hevc_dct
from repro_torch.core.acl.library import default_library
from repro_torch.core.features import synth
from repro_torch.kernels.approx_matmul import from_circuit

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()
RLIB = ref_library()

# (port accelerator, JAX package accelerator) factories
ACCELS = {
    **{f"mcm{r + 1}": (lambda r=r: (MCMAccelerator(r),
                                    ref_hevc.MCMAccelerator(r)))
       for r in range(4)},
    "hevc_dct4x4": lambda: (HEVCDct(), ref_hevc.HEVCDct()),
}


def _pop(accel, G, seed=0, rank_genes=False):
    """Random population; row 0 is the all-exact genome."""
    sizes = accel.gene_sizes(LIB, rank_genes=rank_genes)
    g = np.random.default_rng(seed).integers(0, sizes[None, :],
                                             size=(G, len(sizes)))
    g[0] = accel.exact_genome(LIB, rank_genes=rank_genes)
    return g.astype(np.int64)


def _per_genome_inputs(accel, x, G, seed):
    """One perturbed copy of ``x`` per genome, kept in the input domain."""
    rng = np.random.default_rng(seed)
    lo, hi = (-128, 127) if isinstance(accel, MCMAccelerator) else (0, 255)
    xg = np.repeat(x[None], G, axis=0) + rng.integers(-2, 3, (G,) + x.shape)
    return np.clip(xg, lo, hi).astype(x.dtype)


@pytest.mark.parametrize("per_genome", [False, True])
@pytest.mark.parametrize("name", list(ACCELS))
def test_simulate_batch_matches_reference_bytes(name, per_genome):
    accel, ref = ACCELS[name]()
    G = 6
    g = _pop(accel, G, seed=len(name))
    x = accel.sample_inputs(2, seed=3)
    if per_genome:
        x = _per_genome_inputs(accel, x, G, seed=5)
    got = accel.simulate_batch(g, LIB, x, per_genome_inputs=per_genome,
                               device="cpu")
    want = ref_fused._numpy_reference("sim", ref, g, RLIB, x,
                                      rank_genes=False,
                                      per_genome_inputs=per_genome)
    loop = RefAccelerator.simulate_batch(ref, g, RLIB, x,
                                         per_genome_inputs=per_genome)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    assert np.array_equal(got, loop)


@pytest.mark.parametrize("case", [
    dict(rank_genes=False, peak=None),
    dict(rank_genes=True, peak=None),
    dict(rank_genes=False, peak=255.0),
])
@pytest.mark.parametrize("name", list(ACCELS))
def test_qor_batch_matches_reference_bits(name, case):
    accel, ref = ACCELS[name]()
    g = _pop(accel, 8, seed=11, rank_genes=case["rank_genes"])
    x = accel.sample_inputs(2, seed=4)
    got = accel.qor_batch(g, LIB, x, device="cpu", **case)
    want = ref_fused._numpy_reference("qor", ref, g, RLIB, x, **case)
    assert got.dtype == np.float64
    assert got.tobytes() == want.tobytes()
    assert got[0] == 100.0
    for t in range(3):
        circuits, _ = ref.decode(g[t], RLIB, rank_genes=case["rank_genes"])
        assert got[t] == ref.qor(circuits, x, case["peak"])


def test_signed16_and_blocks_match_reference():
    rng = np.random.default_rng(2)
    a = rng.integers(-70000, 70000, size=4096)
    b = rng.integers(-70000, 70000, size=4096)
    for c in LIB.kind("add16"):
        got = hevc_dct.signed16(c.fn)(a, b)
        want = ref_hevc.signed16(c.fn)(a, b)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes(), c.name
    imgs = rng.integers(0, 256, size=(3, 2, 30, 34))
    got = hevc_dct._blocks(imgs)
    assert got.shape == (3, 2 * 7 * 8, 4, 4)
    assert got.tobytes() == ref_hevc._blocks(imgs).tobytes()
    assert torch.equal(hevc_dct._blocks_torch(torch.from_numpy(imgs)),
                       torch.from_numpy(got))


@pytest.mark.parametrize("name,bad", [
    ("mcm1", 128), ("mcm3", -129), ("hevc_dct4x4", 256),
    ("hevc_dct4x4", -1),
])
def test_inputs_outside_the_8bit_domain_raise(name, bad):
    """The gather indexes its tables with the value (+128 when signed):
    an input outside the 8-bit domain is refused on the host."""
    accel, _ = ACCELS[name]()
    g = _pop(accel, 2)
    x = accel.sample_inputs(1, seed=0)
    x.flat[5] = bad
    for call in (accel.simulate_batch, accel.qor_batch):
        with pytest.raises(ValueError, match="must lie in"):
            call(g, LIB, x, device="cpu")


@pytest.mark.parametrize("name", list(ACCELS))
def test_exact_deployment_is_the_behaviour(name):
    """The all-exact design's rank-k deployment equals its table route and
    the exact transform it deploys."""
    accel, _ = ACCELS[name]()
    circuits, ranks = accel.decode(accel.exact_genome(LIB), LIB)
    specs = [from_circuit(circuits[i], r)
             for i, r in zip(accel.mul_slot_indices(), ranks)]
    fn, args = accel.build_deploy(specs, device="cpu")
    got = fn(*args, path="mxu")
    assert torch.equal(got, fn(*args, path="lut"))
    x = args[0].numpy().astype(np.int64)
    if isinstance(accel, MCMAccelerator):
        want = accel.exact_output(x)[:, None]
    else:
        # column j of the stage-1 rows feeds stage 2, as in the JAX
        # package's deployment
        c = hevc_dct.HEVC_C
        y = np.clip(np.round((x @ c.T) / 256.0), -128, 127)
        want = y @ c.T
    assert np.array_equal(got.numpy(), want.astype(np.float32))


def test_hevc_deploy_cost_counts_eight_products():
    """Two passes of four (m, 4) @ (4, 1) products over the 256 residual
    rows of one 32x32 image."""
    accel = HEVCDct()
    specs = [from_circuit(LIB[n]) for n in
             ["mul8s_exact"] * 15 + ["mul8s_drum4"]]
    r = specs[-1].rank
    m = 256
    cost = synth.deploy_cost(accel, specs)
    assert cost["flops"] == 2 * (4 * (3 * m + 4 * 2 * m) + 2 * m * r)
    assert cost["hbm_bytes"] == 2 * (4 * 4 * 4 * (2 * m + 1)
                                     + 2 * 256 * 4 * r)
    mcm = MCMAccelerator(2)
    assert synth.deploy_cost(mcm, specs[:4])["flops"] == 3 * m + 4 * 2 * m
