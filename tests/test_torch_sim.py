"""The port's population engine against the JAX package's numpy engine
and per-genome loop on gaussian3x3: same shapes, int64 dtype and bytes
for ``simulate_batch``, the same float64 bits for ``qor_batch``; plus
the engine's refusals (divergent adder twin, LUT over int32)."""

import functools

import numpy as np
import pytest
import torch

from repro.accel import GaussianFilter as RefGaussian
from repro.accel import fused as ref_fused
from repro.accel.base import Accelerator as RefAccelerator
from repro.core import qor as ref_qor
from repro.core.acl.library import default_library as ref_library
from repro_torch.accel import RANK_CHOICES, GaussianFilter
from repro_torch.accel import fused
from repro_torch.core import qor
from repro_torch.core.acl import multipliers
from repro_torch.core.acl.library import Circuit, Library, default_library

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()
RLIB = ref_library()


def _pop(accel, G, seed=0, rank_genes=False):
    """Random population; row 0 is the all-exact genome."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, len(LIB.kind(s.kind)), size=G)
            for s in accel.slots]
    g = np.stack(cols, axis=1).astype(np.int64)
    g[0] = accel.exact_genome(LIB)
    if rank_genes:
        nm = len(accel.mul_slot_indices())
        g = np.concatenate(
            [g, rng.integers(0, len(RANK_CHOICES), size=(G, nm))], axis=1)
    return g


def _ref_numpy(kind, g, x, **kw):
    return ref_fused._numpy_reference(kind, RefGaussian(), g, RLIB, x, **kw)


@pytest.mark.parametrize("G,seed", [(1, 0), (10, 3), (33, 8)])
def test_simulate_batch_matches_reference_bytes(G, seed):
    accel = GaussianFilter()
    g = _pop(accel, G, seed=seed)
    x = accel.sample_inputs(2, seed=1)
    got = accel.simulate_batch(g, LIB, x, device="cpu")
    want = _ref_numpy("sim", g, x, rank_genes=False)
    loop = RefAccelerator.simulate_batch(RefGaussian(), g, RLIB, x)
    assert got.shape == want.shape == (G, 2, 30, 30)
    assert got.dtype == want.dtype == np.int64
    assert got.tobytes() == want.tobytes()
    assert np.array_equal(got, loop)


@pytest.mark.parametrize("n_images,seed", [(1, 2), (2, 5), (4, 1234)])
def test_qor_batch_matches_reference_bits(n_images, seed):
    accel = GaussianFilter()
    g = _pop(accel, 12, seed=seed)
    x = accel.sample_inputs(n_images, seed=seed)
    got = accel.qor_batch(g, LIB, x, device="cpu")
    want = _ref_numpy("qor", g, x, rank_genes=False)
    assert got.dtype == np.float64
    assert got.tobytes() == want.tobytes()
    assert got[0] == 100.0
    # and against the per-genome numpy qor of the JAX package
    for t in range(4):
        circuits, _ = RefGaussian().decode(g[t], RLIB)
        assert got[t] == RefGaussian().qor(circuits, x)


def test_qor_batch_with_peak_matches_reference():
    accel = GaussianFilter()
    g = _pop(accel, 6, seed=4)
    x = accel.sample_inputs(2, seed=3)
    got = accel.qor_batch(g, LIB, x, peak=255.0, device="cpu")
    want = _ref_numpy("qor", g, x, rank_genes=False, peak=255.0)
    assert got.tobytes() == want.tobytes()


def test_per_genome_inputs_path():
    accel = GaussianFilter()
    G = 5
    g = _pop(accel, G, seed=2)
    x = accel.sample_inputs(2, seed=4)
    rng = np.random.default_rng(0)
    xg = np.clip(
        np.repeat(x[None], G, axis=0) + rng.integers(0, 2, (G,) + x.shape),
        0, 255,
    ).astype(x.dtype)
    got = accel.simulate_batch(g, LIB, xg, per_genome_inputs=True,
                               device="cpu")
    want = _ref_numpy("sim", g, xg, rank_genes=False, per_genome_inputs=True)
    assert got.dtype == np.int64
    assert got.tobytes() == want.tobytes()


def test_rank_gene_columns_ignored_identically():
    accel = GaussianFilter()
    g = _pop(accel, 7, seed=9, rank_genes=True)
    x = accel.sample_inputs(2, seed=0)
    got = accel.simulate_batch(g, LIB, x, rank_genes=True, device="cpu")
    want = _ref_numpy("sim", g, x, rank_genes=True)
    assert got.tobytes() == want.tobytes()
    plain = accel.simulate_batch(g[:, :len(accel.slots)], LIB, x,
                                 device="cpu")
    assert np.array_equal(got, plain)


def test_sse_finish_matches_psnr_batch_bits():
    rng = np.random.default_rng(1)
    ref = rng.integers(0, 256, size=(3, 30, 30))
    outs = ref[None] + rng.integers(-9, 10, size=(7, 3, 30, 30))
    outs[2] = ref
    sse = qor.sse_batch(torch.from_numpy(ref), torch.from_numpy(outs))
    assert sse.dtype == torch.int64
    got = qor.psnr_from_sse(sse.numpy(), ref.size, 255.0)
    want = ref_qor.psnr_batch(ref, outs, 255.0)
    assert got.tobytes() == want.tobytes()
    assert got[2] == qor.PSNR_CAP


def test_divergent_adder_twin_raises(monkeypatch):
    """A twin that disagrees with its numpy model stops the engine: there
    is no other engine to fall back to."""
    monkeypatch.setattr(fused, "_ENGINES", {})   # no engine verified before
    monkeypatch.setitem(
        fused._TWIN_FAMILIES, "add_loa",
        lambda kw: functools.partial(fused._tw_trunc, k=kw["k"]))
    accel = GaussianFilter()
    g = _pop(accel, 4, seed=1)
    x = accel.sample_inputs(1, seed=0)
    with pytest.raises(RuntimeError, match="diverges"):
        accel.qor_batch(g, LIB, x, device="cpu")
    with pytest.raises(RuntimeError, match="diverges"):
        accel.simulate_batch(g, LIB, x, device="cpu")


def test_adder_without_twin_raises():
    custom = Circuit(name="add16_custom", kind="add16",
                     fn=lambda a, b: (a + b) | 1)
    lib = Library(LIB.kind("mul8u") + LIB.kind("add16") + [custom])
    accel = GaussianFilter()
    g = _pop(accel, 2)
    with pytest.raises(NotImplementedError, match="add16_custom"):
        accel.qor_batch(g, lib, accel.sample_inputs(1), device="cpu")


def test_lut_over_int32_raises():
    huge = Circuit(name="mul8u_huge", kind="mul8u",
                   fn=lambda a, b: multipliers.mul8_exact(a, b) << 40)
    lib = Library(LIB.kind("mul8u") + [huge] + LIB.kind("add16"))
    accel = GaussianFilter()
    g = _pop(accel, 2)
    with pytest.raises(OverflowError):
        accel.simulate_batch(g, lib, accel.sample_inputs(1), device="cpu")


def test_genome_out_of_range_raises():
    accel = GaussianFilter()
    g = _pop(accel, 3)
    g[1, 0] = len(LIB.kind("mul8u"))
    with pytest.raises(IndexError):
        accel.qor_batch(g, LIB, accel.sample_inputs(1), device="cpu")


def test_adder_twins_verify_on_stock_library():
    eng = fused.build_engine(LIB, "cpu")
    assert len(eng.twins) == len(LIB.kind("add16"))
    a = torch.arange(0, 1 << 16, 97, dtype=torch.int32)
    b = torch.flip(a, [0])
    for c, tw in zip(LIB.kind("add16"), eng.twins):
        want = np.asarray(c.fn(a.numpy().astype(np.int64),
                               b.numpy().astype(np.int64)))
        got = tw(fused._shared(a, b))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), c.name
