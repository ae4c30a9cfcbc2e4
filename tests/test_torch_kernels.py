"""The port's kernels on the CPU: each plain PyTorch version against the
JAX package's Pallas kernel (interpret mode) and its reference, on the
same numpy-seeded inputs.  The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.acl.library import default_library as ref_library
from repro.kernels import approx_matmul as ref_am
from repro.kernels.population_lut import (
    population_lut_gather as ref_pop_gather,
    population_lut_gather_ref as ref_pop_ref,
)
from repro_torch import convert
from repro_torch.accel import GaussianFilter
from repro_torch.core.acl.library import default_library
from repro_torch.kernels import approx_matmul as am
from repro_torch.kernels.population_lut import (
    population_lut_gather,
    population_lut_gather_ref,
)

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()
RLIB = ref_library()

# the JAX package's own rank-k tolerance (tests/test_kernels.py)
RTOL, ATOL = 1e-5, 0.5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pop_inputs(per_genome, seed=0, C=5, S=3, G=8, M=256):
    rng = np.random.default_rng(seed)
    lut = rng.integers(-40000, 70000, size=(C, S, 256)).astype(np.int32)
    genes = rng.integers(0, C, size=(G, S)).astype(np.int32)
    shape = (G, M, S) if per_genome else (M, S)
    cols = rng.integers(0, 256, size=shape).astype(np.int32)
    return lut, genes, cols


@pytest.mark.parametrize("per_genome", [False, True])
@pytest.mark.parametrize("backend", ["pallas_interpret", "ref"])
def test_population_gather_byte_equal(per_genome, backend):
    lut, genes, cols = _pop_inputs(per_genome, seed=int(per_genome))
    want = np.asarray(ref_pop_gather(lut, genes, cols, per_genome=per_genome,
                                     backend=backend))
    for fn in (population_lut_gather, population_lut_gather_ref):
        got = fn(_t(lut), _t(genes), _t(cols), per_genome=per_genome)
        assert got.dtype == torch.int32
        assert got.numpy().shape == want.shape
        assert got.numpy().tobytes() == want.astype(np.int32).tobytes()


def test_population_gather_matches_numpy_ref_on_gaussian_lut():
    from repro_torch.accel._batchsim import mul_lut
    from repro_torch.accel.gaussian import GAUSS_COEFFS, _im2col

    lut = mul_lut(LIB, "mul8u", GAUSS_COEFFS).astype(np.int32)
    rng = np.random.default_rng(3)
    genes = rng.integers(0, lut.shape[0], size=(6, 9)).astype(np.int32)
    cols = _im2col(GaussianFilter().sample_inputs(1, seed=2)).astype(np.int32)
    want = ref_pop_ref(lut, genes, cols)
    got = population_lut_gather(_t(lut), _t(genes), _t(cols)).numpy()
    assert np.array_equal(got, want)


def test_population_gather_rejects_bad_shapes():
    lut, genes, cols = _pop_inputs(False)
    with pytest.raises(ValueError):
        population_lut_gather(_t(lut), _t(genes[:, :2]), _t(cols))
    with pytest.raises(ValueError):
        population_lut_gather(_t(lut), _t(genes), _t(cols), per_genome=True)


def _operands(signed, m, k, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = (-128, 128) if signed else (0, 256)
    return (rng.integers(lo, hi, (m, k)).astype(np.int32),
            rng.integers(lo, hi, (k, n)).astype(np.int32))


@pytest.mark.parametrize("name", ["mul8u_trunc3", "mul8s_trunc2"])
def test_lut_matmul_byte_equal_to_pallas_interpret(name):
    c = LIB[name]
    x, w = _operands(c.signed, 64, 64, 32, seed=len(name))
    table = c.table.astype(np.int32)
    want = np.asarray(ref_am.lut_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(table),
        signed=c.signed, bm=32, bn=32, bk=32, interpret=True))
    got = am.lut_matmul(_t(x), _t(w), _t(table), signed=c.signed)
    assert got.dtype == torch.int32
    assert got.numpy().tobytes() == want.astype(np.int32).tobytes()
    via_wrapper = am.lut_matmul_kernel(_t(x), _t(w), _t(table),
                                       signed=c.signed)
    assert torch.equal(via_wrapper, got)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("rank", [0, 4])
def test_rank_k_matches_pallas_interpret_and_ref(signed, rank):
    c = LIB["mul8s_perf3" if signed else "mul8u_perf3"]
    if rank:
        f = c.factors(rank)
        u, v = f.u.astype(np.float32), f.v.astype(np.float32)
    else:
        u = v = np.zeros((256, 0), np.float32)
    x, w = _operands(signed, 128, 128, 128, seed=rank + signed)
    got = am.rank_k_matmul(_t(x), _t(w), _t(u), _t(v), signed=signed).numpy()
    # the Pallas interpreter cannot block a (256, 0) table; one all-zero
    # rank column is the same function as rank 0
    pu, pv = (u, v) if rank else (np.zeros((256, 1), np.float32),) * 2
    pallas = np.asarray(ref_am.rank_k_mxu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(pu), jnp.asarray(pv),
        signed=signed, interpret=True))
    ref = np.asarray(ref_am.rank_k_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(u), jnp.asarray(v),
        signed=signed))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["mul8u_exact", "mul8u_bam6", "mul8u_drum4"])
def test_rank_k_ragged_gaussian_group(name):
    """The main path's own shape: one (900,1)@(1,1) slot group, which the
    Pallas kernel (multiples of 128 only) cannot take."""
    from repro_torch.accel.gaussian import _im2col

    spec = am.from_circuit(LIB[name])
    x = _im2col(GaussianFilter().sample_inputs(1, seed=1))[:, 4:5]
    x = x.astype(np.int32)
    w = np.array([[4]], np.int32)
    got = am.rank_k_matmul_kernel(_t(x), _t(w), _t(spec.u), _t(spec.v)).numpy()
    want = np.asarray(ref_am.rank_k_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(spec.u),
        jnp.asarray(spec.v)))
    assert got.shape == (900, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _same_spec(name, rank=None):
    """The port's spec for ``name``, built from the JAX package's spec
    arrays through ``convert.spec_from_arrays``."""
    rs = ref_am.from_circuit(RLIB[name], rank)
    spec = convert.spec_from_arrays(rs.name, rs.signed, rs.rank, rs.u, rs.v,
                                    rs.table, rs.trunc_bits)
    return rs, spec


@pytest.mark.parametrize("name", ["mul8u_trunc3", "mul8s_trunc2",
                                  "mul8u_bam4"])
@pytest.mark.parametrize("path", ["mxu", "lut"])
def test_approx_matmul_matches_reference_default_route(name, path):
    rs, spec = _same_spec(name)
    own = am.from_circuit(LIB[name])
    assert own.rank == spec.rank and own.trunc_bits == spec.trunc_bits
    assert np.array_equal(own.u, spec.u) and np.array_equal(own.table,
                                                            spec.table)
    x, w = _operands(spec.signed, 16, 24, 8, seed=7)
    want = np.asarray(ref_am.approx_matmul(jnp.asarray(x), jnp.asarray(w), rs,
                                           path=path))
    got = am.approx_matmul(_t(x), _t(w), spec, path=path).numpy()
    assert got.dtype == np.float32
    if path == "lut" or spec.trunc_bits:
        assert np.array_equal(got, want)   # integer-valued either way
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gaussian_deploy_graph_matches_reference():
    from repro.accel import GaussianFilter as RefGaussian

    names = ["mul8u_exact", "mul8u_trunc2", "mul8u_perf1", "mul8u_bam2",
             "mul8u_bam6", "mul8u_mitchell", "mul8u_drum3", "mul8u_kulkarni",
             "mul8u_trunc5"]
    rspecs = [ref_am.from_circuit(RLIB[n]) for n in names]
    specs = [am.from_circuit(LIB[n]) for n in names]
    rfn, rargs = RefGaussian().build_deploy(rspecs)
    fn, args = GaussianFilter().build_deploy(specs, device="cpu")
    want = np.asarray(rfn(*rargs))
    got = fn(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want_lut = np.asarray(ref_am.grouped_matmul(
        *rargs, rspecs, RefGaussian().slot_groups(), path="lut"))
    assert np.array_equal(fn(*args, path="lut").numpy(), want_lut)


def test_quantize_roundtrip_matches_reference():
    rng = np.random.default_rng(11)
    t = rng.standard_normal((16, 32)).astype(np.float32)
    q, s = am.quantize_sym(_t(t), dim=1)
    rq, rs = ref_am.quantize_sym(jnp.asarray(t), axis=1)
    assert np.array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(am.dequantize(q, s).numpy(),
                               np.asarray(ref_am.dequantize(rq, rs)),
                               rtol=1e-6, atol=1e-7)
