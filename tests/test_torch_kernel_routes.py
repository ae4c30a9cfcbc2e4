"""The two redesigned kernels' CPU-visible parts: the flash-attention
dispatch table, a plain model of the tensor-core kernel's rounding held
at the bf16 gate, and the packed grouped rank-k layout, whose plain
version must be bit-equal to the per-group chain it replaces.  The CUDA
kernels themselves are held against the plain versions on the card by
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.acl.library import default_library as ref_library
from repro.kernels import approx_matmul as ref_am
from repro_torch.accel import GaussianFilter
from repro_torch.accel.gaussian import GAUSS_COEFFS, _im2col
from repro_torch.core.acl.library import default_library
from repro_torch.core.features import synth
from repro_torch.kernels import approx_matmul as am
from repro_torch.kernels.approx_matmul import ops as am_ops
from repro_torch.kernels.approx_matmul import ref as am_ref
from repro_torch.kernels.flash_attention import (
    KERNEL_ROUTES,
    attention,
    attention_ref,
    flash_attention_kernel,
    kernel_route,
)

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()
RLIB = ref_library()

# chip_smoke.py's bf16 gate of the flash kernels against the plain version
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2 ** -7, 1e-3
# the JAX package's own rank-k tolerance (tests/test_kernels.py)
RANK_RTOL, RANK_ATOL = 1e-5, 0.5


# ---------------------------------------------------------------------------
# flash attention: dispatch table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 128, "flash_attention_sm90"),
    (torch.bfloat16, 64, "flash_attention_sm90"),
    (torch.bfloat16, 256, "flash_attention_sm90"),
    (torch.float32, 64, "flash_attention"),
    (torch.float32, 128, "flash_attention"),
    (torch.float32, 256, "flash_attention"),
])
def test_flash_route(dtype, d, route):
    assert kernel_route(dtype, d) == route
    assert KERNEL_ROUTES[(dtype, d)] == route


@pytest.mark.parametrize("dtype,d", [(torch.float16, 128), (torch.bfloat16, 96),
                                     (torch.float32, 32), (torch.bfloat16, 512)])
def test_flash_route_refuses_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        kernel_route(dtype, d)


def test_flash_routes_name_built_kernels():
    from repro_torch import _build

    assert set(KERNEL_ROUTES.values()) <= set(_build.KERNELS)
    assert set(KERNEL_ROUTES.values()) <= set(_build.LAUNCHES)
    q = torch.zeros((1, 2, 4, 128), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 4, 128), dtype=torch.bfloat16)
    # a CPU tensor never reaches a kernel: the wrapper refuses it and the
    # op runs the plain version
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_kernel(q, k, k)
    assert torch.equal(attention(q, k, k), attention_ref(q, k, k))


# ---------------------------------------------------------------------------
# flash attention: the tensor-core kernel's rounding, modelled in torch
# ---------------------------------------------------------------------------

def _tensor_core_model(q, k, v, *, q_offset=0, bk=64, split_p=True):
    """What ``csrc/flash_attention_sm90.cu`` computes, in float32 torch:
    per 64-key tile, S from the bf16 inputs (their products are exact in
    float32), scaled after the product, masked, online softmax, and P.V
    with P rounded to bf16 hi + lo (or to one bf16 with
    ``split_p=False``); the output rounded once to bf16."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kvh, h // kvh, sq, d)
    acc = torch.zeros((b, kvh, h // kvh, sq, d))
    m = torch.full((b, kvh, h // kvh, sq, 1), -1e30)
    l = torch.zeros_like(m)
    qpos = torch.arange(sq) + q_offset
    for k0 in range(0, sk, bk):
        kt, vt = k[:, :, k0:k0 + bk].float(), v[:, :, k0:k0 + bk].float()
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, kt) * d ** -0.5
        kpos = torch.arange(k0, k0 + kt.shape[2])
        s = torch.where(kpos[None, :] <= qpos[:, None], s,
                        torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        acc = acc * alpha + torch.einsum("bgrqk,bgkd->bgrqd", hi, vt)
        if split_p:
            lo = (p - hi).bfloat16().float()
            acc = acc + torch.einsum("bgrqk,bgkd->bgrqd", lo, vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, sq, d).bfloat16()


def _bf16(rng, *shape):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).bfloat16()


def _gate_excess(got, want):
    """max(|got - want| - (atol + rtol |want|)): <= 0 inside the gate."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - FLASH_BF16_ATOL
                  - FLASH_BF16_RTOL * want.abs()).max())


@pytest.mark.parametrize("sq,sk,q_offset", [(256, 256, 0), (200, 232, 32)])
def test_tensor_core_rounding_within_bf16_gate(sq, sk, q_offset):
    """b=1, H=4 on one kv head, d=128, causal; the second case is ragged
    (not a multiple of the 64-key tile) with a shifted mask."""
    rng = np.random.default_rng(sq + q_offset)
    q = _bf16(rng, 1, 4, sq, 128)
    k, v = _bf16(rng, 1, 1, sk, 128), _bf16(rng, 1, 1, sk, 128)
    want = attention_ref(q, k, v, causal=True, q_offset=q_offset)
    got = _tensor_core_model(q, k, v, q_offset=q_offset)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _gate_excess(got, want) <= 0.0


def test_one_bf16_p_would_miss_the_gate():
    """Why the kernel splits P: rounding P to one bf16 (8 mantissa bits)
    misses the gate on rows with few keys, where single probabilities
    are large."""
    rng = np.random.default_rng(256)
    q = _bf16(rng, 1, 4, 256, 128)
    k, v = _bf16(rng, 1, 1, 256, 128), _bf16(rng, 1, 1, 256, 128)
    want = attention_ref(q, k, v, causal=True)
    assert _gate_excess(_tensor_core_model(q, k, v, split_p=False), want) > 0
    assert _gate_excess(_tensor_core_model(q, k, v), want) <= 0


# ---------------------------------------------------------------------------
# rank-k: packed slot groups
# ---------------------------------------------------------------------------

_VARIANTS = {
    # the chip_smoke row: default ranks 0,0,1,2,3,4,3,2,1 and a truncation
    "default ranks": [(n, None) for n in (
        "mul8u_exact", "mul8u_trunc3", "mul8u_perf2", "mul8u_bam2",
        "mul8u_bam4", "mul8u_bam6", "mul8u_mitchell", "mul8u_drum4",
        "mul8u_kulkarni")],
    # explicit ranks 0..4 (the beyond-paper rank axis) and two truncations
    "ranks 0-4": [("mul8u_mitchell", 0), ("mul8u_mitchell", 1),
                  ("mul8u_drum4", 2), ("mul8u_bam6", 3), ("mul8u_perf2", 4),
                  ("mul8u_trunc5", None), ("mul8u_kulkarni", 4),
                  ("mul8u_trunc2", None), ("mul8u_exact", None)],
}


def _gaussian_operands():
    x = np.ascontiguousarray(
        _im2col(GaussianFilter().sample_inputs(1, seed=1)), dtype=np.int32)
    w = GAUSS_COEFFS.reshape(9, 1).astype(np.int32)
    return x, w


def _chain(x, w, specs, groups):
    """The per-group chain the packed layout replaces: one rank-k product
    per slot group on the truncated operands, partials added in order."""
    out = None
    for spec, (s, e) in zip(specs, groups):
        xs, ws = x[:, s:e].contiguous(), w[s:e].contiguous()
        if spec.trunc_bits:
            xs = am_ref.mask_operand(xs, spec.trunc_bits).contiguous()
            ws = am_ref.mask_operand(ws, spec.trunc_bits).contiguous()
        u = torch.as_tensor(spec.u, dtype=torch.float32)
        v = torch.as_tensor(spec.v, dtype=torch.float32)
        part = am_ref.rank_k_matmul(xs, ws, u, v, signed=spec.signed)
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_packed_grouped_plain_bit_equal_to_chain(variant):
    picks = _VARIANTS[variant]
    specs = [am.from_circuit(LIB[n], r) for n, r in picks]
    assert {s.rank for s in specs} >= ({0, 1, 2, 3, 4})
    assert any(s.trunc_bits for s in specs)
    groups = GaussianFilter().slot_groups()
    x, w = (torch.from_numpy(a) for a in _gaussian_operands())
    want = _chain(x, w, specs, groups)
    packed = am.pack_groups(specs, groups)
    got = am.grouped_rank_k_matmul(x, w, torch.from_numpy(packed))
    assert got.dtype == torch.float32 and got.shape == (900, 1)
    assert torch.equal(got, want)
    assert torch.equal(am.grouped_matmul(x, w, specs, groups), want)
    # and the JAX package's grouped_matmul on its own specs
    rspecs = [ref_am.from_circuit(RLIB[n], r) for n, r in picks]
    ref = np.asarray(ref_am.grouped_matmul(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), rspecs, groups,
        path="mxu"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RANK_RTOL,
                               atol=RANK_ATOL)


def test_packed_layout():
    specs = [am.from_circuit(LIB[n], r) for n, r in _VARIANTS["ranks 0-4"]]
    groups = GaussianFilter().slot_groups()
    packed = am.pack_groups(specs, groups)
    assert packed.dtype == np.int32 and packed[0] == len(specs)
    tables = packed[1 + am_ref.DESC_WORDS * len(specs):].view(np.float32)
    at = 0
    for g, (spec, (s, e)) in enumerate(zip(specs, groups)):
        desc = packed[1 + am_ref.DESC_WORDS * g:1 + am_ref.DESC_WORDS * (g + 1)]
        assert desc.tolist() == [s, e, spec.rank, at, 0, spec.trunc_bits]
        r = spec.rank
        assert np.array_equal(tables[at:at + 256 * r].reshape(256, r), spec.u)
        assert np.array_equal(tables[at + 256 * r:at + 512 * r].reshape(256, r),
                              spec.v)
        at += 512 * r
    assert tables.size == at


def test_packed_groups_refused_where_the_kernel_cannot_take_them():
    specs = [am.from_circuit(LIB["mul8u_bam6"], 2)]
    x, w = (torch.from_numpy(a) for a in _gaussian_operands())
    with pytest.raises(ValueError, match="outside a contraction"):
        am.grouped_rank_k_matmul_kernel(x, w, am.pack_groups(specs, [(0, 10)]))
    with pytest.raises(ValueError, match="outside a contraction"):
        am.grouped_rank_k_matmul_kernel(x, w, am.pack_groups(specs, [(5, 4)]))
    with pytest.raises(ValueError, match="groups"):
        am.pack_groups(specs, [(0, 1), (1, 2)])
    with pytest.raises(ValueError, match="no slot groups"):
        am.pack_groups([], [])
    # ranks past the card's shared-memory stage: refused before a launch,
    # computed on the CPU, which has no such cap
    big = [am.from_circuit(LIB["mul8u_bam6"], 60)] * 2
    packed = am.pack_groups(big, [(0, 4), (4, 9)])
    with pytest.raises(ValueError, match="shared-memory stage"):
        am_ops._check_smem(*am_ops._check_packed(packed, 9))
    assert torch.equal(am.grouped_rank_k_matmul_kernel(x, w, packed),
                       _chain(x, w, big, [(0, 4), (4, 9)]))


def test_single_circuit_is_one_group():
    """``approx_matmul(path="mxu")`` is the G = 1 case of the packed
    route: the truncation mask applied in the group, the result the
    per-group chain's."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (16, 24)).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, 256, (24, 8)).astype(np.int32))
    for name in ("mul8u_trunc3", "mul8u_bam4"):
        spec = am.from_circuit(LIB[name])
        assert torch.equal(am.approx_matmul(x, w, spec),
                           _chain(x, w, [spec], [(0, 24)]))


# ---------------------------------------------------------------------------
# label records
# ---------------------------------------------------------------------------

def test_label_records_unchanged_by_the_packed_route(monkeypatch):
    """``label_variants(device="cpu")`` gives the same records when
    synthesis runs the packed route as when it runs the per-group chain;
    the chain is what synthesis ran before the packed route.  Each call
    gets a fresh synthesis cache, so that both really run."""
    accel = GaussianFilter()
    sizes = accel.gene_sizes(LIB)
    g = np.random.default_rng(11).integers(0, sizes[None, :],
                                           size=(24, len(sizes)))
    x = accel.sample_inputs(2, seed=synth.DEFAULT_QOR_SEED)
    packed = synth.label_variants(accel, g, LIB, qor_inputs=x, cache={},
                                  synth_cache=synth.SynthCache(),
                                  device="cpu")
    runs = []

    def chain(x, w, specs, groups, path="mxu"):
        runs.append(len(specs))
        return _chain(x, w, specs, groups)

    monkeypatch.setattr(am, "grouped_matmul", chain)
    chained = synth.label_variants(accel, g, LIB, qor_inputs=x, cache={},
                                   synth_cache=synth.SynthCache(),
                                   device="cpu")
    assert runs and set(runs) == {9}
    for key in synth.LABEL_KEYS:
        if key in ("synth_time", "sim_time"):
            continue
        assert packed[key].tobytes() == chained[key].tobytes(), key

