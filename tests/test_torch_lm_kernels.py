"""The LM kernels of the port on the CPU: the plain flash-attention and
selective-scan versions against the JAX package's Pallas kernels
(interpret mode) and its references, on the same numpy-seeded inputs, at
the JAX package's own tolerances.  The CUDA kernels are held against
these plain versions on the card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import (
    flash_attention_fwd,
    mha_reference,
    repeat_kv,
)
from repro.kernels.selective_scan import (
    selective_scan_pallas,
    selective_scan_reference,
)
from repro.models.ssm import _selective_scan_chunked
from repro_torch.kernels.flash_attention import (
    attention,
    attention_ref,
    flash_attention_kernel,
)
from repro_torch.kernels.selective_scan import (
    selective_scan,
    selective_scan_kernel,
    selective_scan_ref,
)

from _torch_threads import bounded_torch_threads  # noqa: F401

# tests/test_kernels.py (flash) and tests/test_kernels_scan.py (scan)
FLASH_RTOL, FLASH_ATOL = 1e-4, 1e-5
SCAN_RTOL, SCAN_ATOL = 1e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk", [(128, 128), (128, 256)])
def test_flash_plain_matches_pallas_interpret(sq, sk):
    rng = np.random.default_rng(sq + sk)
    bh, d = 4, 64
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k = rng.standard_normal((bh, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh, sk, d)).astype(np.float32)
    want = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, interpret=True)
    ref = mha_reference(jnp.asarray(q)[None], jnp.asarray(k)[None],
                        jnp.asarray(v)[None], causal=True)[0]
    got = attention_ref(_t(q)[None], _t(k)[None], _t(v)[None], causal=True)[0]
    _close(got, want, FLASH_RTOL, FLASH_ATOL)
    _close(got, ref, FLASH_RTOL, FLASH_ATOL)


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 40),
                                              (False, 0)])
def test_flash_plain_gqa_ragged_offset(causal, q_offset):
    """GQA (h=4 on kvh=2), s=48 (not a multiple of 128: the Pallas
    kernel runs at bq=bk=16), and a shifted causal mask."""
    rng = np.random.default_rng(7 + q_offset)
    b, h, kvh, s, d = 2, 4, 2, 48, 16
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = flash_attention_fwd(
        jq.reshape(b * h, s, d), repeat_kv(jk, h // kvh).reshape(b * h, s, d),
        repeat_kv(jv, h // kvh).reshape(b * h, s, d), causal=causal, bq=16,
        bk=16, q_offset=q_offset, interpret=True).reshape(b, h, s, d)
    ref = mha_reference(jq, jk, jv, causal=causal, q_offset=q_offset)
    for fn in (attention_ref, attention):
        got = fn(_t(q), _t(k), _t(v), causal=causal, q_offset=q_offset)
        assert got.shape == (b, h, s, d) and got.dtype == torch.float32
        _close(got, want, FLASH_RTOL, FLASH_ATOL)
        _close(got, ref, FLASH_RTOL, FLASH_ATOL)


def test_flash_plain_decode_offset():
    """One query at position 40 over a 64-long cache: the decode-offset
    case of tests/test_kernels.py."""
    rng = np.random.default_rng(3)
    b, h, s, d = 1, 2, 64, 16
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, h, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h, s, d)).astype(np.float32)
    pos = 40
    ref = mha_reference(jnp.asarray(q), jnp.asarray(k[:, :, :pos + 1]),
                        jnp.asarray(v[:, :, :pos + 1]), causal=False)
    got = attention(_t(q), _t(k), _t(v), causal=True, q_offset=pos)
    _close(got, ref, FLASH_RTOL, FLASH_ATOL)


def test_flash_plain_bf16_keeps_dtype_and_tracks_f32():
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.standard_normal((2, 4, 40, 16)).astype(np.float32))
               for _ in range(3))
    k, v = k[:, :2], v[:, :2]
    got = attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert got.dtype == torch.bfloat16
    want = attention_ref(q.bfloat16().float(), k.bfloat16().float(),
                         v.bfloat16().float())
    # one bf16 rounding of the output (8 mantissa bits)
    assert torch.allclose(got.float(), want, rtol=2 ** -8, atol=2 ** -8)


def test_flash_dispatch():
    q = torch.zeros((1, 2, 4, 64))
    k = torch.zeros((1, 1, 4, 64))
    assert torch.equal(attention(q, k, k, impl="plain"),
                       attention(q, k, k, impl="kernel"))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_kernel(q, k, k)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, k, k, impl="chunked")
    with pytest.raises(ValueError, match="heads"):
        attention(q, torch.zeros((1, 3, 4, 64)), torch.zeros((1, 3, 4, 64)))
    with pytest.raises(ValueError, match="q_offset"):
        attention(q, k, k, q_offset=-1)


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------

def _scan_inputs(rng, b, s, di, n):
    """Drawn as ``_inputs`` in tests/test_kernels_scan.py."""
    x = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, s, di)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, (di, n))).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = (rng.standard_normal((b, di, n)) * 0.1).astype(np.float32)
    return x, dt, A, B, C, h0


@pytest.mark.parametrize("b,s,di,n", [(1, 16, 8, 4), (2, 64, 32, 8),
                                      (1, 128, 16, 16)])
def test_scan_plain_matches_pallas_interpret(b, s, di, n):
    arrs = _scan_inputs(np.random.default_rng(s + di), b, s, di, n)
    j = [jnp.asarray(a) for a in arrs]
    y_p, h_p = selective_scan_pallas(*j, bd=di, chunk=min(32, s),
                                     interpret=True)
    y_r, h_r = selective_scan_reference(*j)
    for fn in (selective_scan_ref, selective_scan):
        y, hT = fn(*(_t(a) for a in arrs))
        assert y.shape == (b, s, di) and hT.shape == (b, di, n)
        for got, want in ((y, y_p), (hT, h_p), (y, y_r), (hT, h_r)):
            _close(got, want, SCAN_RTOL, SCAN_ATOL)


def test_scan_plain_ragged_length_and_zero_state():
    """s = 50 is no multiple of the chunk: the JAX chunked form pads with
    dt = 0 steps, the port needs no padding.  h0 None is a zero state."""
    b, s, di, n = 2, 50, 16, 8
    x, dt, A, B, C, h0 = _scan_inputs(np.random.default_rng(11), b, s, di, n)
    j = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    y_r, h_r = selective_scan_reference(*j, jnp.asarray(h0))
    y_c, h_c = _selective_scan_chunked(*j, 16, jnp.asarray(h0))
    y, hT = selective_scan(*(_t(a) for a in (x, dt, A, B, C, h0)))
    _close(y, y_r, SCAN_RTOL, SCAN_ATOL)
    _close(hT, h_r, SCAN_RTOL, SCAN_ATOL)
    # the chunked associative form's own tolerance (test_kernels_scan.py)
    _close(y, y_c, 2e-4, 2e-4)
    _close(hT, h_c, 2e-4, 2e-4)
    y0, h0_ = selective_scan(*(_t(a) for a in (x, dt, A, B, C)))
    y0r, h0r = selective_scan_reference(*j)
    _close(y0, y0r, SCAN_RTOL, SCAN_ATOL)
    _close(h0_, h0r, SCAN_RTOL, SCAN_ATOL)


def test_scan_dispatch():
    x = torch.zeros((1, 4, 8))
    A = -torch.ones((8, 4))
    Bc = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="CUDA device"):
        selective_scan_kernel(x, x, A, Bc, Bc)
    with pytest.raises(ValueError, match="unknown scan impl"):
        selective_scan(x, x, A, Bc, Bc, impl="pallas")
    with pytest.raises(ValueError, match="must be"):
        selective_scan(x, x, A, Bc[:, :2], Bc)
