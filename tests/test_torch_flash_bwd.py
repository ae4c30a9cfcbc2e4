"""The attention gradient of the port against the JAX package's.

On the CPU the port's attention op differentiates through its plain
version (``attention_ref``); on the card its autograd function pairs the
forward kernel with ``csrc/flash_attention_bwd.cu``, which is held
against that plain version in ``chip_smoke.py``.  Here the plain path's
dQ, dK and dV are held to ``jax.vjp`` of the JAX package's chunked
attention (the form its model code trains through) at the JAX package's
attention tolerance, rtol 1e-4 / atol 1e-5 in float32
(tests/test_kernels.py); and the card-only branch is reached through a
mocked device check: a q_offset under grad refuses before any kernel
would launch.  (A Mamba layer's training route on the card is
tests/test_torch_scan_bwd.py's.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention as ref_attention
from repro_torch.kernels.flash_attention import (
    BWD_HEAD_DIMS,
    attention,
    attention_bwd_ref,
    flash_attention_bwd_kernel,
)
from repro_torch.kernels.flash_attention import ops as flash_ops

from _torch_threads import bounded_torch_threads  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5     # tests/test_kernels.py, float32 attention

# (b, h, kvh, s, d, causal)
CASES = {
    "gqa8/2-d64": (2, 8, 2, 48, 64, True),
    "mqa8/1-d256": (1, 8, 1, 40, 256, True),
    "gqa8/2-d256-noncausal": (1, 8, 2, 24, 256, False),
    "mha4-d64": (1, 4, 4, 33, 64, True),
}


def _inputs(b, h, kvh, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, kvh, s, d), (b, kvh, s, d),
                          (b, h, s, d))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_gradient_matches_jax_vjp(case):
    b, h, kvh, s, d, causal = CASES[case]
    q, k, v, do = _inputs(b, h, kvh, s, d)
    out, vjp = jax.vjp(
        lambda q_, k_, v_: ref_attention(q_, k_, v_, causal=causal,
                                         impl="chunked", chunk=16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got_out = attention(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               rtol=RTOL, atol=ATOL)
    got_out.backward(torch.from_numpy(do))
    for name, g, w in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")
    # the backward kernel's plain version is the same gradient
    ref = attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v, do)),
                            causal=causal)
    for g, r in zip((qt.grad, kt.grad, vt.grad), ref):
        torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL)


def test_bf16_plain_gradient_in_input_dtype():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(1, 4, 2, 16, 64))
    dq, dk, dv = attention_bwd_ref(q, k, v, do)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dk.shape == k.shape and dv.shape == v.shape


def test_backward_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 16, 64))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_bwd_kernel(q, k, v, q.clone(), do)
    assert BWD_HEAD_DIMS == (64, 128, 256)


def test_offset_under_grad_refuses_on_the_card(monkeypatch):
    """The backward kernel takes q_offset 0 only: on the card, a forward
    that needs a gradient at another offset raises before launching."""
    monkeypatch.setattr(flash_ops, "_on_cpu", lambda t: False)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 16, 64))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="q_offset 0"):
        attention(q, k, v, causal=True, q_offset=3)
