"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against
the JAX package's ``models/moe.py`` ``moe_layer`` on the CPU, on the JAX
package's own parameters (``init_tree``) carried across as numpy:

* the reduced phi3.5-moe (4 experts, top-2), a padded config (20
  experts, padded to 32, masked out of routing) and a binding capacity
  (``capacity_factor=0.5``: tokens are dropped);
* each token's top-k experts, the keep mask and the slot positions
  exactly equal to the reference's (recomputed below from its routing
  statements), ``out`` within the bf16 logits tolerance for bf16 inputs
  and ``FP32_REL`` of the output's scale for float32 ones, ``aux``
  within ``AUX_REL``;
* sequence grouping (``MOE_GROUP``): as
  ``tests/test_models.py::test_moe_grouping_equivalence``, and grouped
  outputs against the reference's grouped ones.

Inputs are drawn from numpy seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe_mod
from repro.models import reduced as ref_reduced
from repro.models.common import init_tree, rms_norm as ref_rms_norm
from repro.models.moe import moe_layer as ref_moe_layer
from repro.models.moe import moe_param_specs as ref_moe_param_specs
from repro_torch.configs import get_config
from repro_torch.models import moe as moe_mod
from repro_torch.models import reduced
from repro_torch.models.common import rms_norm
from repro_torch.models.moe import moe_layer, moe_routing

from _torch_threads import bounded_torch_threads  # noqa: F401

TOL = 0.12          # bf16 (tests/test_models.py)
# float32 inputs: the expert FFN runs in bf16 in both packages, and the
# bf16 products agree bit for bit, but XLA's CPU lowering of the bf16
# sigmoid rounds to bf16 after each of its four steps where torch's
# rounds once, so many activations differ by one bf16 rounding.  The
# test prints the difference as a share of max |out| (run with -s):
# 0.50-0.57% on its three cases; held to 2^-6.
FP32_REL = 2.0 ** -6
# the load-balance loss: the router's float32 softmax differs by ulps
# (printed too: at most 2e-7 relative on these cases)
AUX_REL = 1e-5
KEY = jax.random.PRNGKey(0)
PHI = "phi3.5-moe-42b-a6.6b"

CASES = {
    "phi_reduced": {},
    "padded_20_to_32": {"n_experts": 20},
    "capacity_binding": {"capacity_factor": 0.5},
}


def _cfgs(**over):
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(PHI)), **over)
    cfg = dataclasses.replace(reduced(get_config(PHI)), **over)
    return rcfg, cfg


def _params(rcfg):
    p = jax.tree.map(np.asarray, init_tree(ref_moe_param_specs(rcfg), KEY))
    # a non-zero norm scale, so the norm's parameter is exercised
    p["norm"] = np.random.default_rng(9).standard_normal(
        p["norm"].shape).astype(np.float32) * 0.1
    return p


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _ref_routing(p, x, rcfg):
    """The reference's routing statements (``models/moe.py:88-110``) on
    its own norm: (top-k indices, keep (b,s,k), slot (b,s,k))."""
    b, s, _ = x.shape
    e, k = rcfg.padded_experts, rcfg.n_experts_active
    cap = max(int(s * k / e * rcfg.capacity_factor), 1)
    h = ref_rms_norm(x, p["norm"], rcfg.rms_eps)
    logits = jnp.einsum("bsd,de->bse", h.astype(jnp.float32),
                        jnp.asarray(p["router"], jnp.float32))
    if e > rcfg.n_experts:
        logits = jnp.where((jnp.arange(e) >= rcfg.n_experts)[None, None],
                           -1e30, logits)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    sel = jax.nn.one_hot(idx, e, dtype=jnp.float32)
    flat = sel.transpose(0, 2, 1, 3).reshape(b, k * s, e)
    rank = (jnp.cumsum(flat, axis=1) - flat).reshape(b, k, s, e)
    rank = rank.transpose(0, 2, 1, 3)
    keep = (rank < cap) * sel
    slot = (rank * sel).sum(-1)
    return (np.asarray(idx), np.asarray(keep.sum(-1) > 0),
            np.asarray(slot).astype(np.int64), cap)


def _torch(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_layer_matches_reference(case, dtype):
    rcfg, cfg = _cfgs(**CASES[case])
    assert cfg.padded_experts == rcfg.padded_experts
    p = _params(rcfg)
    x_np = _x(cfg, 2, 32, seed=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x_np).astype(jdt)
    xt = torch.from_numpy(x_np).to(tdt)
    want, want_aux = ref_moe_layer(p, xj, rcfg)
    pt = _torch(p)
    got, aux = moe_layer(pt, xt, cfg)
    assert got.shape == want.shape and got.dtype == tdt
    assert want.dtype == jdt

    # routing: indices, keep mask and slots exactly
    idx, keep, slot, cap = _ref_routing(p, xj, rcfg)
    r = moe_routing(rms_norm(xt, pt["norm"], cfg.rms_eps), pt["router"], cfg)
    assert r.cap == cap
    assert np.array_equal(r.idx.numpy(), idx)
    assert np.array_equal(r.keep.numpy(), keep)
    assert np.array_equal(r.pos.numpy(), slot)
    assert int(r.idx.max()) < cfg.n_experts       # padding never routed
    if case == "capacity_binding":
        assert not keep.all()

    want = np.asarray(want, np.float32)
    err = float(np.max(np.abs(got.float().numpy() - want)))
    scale = float(np.max(np.abs(want)))
    aux_rel = abs(float(aux) - float(want_aux)) / abs(float(want_aux))
    print(f"{case} {dtype}: out differs by {err:.3g} ({err / scale:.2%} "
          f"of max |out|), aux by {aux_rel:.2g} relative")
    assert err <= (TOL if dtype == "bfloat16" else FP32_REL * scale), err
    assert aux.dtype == torch.float32
    assert aux_rel <= AUX_REL


def test_moe_grouping_equivalence(monkeypatch):
    """Sequence grouping must not change the output while the capacity
    does not bind (``tests/test_models.py``); grouped, the port gives the
    reference's grouped output."""
    rcfg, cfg = _cfgs(capacity_factor=8.0)
    p = _params(rcfg)
    pt = _torch(p)
    x_np = _x(cfg, 2, 32, seed=2)
    xt = torch.from_numpy(x_np)
    monkeypatch.setattr(moe_mod, "MOE_GROUP", 0)
    y0, a0 = moe_layer(pt, xt, cfg)
    monkeypatch.setattr(moe_mod, "MOE_GROUP", 8)     # 4 groups of 8
    y1, a1 = moe_layer(pt, xt, cfg)
    np.testing.assert_allclose(y0.float().numpy(), y1.float().numpy(),
                               rtol=2e-2, atol=2e-2)
    prev = ref_moe_mod.MOE_GROUP
    try:
        ref_moe_mod.set_moe_group(8)
        want, want_aux = ref_moe_layer(p, jnp.asarray(x_np), rcfg)
    finally:
        ref_moe_mod.set_moe_group(prev)
    want = np.asarray(want)
    assert (float(np.max(np.abs(y1.numpy() - want)))
            <= FP32_REL * float(np.max(np.abs(want))))
    assert abs(float(a1) - float(want_aux)) <= AUX_REL * abs(float(want_aux))


def test_moe_binding_capacity_drops_late_choices():
    """With one slot an expert, the first assignment of each expert in
    queue order is kept: every first choice before any second choice."""
    rcfg, cfg = _cfgs(capacity_factor=0.01)
    p = _params(rcfg)
    pt = _torch(p)
    xt = torch.from_numpy(_x(cfg, 1, 16, seed=3))
    r = moe_routing(rms_norm(xt, pt["norm"], cfg.rms_eps), pt["router"], cfg)
    assert r.cap == 1
    idx, keep = r.idx[0].numpy(), r.keep[0].numpy()
    seen = set()
    for j in range(cfg.n_experts_active):
        for t in range(idx.shape[0]):
            e = int(idx[t, j])
            assert keep[t, j] == (e not in seen)
            seen.add(e)
    # a token whose every choice was dropped contributes nothing
    out, _ = moe_layer(pt, xt, cfg)
    dropped = ~keep.any(-1)
    if dropped.any():
        assert torch.all(out[0, torch.from_numpy(dropped)] == 0)
