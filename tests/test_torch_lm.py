"""The port's LM serving path against the JAX package at reduced size:
the JAX package's own parameters (``init_tree``), carried across as
numpy by ``convert.lm_params_from_numpy``, run through both packages on
the same tokens.  Logits are bf16 in both, so they are held to the JAX
package's bf16 tolerance (0.12, tests/test_models.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import ApproxPolicy as RefApproxPolicy
from repro.models import cache_specs as ref_cache_specs
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import param_specs as ref_param_specs
from repro.models import reduced as ref_reduced
from repro.models.common import init_tree
from repro.train.serve import make_prefill_step as ref_make_prefill_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.serve import build_model, serve_batch
from repro_torch.models import ApproxPolicy, reduced
from repro_torch.train.serve import make_decode_step, make_prefill_step

from _torch_threads import bounded_torch_threads  # noqa: F401

TOL = 0.12          # bf16 logits (tests/test_models.py)
ARCHS = ["granite-8b", "falcon-mamba-7b"]
B, S = 2, 24
KEY = jax.random.PRNGKey(0)


def _tokens(cfg, seed=0, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, s)).astype(np.int32)


def _ref_params(arch):
    rcfg = ref_reduced(ref_get_config(arch))
    params = init_tree(ref_param_specs(rcfg), KEY)
    return rcfg, jax.tree.map(np.asarray, params)


def _port(arch, params_np, policy=None):
    cfg = reduced(get_config(arch))
    sd = convert.lm_params_from_numpy(params_np, cfg)
    return cfg, build_model(cfg, policy=policy, params=sd, device="cpu")


def _err(got, want):
    return float(np.max(np.abs(got.float().numpy()
                               - np.asarray(want, np.float32))))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    rcfg, params_np = _ref_params(arch)
    cfg, model = _port(arch, params_np)
    return arch, rcfg, params_np, cfg, model


def test_config_and_state_dict_carry_across(pair):
    arch, rcfg, params_np, cfg, model = pair
    assert cfg == reduced(get_config(arch))
    assert cfg.n_layers == rcfg.n_layers and cfg.d_model == rcfg.d_model
    sd = convert.lm_params_from_numpy(params_np, cfg)
    assert sorted(sd) == sorted(model.state_dict())
    # exact-route projections stored bf16, everything else as needed
    for name, p in model.named_parameters():
        if name.split(".")[-1] in ("wq", "wk", "wv", "wo", "wi", "wg",
                                   "in_proj", "x_proj", "dt_proj",
                                   "out_proj", "embed", "lm_head"):
            assert p.dtype == torch.bfloat16, name
        else:
            assert p.dtype == torch.float32, name
            assert torch.equal(p, sd[name]), name


def test_forward_logits_match_reference(pair):
    arch, rcfg, params_np, cfg, model = pair
    tokens = _tokens(cfg)
    want, _, _ = ref_forward(params_np, rcfg, jnp.asarray(tokens),
                             remat=False, attn_chunk=16, scan_chunk=8)
    got = model(torch.from_numpy(tokens))
    assert got.shape == (B, S, cfg.padded_vocab)
    assert got.dtype == torch.bfloat16
    assert _err(got, want) < TOL


def test_prefill_and_decode_match_reference(pair):
    """Prefill of the first S-4 tokens, then 4 teacher-forced decode
    steps, each step's logits against the JAX package's."""
    arch, rcfg, params_np, cfg, model = pair
    tokens = _tokens(cfg, seed=1)
    s0 = S - 4
    rcaches = init_tree(ref_cache_specs(rcfg, B, S), KEY)
    rprefill = ref_make_prefill_step(rcfg, attn_chunk=16, scan_chunk=8)
    want, rcaches = rprefill(params_np, {"tokens": jnp.asarray(tokens[:, :s0])},
                             rcaches)
    caches = model.init_caches(B, S)
    got, caches = make_prefill_step(model)(torch.from_numpy(tokens[:, :s0]),
                                           caches)
    assert got.shape == (B, 1, cfg.padded_vocab)
    assert _err(got, want) < TOL
    decode = make_decode_step(model)
    for t in range(s0, S):
        want, rcaches = ref_decode_step(params_np, rcfg, rcaches,
                                        jnp.asarray(tokens[:, t:t + 1]),
                                        jnp.int32(t))
        nxt, got, caches = decode(caches, torch.from_numpy(tokens[:, t:t + 1]),
                                  t)
        assert _err(got, want) < TOL, t
        assert nxt.shape == (B, 1) and nxt.dtype == torch.int32


def test_serve_batch_shapes(pair):
    arch, rcfg, params_np, cfg, model = pair
    timings = {}
    tokens, tps = serve_batch(cfg, batch=2, prompt_len=8, gen=6, model=model,
                              timings=timings)
    assert tokens.shape == (2, 14) and tokens.dtype == torch.int32
    assert int(tokens.max()) < cfg.padded_vocab and int(tokens.min()) >= 0
    assert tps > 0 and timings["prefill_s"] > 0 and timings["decode_s"] > 0
    again, _ = serve_batch(cfg, batch=2, prompt_len=8, gen=6,
                           params=convert.lm_params_from_numpy(params_np, cfg),
                           device="cpu")
    assert torch.equal(tokens, again)


@pytest.mark.parametrize("circuit,rank", [("mul8s_trunc2", None),
                                          ("mul8s_mitchell", 3)])
def test_approx_policy_logits_match_reference(circuit, rank):
    """The ffn_in policy case of tests/test_system.py (and a rank-3
    correction) on reduced granite-8b: logits against the JAX package's
    under the same policy, and the policy's FFN weights stored float32."""
    rcfg, params_np = _ref_params("granite-8b")
    assign = {"ffn_in": (circuit, rank)}
    policy = ApproxPolicy(assign)
    cfg, model = _port("granite-8b", params_np, policy=policy)
    assert model.layers[0].mlp.wi.dtype == torch.float32
    assert model.layers[0].mlp.wo.dtype == torch.bfloat16
    tokens = _tokens(cfg, seed=2)
    want, _, _ = ref_forward(params_np, rcfg, jnp.asarray(tokens),
                             policy=RefApproxPolicy(assign), remat=False,
                             attn_chunk=16)
    exact, _, _ = ref_forward(params_np, rcfg, jnp.asarray(tokens),
                              remat=False, attn_chunk=16)
    got = model(torch.from_numpy(tokens))
    assert _err(got, want) < TOL
    # the policy changed the logits
    assert _err(got, exact) > 0.0
    tokens, _ = serve_batch(cfg, batch=2, prompt_len=8, gen=4, model=model,
                            policy=policy)
    assert tokens.shape == (2, 12)


def test_registry_lists_only_ported_archs():
    assert get_config("granite-8").name == "granite-8b"
    assert get_config("jamba").name == "jamba-1.5-large-398b"
    # two ported archs start with "granite": ambiguous, as in the JAX
    # package's registry
    with pytest.raises(KeyError, match="unknown arch"):
        ref_get_config("granite")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("granite")
    # the encoder-decoder and vision archs are ported too: the registry
    # is the JAX package's
    assert get_config("seamless-m4t-medium").is_encoder_decoder
    assert get_config("qwen2").name == "qwen2-vl-72b"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_seeded_weights_are_deterministic_and_distributed():
    cfg = reduced(get_config("falcon-mamba-7b"))
    a = build_model(cfg, seed=3, device="cpu").state_dict()
    b = build_model(cfg, seed=3, device="cpu").state_dict()
    c = build_model(cfg, seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.mamba.in_proj"],
                           c["layers.0.mamba.in_proj"])
    assert torch.all(a["layers.0.mamba.A_log"] == 1.0)
    assert torch.all(a["layers.0.mamba.norm"] == 0.0)
    std = float(a["layers.0.mamba.conv_w"].float().std())
    assert 0.08 < std < 0.12          # normal x 0.1
    std = float(a["embed"].float().std())
    assert 0.018 < std < 0.022        # normal x 0.02
