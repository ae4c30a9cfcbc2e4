"""The port's remaining one-card archs and jamba against the JAX package at
reduced size: gemma-2b (GeGLU, head dim 256, MQA, tied embeddings),
chatglm3-6b (half RoPE, kv 2), deepseek-67b, granite-moe-3b (40 experts
padded to 48 at full size), phi3.5-moe and jamba-1.5-large (Mamba,
attention and MoE in one super-block).  The JAX package's parameters
(``init_tree``) are carried across as numpy by
``convert.lm_params_from_numpy``; both packages run the same tokens.
Logits are bf16 in both, so they are held to the JAX package's bf16
tolerance (0.12, tests/test_models.py), as ``tests/test_torch_lm.py``
holds granite-8b and falcon-mamba-7b."""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import cache_specs as ref_cache_specs
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import param_specs as ref_param_specs
from repro.models import reduced as ref_reduced
from repro.models.common import init_tree
from repro.train.serve import make_prefill_step as ref_make_prefill_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.serve import build_model
from repro_torch.models import ModelConfig, reduced
from repro_torch.train.serve import make_decode_step, make_prefill_step

from _torch_threads import bounded_torch_threads  # noqa: F401

TOL = 0.12          # bf16 logits (tests/test_models.py)
# the load-balance loss summed over the layers: each layer's input
# differs by bf16 roundings between the packages, so the routers' float32
# softmaxes differ a little (the test prints the relative difference,
# run with -s: at most 3e-5, on jamba's 16 layers)
AUX_REL = 1e-3
ARCHS = ["gemma-2b", "chatglm3-6b", "deepseek-67b", "granite-moe-3b-a800m",
         "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b"]
B, S = 2, 24
KEY = jax.random.PRNGKey(0)


def _tokens(cfg, seed=0, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, s)).astype(np.int32)


def _err(got, want):
    return float(np.max(np.abs(got.float().numpy()
                               - np.asarray(want, np.float32))))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    rcfg = ref_reduced(ref_get_config(arch))
    params_np = jax.tree.map(np.asarray,
                             init_tree(ref_param_specs(rcfg), KEY))
    cfg = reduced(get_config(arch))
    sd = convert.lm_params_from_numpy(params_np, cfg)
    return arch, rcfg, params_np, cfg, build_model(cfg, params=sd,
                                                   device="cpu")


@pytest.mark.parametrize("arch", ARCHS + ["seamless-m4t-medium",
                                          "qwen2-vl-72b"])
@pytest.mark.parametrize("cut", ["full", "reduced"])
def test_config_equals_reference_field_for_field(arch, cut):
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    if cut == "reduced":
        rcfg, cfg = ref_reduced(rcfg), reduced(cfg)
    for f in fields(ModelConfig):
        assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
    for prop in ("padded_experts", "padded_vocab", "block_pattern",
                 "n_superblocks", "resolved_head_dim", "param_count",
                 "active_param_count"):
        a, b = getattr(cfg, prop), getattr(rcfg, prop)
        a, b = (a(), b()) if callable(a) else (a, b)
        if prop == "block_pattern":
            a = [(k.mixer, k.mlp, k.cross_attn) for k in a]
            b = [(k.mixer, k.mlp, k.cross_attn) for k in b]
        assert a == b, prop


def test_state_dict_carries_across(pair):
    arch, rcfg, params_np, cfg, model = pair
    sd = convert.lm_params_from_numpy(params_np, cfg)
    assert sorted(sd) == sorted(model.state_dict())
    assert ("lm_head" in sd) == (not cfg.tie_embeddings)
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        if ".moe." in name and leaf in ("wi", "wg", "wo"):
            # no policy reaches the experts: bf16 under every policy
            assert p.dtype == torch.bfloat16, name
            assert p.shape[0] == cfg.padded_experts, name
        elif leaf in ("wq", "wk", "wv", "wo", "wi", "wg", "in_proj",
                      "x_proj", "dt_proj", "out_proj", "embed", "lm_head"):
            assert p.dtype == torch.bfloat16, name
        else:
            assert p.dtype == torch.float32, name
            assert torch.equal(p, sd[name]), name
    kinds = [k for _ in range(cfg.n_superblocks) for k in cfg.block_pattern]
    for j, k in enumerate(kinds):
        layer = model.layers[j]
        assert hasattr(layer, "moe") == (k.mlp == "moe")
        assert hasattr(layer, "attn") == (k.mixer == "attn")


def test_forward_logits_match_reference(pair):
    arch, rcfg, params_np, cfg, model = pair
    tokens = _tokens(cfg)
    want, _, want_aux = ref_forward(params_np, rcfg, jnp.asarray(tokens),
                                    remat=False, attn_chunk=16, scan_chunk=8)
    got = model(torch.from_numpy(tokens))
    assert got.shape == (B, S, cfg.padded_vocab)
    assert got.dtype == torch.bfloat16
    assert _err(got, want) < TOL
    if cfg.n_experts:
        aux = float(model.last_aux)
        rel = abs(aux - float(want_aux)) / float(want_aux)
        print(f"{arch}: aux {aux:.6g}, {rel:.2g} relative to the reference")
        assert aux > 0.0 and rel <= AUX_REL
    else:
        assert model.last_aux is None and float(want_aux) == 0.0


def test_prefill_and_decode_match_reference(pair):
    """Prefill of the first S-4 tokens, then 4 teacher-forced decode
    steps, each step's logits against the JAX package's."""
    arch, rcfg, params_np, cfg, model = pair
    tokens = _tokens(cfg, seed=1)
    s0 = S - 4
    rcaches = init_tree(ref_cache_specs(rcfg, B, S), KEY)
    rprefill = ref_make_prefill_step(rcfg, attn_chunk=16, scan_chunk=8)
    want, rcaches = rprefill(params_np,
                             {"tokens": jnp.asarray(tokens[:, :s0])}, rcaches)
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
