"""``chip_smoke.py``'s serve-phase check model (``_prefix_model``) on the
CPU: the first layers of a served model, sharing its parameters, with
the MoE layers routing every token to every real expert and a slot for
each, while the model itself keeps the published top-k and capacity."""

import importlib.util
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import build_model
from repro_torch.models import reduced
from repro_torch.models.common import rms_norm
from repro_torch.models.moe import moe_routing

from _torch_threads import bounded_torch_threads  # noqa: F401


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load_chip_smoke()
B, S = 2, 64


def _model(arch, **over):
    cfg = replace(reduced(get_config(arch)), **over)
    return build_model(cfg, seed=0, device="cpu")


def _tokens(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g)


# 20 experts pad to 32, masked out of routing; 3 are left unpadded
@pytest.mark.parametrize("arch,n_experts", [("granite-moe-3b-a800m", 20),
                                            ("phi3.5-moe-42b-a6.6b", 3)])
def test_prefix_model_routes_densely_and_shares_weights(arch, n_experts):
    # a capacity that binds at this size, so that the prefix's change
    # shows
    model = _model(arch, n_experts=n_experts, capacity_factor=0.5)
    cfg = model.cfg
    part = chip_smoke._prefix_model(model, 2)
    assert part.cfg.n_layers == 2 and len(part.layers) == 2
    assert part.cfg.n_experts_active == n_experts
    # the served model is untouched
    assert len(model.layers) == cfg.n_layers
    assert all((layer.moe.cfg.capacity_factor, layer.moe.cfg.n_experts_active)
               == (0.5, 2) for layer in model.layers)
    # the same parameters, not copies
    for j in range(2):
        for name, p in part.layers[j].named_parameters():
            assert p.data_ptr() == dict(
                model.layers[j].named_parameters())[name].data_ptr()
    tokens = _tokens(cfg)
    x = part.embed_tokens(tokens)
    moe = part.layers[0].moe
    h = rms_norm(x, moe.norm, cfg.rms_eps)
    r = moe_routing(h, moe.router, moe.cfg)
    # every real expert of every token, none dropped, at every length a
    # check runs (the prefill and single decode tokens)
    assert bool(r.keep.all())
    assert torch.equal(r.idx.sort(-1).values,
                       torch.arange(n_experts).expand(B, S, n_experts))
    for s in (1, 5, S):
        assert bool(moe_routing(h[:, :s], moe.router, moe.cfg).keep.all())
    assert not bool(moe_routing(h, moe.router, model.layers[0].moe.cfg)
                    .keep.all())
    # its forward is that of a model built at that depth and capacity
    # from the same weights
    want_cfg = part.cfg
    sd = {k: v for k, v in model.state_dict().items()
          if not k.startswith("layers.") or int(k.split(".")[1]) < 2}
    want = build_model(want_cfg, params=sd, device="cpu")
    assert torch.equal(part(tokens), want(tokens))


def test_prefix_model_of_a_dense_arch_keeps_its_config():
    model = _model("gemma-2b")
    assert chip_smoke._prefix_model(model, model.cfg.n_layers) is model
    part = chip_smoke._prefix_model(model, 1)
    assert part.cfg == replace(model.cfg, n_layers=1)
    tokens = _tokens(model.cfg)
    want = build_model(part.cfg, params={
        k: v for k, v in model.state_dict().items()
        if not k.startswith("layers.") or int(k.split(".")[1]) < 1},
        device="cpu")
    assert torch.equal(part(tokens), want(tokens))


def test_prefix_model_of_an_encoder_decoder_keeps_its_encoder():
    """The check model of seamless-m4t-medium: the first decoder layers
    (each with its cross attention) beside the whole encoder, the same
    parameters; its forward is that of a model built at that depth."""
    model = _model("seamless-m4t-medium", n_layers=3)
    part = chip_smoke._prefix_model(model, 1)
    assert part.cfg.n_layers == 1 and len(part.layers) == 1
    assert part.encoder is model.encoder
    assert len(part.encoder.layers) == model.cfg.n_enc_layers
    assert hasattr(part.layers[0], "cross")
    tokens = _tokens(model.cfg)
    enc = torch.randn((B, 16, model.cfg.d_model),
                      generator=torch.Generator().manual_seed(1)) * 0.1
    want = build_model(part.cfg, params={
        k: v for k, v in model.state_dict().items()
        if not k.startswith("layers.") or int(k.split(".")[1]) < 1},
        device="cpu")
    assert torch.equal(part(tokens, enc_embeds=enc),
                       want(tokens, enc_embeds=enc))


@pytest.mark.parametrize("arch,prefill,request_", [
    # 12 encoder + 12 self + 12 cross in prefill, 12 cross a decode step
    ("seamless-m4t-medium", 36, 36 + 12 * 31),
    ("qwen2-vl-72b", 80, 80),
    ("granite-8b", 36, 36),
])
def test_kernel_calls_of_a_served_request(arch, prefill, request_):
    """The serve phases' launch gate at the published depth: the flash
    forward once a layer that runs it in prefill, and once a cross
    attention layer in each of the 31 decode steps of a 32-token
    request."""
    cfg = get_config(arch)
    assert chip_smoke._kernel_calls(cfg)["flash_attention_sm90"] == prefill
    assert chip_smoke._kernel_calls(
        cfg, steps=chip_smoke.SERVE["gen"] - 1)["flash_attention_sm90"] \
        == request_
    mamba = get_config("falcon-mamba-7b")
    assert chip_smoke._kernel_calls(mamba) == {"flash_attention_sm90": 0,
                                               "selective_scan": 64}


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_form_honours_causal(causal):
    """The JAX model code's form of attention that the serve phases
    measure their spread with: masked only where causal (the encoder and
    cross attention call it non-causal, over fewer keys than queries);
    within a bf16 rounding of the plain version either way."""
    from repro_torch.kernels.flash_attention import attention_ref

    g = torch.Generator().manual_seed(2)
    sk = 24 if causal else 5
    q = torch.randn((2, 4, 24, 16), generator=g).to(torch.bfloat16)
    k, v = (torch.randn((2, 2, sk, 16), generator=g).to(torch.bfloat16)
            for _ in range(2))
    got = chip_smoke._chunked_form_attention(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2e-2)
    if not causal:
        # the first query sees every key, not only the first
        first = attention_ref(q[:, :, :1], k[:, :, :1], v[:, :, :1])
        assert not torch.allclose(got[:, :, :1].float(), first.float())
