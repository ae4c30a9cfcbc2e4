"""The encoder-decoder (seamless-m4t-medium) and vision front-end
(qwen2-vl-72b) families of the port against the JAX package at reduced
size (2 + 2 layers, d 64, head dim 16, ``frontend_len`` 8).

The JAX package's parameters (``init_tree``) are carried across as numpy
by ``convert.lm_params_from_numpy``, and both packages take the same
numpy-seeded tokens, encoder frames and patch embeddings (their RNGs
differ, so neither draws its own here).  Covered: the encoder
(``encode``), the forward's logits with ``embeds`` / ``enc_embeds``,
prefill's last-position logits and 3 decode steps (the cross cache, the
vision arch's position offset), the state dict's name map, the
``LMAccelerator`` on seamless (QoR against the JAX package's, the
deployment's count); training is ``tests/test_torch_train_encdec.py``'s.
Logits are
bf16 in both, so they are held to the JAX package's bf16 tolerance
(0.12, tests/test_models.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel.lm import LMAccelerator as RefLM
from repro.configs import get_config as ref_get_config
from repro.core.acl.library import default_library as ref_library
from repro.models import cache_specs as ref_cache_specs
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import param_specs as ref_param_specs
from repro.models import reduced as ref_reduced
from repro.models.common import init_tree
from repro.models.transformer import encode as ref_encode
from repro.train.serve import make_prefill_step as ref_make_prefill_step
from repro_torch import convert
from repro_torch.accel import LMAccelerator
from repro_torch.accel.lm import ENC_FRAMES
from repro_torch.configs import get_config
from repro_torch.core import qor
from repro_torch.core.acl.library import default_library
from repro_torch.kernels.approx_matmul import from_circuit
from repro_torch.launch.serve import build_model, serve_batch
from repro_torch.models import reduced
from repro_torch.train.serve import (frontend_inputs, make_decode_step,
                                     make_prefill_step)

from _torch_threads import bounded_torch_threads  # noqa: F401

TOL = 0.12          # bf16 logits (tests/test_models.py)
QOR_TOL_DB = 0.5    # as tests/test_torch_lm_dse.py
ENCDEC, VLM = "seamless-m4t-medium", "qwen2-vl-72b"
ARCHS = [ENCDEC, VLM]
B, S = 2, 24
S_ENC = 16
KEY = jax.random.PRNGKey(0)


def _tokens(cfg, seed=0, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, s)).astype(np.int32)


def _embeds(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
            * 0.1)


def _extra(cfg, seed=5):
    """The batch's front-end inputs, numpy: ``enc_embeds`` for the
    encoder-decoder, ``embeds`` for the vision front end."""
    if cfg.is_encoder_decoder:
        return {"enc_embeds": _embeds(cfg, S_ENC, seed)}
    return {"embeds": _embeds(cfg, cfg.frontend_len, seed)}


def _t(extra):
    return {k: torch.from_numpy(v) for k, v in extra.items()}


def _j(extra):
    return {k: jnp.asarray(v) for k, v in extra.items()}


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


def test_state_dict_carries_across(pair):
    """Every parameter is filled from the JAX package's tree, shaped as
    its unstacked leaf; ``param_specs`` and ``init_weights`` cover the
    same parameters, in ``named_parameters``' order."""
    arch, rcfg, params_np, cfg, model = pair
    sd = convert.lm_params_from_numpy(params_np, cfg)
    assert sorted(sd) == sorted(model.state_dict())
    specs = model.param_specs()
    assert list(specs) == [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        assert tuple(specs[name].shape) == tuple(p.shape), name
        assert torch.equal(p.float(), sd[name].to(p.dtype).float()), name
    enc_names = [n for n in sd if n.startswith("encoder.")]
    cross_names = [n for n in sd if ".cross." in n]
    if cfg.is_encoder_decoder:
        leaves = params_np["encoder"]["blocks"]
        assert len(enc_names) == (
            cfg.n_enc_layers * sum(len(v) for v in leaves.values()) + 1)
        np.testing.assert_array_equal(
            sd["encoder.layers.1.attn.wq"].numpy(),
            np.asarray(leaves["attn"]["wq"][1]))
        assert len(cross_names) == cfg.n_layers * 5
        np.testing.assert_array_equal(
            sd["layers.1.cross.wk"].numpy(),
            np.asarray(params_np["blocks"]["layer0"]["cross"]["wk"][1]))
        assert all(hasattr(layer, "cross") for layer in model.layers)
    else:
        assert not enc_names and not cross_names
    seeded = build_model(cfg, seed=3, device="cpu")
    assert sorted(seeded.state_dict()) == sorted(sd)


def test_stacked_leaf_with_wrong_leading_axis_raises():
    cfg = reduced(get_config(ENCDEC))
    rcfg = ref_reduced(ref_get_config(ENCDEC))
    tree = jax.tree.map(np.asarray, init_tree(ref_param_specs(rcfg), KEY))
    tree["encoder"]["blocks"]["mlp"]["wo"] = (
        tree["encoder"]["blocks"]["mlp"]["wo"][:1])
    with pytest.raises(ValueError, match="expected 2 encoder layers"):
        convert.lm_params_from_numpy(tree, cfg)


def test_encoder_matches_reference(pair):
    arch, rcfg, params_np, cfg, model = pair
    if not cfg.is_encoder_decoder:
        with pytest.raises(ValueError, match="has no encoder"):
            model.encode(torch.zeros(B, S_ENC, cfg.d_model))
        return
    enc = _embeds(cfg, S_ENC, seed=9)
    want = ref_encode(params_np, rcfg, jnp.asarray(enc), remat=False)
    got = model.encode(torch.from_numpy(enc))
    assert got.shape == (B, S_ENC, cfg.d_model)
    assert got.dtype == torch.bfloat16
    assert _err(got, want) < TOL


def test_forward_logits_match_reference(pair):
    arch, rcfg, params_np, cfg, model = pair
    tokens = _tokens(cfg)
    extra = _extra(cfg)
    want, _, _ = ref_forward(params_np, rcfg, jnp.asarray(tokens),
                             remat=False, attn_chunk=16, **_j(extra))
    got = model(torch.from_numpy(tokens), **_t(extra))
    front = cfg.frontend_len if cfg.frontend == "vision" else 0
    assert got.shape == (B, front + S, cfg.padded_vocab)
    assert got.dtype == torch.bfloat16
    assert _err(got, want) < TOL
    if cfg.is_encoder_decoder:
        # the encoder's frames reach the logits, and are required
        other = model(torch.from_numpy(tokens),
                      enc_embeds=torch.from_numpy(_embeds(cfg, S_ENC, 6)))
        assert _err(other, want) > TOL
        with pytest.raises(ValueError, match="pass enc_embeds"):
            model(torch.from_numpy(tokens))
    else:
        # the patch embeddings sit before the text and move its logits
        text = model(torch.from_numpy(tokens))
        assert _err(text, want[:, front:]) > TOL


def test_prefill_and_decode_match_reference(pair):
    """Prefill of the first S-3 tokens (after the patch embeddings, or
    against the encoder's frames), then 3 teacher-forced decode steps
    (cross attention over the cached encoder k/v; the vision arch's
    positions shifted by ``frontend_len``), each step's logits against
    the JAX package's."""
    arch, rcfg, params_np, cfg, model = pair
    tokens = _tokens(cfg, seed=1)
    extra = _extra(cfg, seed=2)
    s0 = S - 3
    front = cfg.frontend_len if cfg.frontend == "vision" else 0
    enc_len = S_ENC if cfg.is_encoder_decoder else 0
    max_len = front + S
    rcaches = init_tree(ref_cache_specs(rcfg, B, max_len, enc_len=enc_len),
                        KEY)
    rprefill = ref_make_prefill_step(rcfg, attn_chunk=16, scan_chunk=8)
    out = rprefill(params_np, {"tokens": jnp.asarray(tokens[:, :s0]),
                               **_j(extra)}, rcaches)
    want, rcaches = out[0], out[1]
    enc_out = out[2] if cfg.is_encoder_decoder else None
    caches = model.init_caches(B, max_len, enc_len)
    if cfg.is_encoder_decoder:
        assert caches[0]["cross"]["k"].shape == (
            B, cfg.n_kv_heads, enc_len, cfg.resolved_head_dim)
        assert caches[0]["cross"]["k"].dtype == torch.bfloat16
    got, caches = make_prefill_step(model)(torch.from_numpy(tokens[:, :s0]),
                                           caches, **_t(extra))
    assert got.shape == (B, 1, cfg.padded_vocab)
    assert _err(got, want) < TOL
    if cfg.is_encoder_decoder:
        # the cross cache holds the encoder's k/v as the JAX package's
        for j, c in enumerate(caches):
            rk = np.asarray(rcaches["layer0"]["cross"]["k"][j], np.float32)
            assert float(np.max(np.abs(c["cross"]["k"].float().numpy()
                                       - rk))) < TOL
    decode = make_decode_step(model)
    for t in range(s0, S):
        want, rcaches = ref_decode_step(params_np, rcfg, rcaches,
                                        jnp.asarray(tokens[:, t:t + 1]),
                                        jnp.int32(front + t),
                                        enc_out=enc_out)
        nxt, got, caches = decode(caches, torch.from_numpy(tokens[:, t:t + 1]),
                                  front + t)
        assert _err(got, want) < TOL, t
        assert nxt.shape == (B, 1) and nxt.dtype == torch.int32


def test_generate_shapes_and_front_end_inputs(pair):
    """``serve_batch`` keeps the JAX package's shapes: tokens (b, L +
    gen); 16 encoder frames or ``frontend_len`` patch embeddings drawn
    from the seed where none are given, the given ones used as they
    are."""
    arch, rcfg, params_np, cfg, model = pair
    prompts = torch.from_numpy(_tokens(cfg, seed=3, s=8))
    extra = frontend_inputs(cfg, B, seed=4)
    key = "enc_embeds" if cfg.is_encoder_decoder else "embeds"
    n = 16 if cfg.is_encoder_decoder else cfg.frontend_len
    assert [k for k, v in extra.items() if v is not None] == [key]
    assert extra[key].shape == (B, n, cfg.d_model)
    assert torch.equal(frontend_inputs(cfg, B, seed=4)[key], extra[key])
    a, _ = serve_batch(cfg, prompts=prompts, gen=5, model=model, seed=4)
    b, _ = serve_batch(cfg, prompts=prompts, gen=5, model=model,
                       **{key: extra[key]})
    assert a.shape == (B, 8 + 5) and torch.equal(a, b)
    assert torch.equal(a[:, :8], prompts.to(torch.int32))
    with pytest.raises(ValueError, match="must be"):
        serve_batch(cfg, prompts=prompts, gen=2, model=model,
                    **{key: extra[key][:, :3, :5]})


@pytest.fixture(scope="module")
def lm_pair():
    racc = RefLM(ref_get_config(ENCDEC))
    tree = jax.tree.map(np.asarray, racc._ensure_params())
    cfg = get_config(ENCDEC)
    acc = LMAccelerator(cfg, device="cpu", params=convert.lm_params_from_numpy(
        tree, reduced(cfg)))
    return racc, acc


def test_lm_accelerator_qor_matches_reference(lm_pair):
    """3 genomes on the reduced seamless: the exact one at the cap in
    both, the others' QoR within ``QOR_TOL_DB`` of the JAX package's (the
    same encoder frames: ``np.random.default_rng(seed)`` x 0.1)."""
    racc, acc = lm_pair
    lib = default_library()
    sizes = acc.gene_sizes(lib)
    g = np.random.default_rng(11).integers(0, sizes[None, :],
                                           size=(3, len(sizes)))
    g[0] = acc.exact_genome(lib)
    inputs = acc.sample_inputs(2, seed=1234)
    got = acc.qor_batch(g, lib, inputs, device="cpu")
    want = racc.qor_batch(g, ref_library(), inputs)
    assert got[0] == want[0] == qor.PSNR_CAP
    assert np.all(got[1:] < qor.PSNR_CAP)
    assert np.max(np.abs(got - want)) <= QOR_TOL_DB


def test_lm_accelerator_deploy_cost_counts_encoder_and_cross(lm_pair):
    """The exact deployment's flops: every projection's 2·m·k·n (the
    encoder's and cross attention's keys and values over batch x 16
    rows) and every attention core (16 x 16 encoder pairs, causal
    self-attention, seq x 16 cross pairs), counted here independently;
    an approximated design costs more, and both are finite."""
    _, acc = lm_pair
    cfg, b, s = acc.cfg, acc.batch, acc.seq
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    hdq = cfg.n_heads * cfg.resolved_head_dim
    hdkv = cfg.n_kv_heads * cfg.resolved_head_dim
    m, me = b * s, b * ENC_FRAMES
    mlp = 3 * d * f
    enc = cfg.n_enc_layers * (me * (d * hdq + 2 * d * hdkv + hdq * d)
                              + me * mlp)
    dec = cfg.n_layers * (m * (d * hdq + 2 * d * hdkv + hdq * d)
                          + m * (d * hdq + hdq * d) + me * 2 * d * hdkv
                          + m * mlp)
    pairs = (cfg.n_enc_layers * ENC_FRAMES ** 2
             + cfg.n_layers * (s * (s + 1) / 2 + s * ENC_FRAMES))
    want = (2.0 * (enc + dec + m * d * v)
            + 4.0 * b * cfg.n_heads * cfg.resolved_head_dim * pairs)
    lib = default_library()
    exact = acc.deploy_cost([from_circuit(c) for c in acc.decode(
        acc.exact_genome(lib), lib)[0]])
    assert exact["flops"] == want
    approx = acc.deploy_cost([from_circuit(lib["mul8s_mitchell"])]
                             * len(acc.slots))
    for k in ("flops", "hbm_bytes"):
        assert np.isfinite(exact[k]) and np.isfinite(approx[k])
        assert approx[k] > exact[k] > 0
