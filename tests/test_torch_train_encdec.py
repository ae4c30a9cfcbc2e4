"""Training the encoder-decoder (seamless-m4t-medium) and vision
front-end (qwen2-vl-72b) families: the port's train step against the
JAX package's at reduced size (2 + 2 layers, d 64, head dim 16,
``frontend_len`` 8).

Both packages start from one state, the JAX package's ``init_tree``
parameters carried across as numpy (``convert.train_state_from_numpy``),
and take the same numpy-seeded tokens, encoder frames and patch
embeddings.  The encoder gets ``S_ENC`` frames, fewer than the
decoder's ``S`` positions, so cross attention trains at sq != sk.
Covered: one step's loss and every gradient, three AdamW steps at
``n_micro`` 2 (the embeddings split into micro-batches with the tokens),
the loss taken on the text positions only, ``train_loop`` on both
families, and the plain attention's gradient at sq != sk against
``jax.grad`` of the JAX package's attention.

Tolerances are ``tests/test_torch_train.py``'s (bf16 forwards in both
packages): losses within ``LOSS_RTOL``, each gradient's norm within
``GRAD_NORM_RTOL`` relative and its largest elementwise difference within
``GRAD_MAX_FRAC`` of its largest element, parameters after the steps by
the share of elements further apart than ``PARAM_ATOL``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.flash_attention.ref import mha_reference
from repro.models import param_specs as ref_param_specs
from repro.models import reduced as ref_reduced
from repro.models.common import init_tree
from repro.optim import AdamW as RefAdamW
from repro.train.step import init_state as ref_init_state
from repro.train.step import make_loss_fn as ref_make_loss_fn
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import attention
from repro_torch.launch.train import step_embeds, train_loop
from repro_torch.models import Transformer, reduced
from repro_torch.optim import AdamW
from repro_torch.train import init_state, make_loss_fn, make_train_step
from repro_torch.train.step import cross_entropy

from _torch_threads import bounded_torch_threads  # noqa: F401

ENCDEC, VLM = "seamless-m4t-medium", "qwen2-vl-72b"
ARCHS = [ENCDEC, VLM]
B, S, S_ENC = 4, 16, 12
LR = 1e-3
KEY = jax.random.PRNGKey(0)

LOSS_RTOL = 2e-3         # as tests/test_torch_train.py
GRAD_NORM_RTOL = 1e-2
GRAD_MAX_FRAC = 2e-2
PARAM_ATOL = 0.2 * LR
PARAM_FRAC = 0.05
# float32 attention, the JAX package's flash tolerance
# (tests/test_kernels.py:168)
ATTN_RTOL, ATTN_ATOL = 1e-4, 1e-5


def _batch(cfg, seed, b=B):
    """Tokens, labels and the front end's inputs, numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    n = S_ENC if cfg.is_encoder_decoder else cfg.frontend_len
    key = "enc_embeds" if cfg.is_encoder_decoder else "embeds"
    out[key] = (rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
                * 0.1)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _rel(a, b):
    return float(abs(a - b) / max(abs(b), 1e-12))


def _flat_ref(tree, cfg):
    return {k: v.float().numpy()
            for k, v in convert.lm_params_from_numpy(tree, cfg).items()}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    rcfg = ref_reduced(ref_get_config(name))
    cfg = reduced(get_config(name))
    params = jax.tree.map(np.asarray, init_tree(ref_param_specs(rcfg), KEY))
    return name, rcfg, cfg, params


def _model(cfg, params):
    model = Transformer(cfg, device="cpu", trainable=True)
    model.load_state_dict(convert.lm_params_from_numpy(params, cfg))
    return model


def test_gradients_match_reference(arch):
    """Loss and every parameter's gradient, the encoder's and cross
    attention's included, against ``jax.grad`` of the JAX package's
    ``make_loss_fn`` on the same batch."""
    name, rcfg, cfg, params = arch
    batch = _batch(cfg, 0)
    ref_fn = jax.value_and_grad(
        ref_make_loss_fn(rcfg, attn_chunk=8, scan_chunk=8), has_aux=True)
    (ref_loss, ref_parts), ref_g = jax.jit(ref_fn)(params, _j(batch))
    model = _model(cfg, params)
    loss, parts = make_loss_fn(model)(_t(batch))
    loss.backward()
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    want = _flat_ref(jax.tree.map(np.asarray, ref_g), cfg)
    assert _rel(float(loss), float(ref_loss)) < LOSS_RTOL
    assert _rel(float(parts["ce"]), float(ref_parts["ce"])) < LOSS_RTOL
    assert sorted(got) == sorted(want)
    if cfg.is_encoder_decoder:
        assert any(k.startswith("encoder.layers.") for k in got)
        assert any(".cross." in k for k in got)
    for k in got:
        g, w = got[k], want[k]
        assert np.isfinite(g).all(), k
        scale = float(np.abs(w).max())
        if scale == 0.0:
            assert not g.any(), k
            continue
        assert _rel(np.linalg.norm(g), np.linalg.norm(w)) < GRAD_NORM_RTOL, k
        assert float(np.abs(g - w).max()) <= GRAD_MAX_FRAC * scale, k


def test_loss_is_taken_on_the_text_positions(arch):
    """The vision arch's logits cover its ``frontend_len`` embeddings and
    the tokens; the loss is the cross entropy of the last ``S``, the
    text's.  The encoder-decoder's logits are the decoder's alone."""
    name, rcfg, cfg, params = arch
    batch = _t(_batch(cfg, 1))
    model = _model(cfg, params)
    with torch.no_grad():
        logits, _ = model.forward_train(
            batch["tokens"], embeds=batch.get("embeds"),
            enc_embeds=batch.get("enc_embeds"))
        loss, parts = make_loss_fn(model)(batch)
    extra = 0 if cfg.is_encoder_decoder else cfg.frontend_len
    assert logits.shape == (B, extra + S, cfg.padded_vocab)
    want = cross_entropy(logits[:, extra:], batch["labels"], cfg.vocab_size)
    assert float(parts["ce"]) == float(want)
    if extra:
        # the front end's positions are not scored
        assert float(want) != float(cross_entropy(
            logits[:, :S], batch["labels"], cfg.vocab_size))


def test_three_steps_at_n_micro_2_match_reference(arch):
    """Three train steps of 2 micro-batches from one state: loss, ce and
    grad_norm each step, then the parameters and first moments."""
    name, rcfg, cfg, params = arch
    ref_opt = RefAdamW(lr=LR, warmup_steps=1)
    ref_state = ref_init_state(params, ref_opt)
    ref_step = jax.jit(ref_make_train_step(rcfg, ref_opt, n_micro=2,
                                           attn_chunk=8, scan_chunk=8))
    model = Transformer(cfg, device="cpu", trainable=True)
    opt = AdamW(lr=LR, warmup_steps=1)
    state = init_state(dict(model.named_parameters()), opt)
    carried = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, ref_state), cfg)
    with torch.no_grad():
        for k, p in state["params"].items():
            p.copy_(carried["params"][k])
    step = make_train_step(model, opt, n_micro=2)
    for i in range(3):
        b = _batch(cfg, 10 + i)
        ref_state, rm = ref_step(ref_state, _j(b))
        state, m = step(state, _t(b))
        for key in ("loss", "ce"):
            assert _rel(float(m[key]), float(rm[key])) < LOSS_RTOL, (i, key)
        assert _rel(float(m["grad_norm"]), float(rm["grad_norm"])) \
            < GRAD_NORM_RTOL, i
    assert int(state["opt"]["step"]) == int(ref_state["opt"]["step"]) == 3
    ref_np = jax.tree.map(np.asarray, ref_state)
    for what, got_tree, want_tree in (
            ("params", state["params"], ref_np["params"]),
            ("m", state["opt"]["m"], ref_np["opt"]["m"])):
        want = _flat_ref(want_tree, cfg)
        far = total = 0
        for k, t in got_tree.items():
            g = t.detach().float().numpy()
            atol = PARAM_ATOL if what == "params" else (
                GRAD_MAX_FRAC * float(np.abs(want[k]).max()))
            far += int((np.abs(g - want[k]) > atol).sum())
            total += g.size
        assert far <= PARAM_FRAC * total, (what, far, total)


def test_micro_batches_split_the_embeddings():
    """Two micro-batches give the gradients of one whole-batch pass (the
    mean of two halves' means), so the embeddings were split with the
    tokens, row i to micro-batch i % 2."""
    cfg = reduced(get_config(ENCDEC))
    model = Transformer(cfg, device="cpu", trainable=True).init_weights(1)
    batch = _t(_batch(cfg, 3))
    names = [k for k, _ in model.named_parameters()]
    grads = []
    for n_micro in (1, 2):
        opt = AdamW(lr=0.0, warmup_steps=1)
        state = init_state(dict(model.named_parameters()), opt)
        seen = []

        def keep(g, seen=seen):
            seen.append(g.clone())
            return g
        make_train_step(model, opt, n_micro=n_micro, grad_reduce=keep)(
            state, batch)
        grads.append(seen)
    assert len(grads[0]) == len(grads[1]) == len(names)
    for k, g, g2 in zip(names, *grads):
        scale = float(g.abs().max())
        assert float((g - g2).abs().max()) <= 1e-2 * scale + 1e-9, k


@pytest.mark.parametrize("name", ARCHS)
def test_train_loop_reduces_loss(name):
    """``train_loop`` on each family: the batches carry the step's
    front-end inputs (``step_embeds``), and the loss falls
    (tests/test_torch_train.py's run: vocab 128, 60 steps of 8 x 32 at
    lr 1e-2)."""
    cfg = reduced(get_config(name), vocab_size=128)
    extra = step_embeds(cfg, 3, 2, 16)
    key = "enc_embeds" if cfg.is_encoder_decoder else "embeds"
    n = 16 if cfg.is_encoder_decoder else cfg.frontend_len
    assert list(extra) == [key] and extra[key].shape == (2, n, cfg.d_model)
    assert torch.equal(extra[key], step_embeds(cfg, 3, 2, 16)[key])
    assert not torch.equal(extra[key], step_embeds(cfg, 4, 2, 16)[key])
    _, losses = train_loop(cfg, steps=60, batch=8, seq=32, lr=1e-2,
                           log_every=100, device="cpu")
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_train_loop_takes_the_callers_embeddings():
    """``embeds_at`` replaces the step's drawn inputs: the same numpy
    frames through both give the same losses as a hand-run step."""
    cfg = reduced(get_config(VLM))
    frames = {s: {"embeds": torch.from_numpy(_batch(cfg, 20 + s)["embeds"])}
              for s in range(3)}
    _, a = train_loop(cfg, steps=3, batch=B, seq=S, log_every=100,
                      device="cpu", embeds_at=frames.__getitem__)
    _, b = train_loop(cfg, steps=3, batch=B, seq=S, log_every=100,
                      device="cpu")
    _, c = train_loop(cfg, steps=3, batch=B, seq=S, log_every=100,
                      device="cpu", embeds_at=frames.__getitem__)
    assert a == c and a != b


@pytest.mark.parametrize("h,kvh,sq,sk", [(4, 2, 24, 12), (4, 4, 5, 40),
                                         (2, 1, 33, 1)])
def test_plain_attention_grad_at_sq_ne_sk(h, kvh, sq, sk):
    """The port's plain attention (the CPU path of the training forward)
    differentiates non-causally at sq != sk as ``jax.grad`` of the JAX
    package's ``mha_reference``, float32."""
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.standard_normal((2, h, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, kvh, sk, 16)).astype(np.float32)
    v = rng.standard_normal((2, kvh, sk, 16)).astype(np.float32)
    do = rng.standard_normal((2, h, sq, 16)).astype(np.float32)

    def ref(q, k, v):
        return jnp.sum(mha_reference(q, k, v, causal=False) * do)

    want = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = attention(*ts, causal=False)
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=ATTN_RTOL,
                                   atol=ATTN_ATOL)
