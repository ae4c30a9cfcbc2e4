"""The port's train step on Mamba and hybrid stacks against the JAX
package's, at reduced size.

As ``tests/test_torch_train.py`` does for attention archs: both packages
start from one state (parameters drawn with numpy as the JAX package's
``init_tree`` draws them, its AdamW moments and step and its
error-feedback residuals, carried across by
``convert.train_state_from_numpy``) and run the same batches of the
port's ``TokenPipeline``.  The configs: falcon-mamba-7b reduced (2 Mamba
layers, d 64, 8 states), and jamba-1.5-large at one super-block
(``n_layers=8``: Mamba layers with attention at position 4, MoE on every
other layer) in bf16 master weights and bf16 AdamW moments, as its
config asks (``param_dtype``, ``moment_dtype``), the JAX package's
parameters cast to bf16 for both.  On the CPU the port's scan
differentiates through its plain version (the card's kernels are held
to it in ``tests/test_torch_scan_bwd.py`` and ``chip_smoke.py``).

Tolerances are ``tests/test_torch_train.py``'s, stated again: losses
within ``LOSS_RTOL``, the load-balance loss within ``AUX_RTOL``, each
gradient's norm within ``GRAD_NORM_RTOL`` and its largest elementwise
difference within ``GRAD_MAX_FRAC`` of its largest element, parameters
after three steps by the share of elements further apart than
``PARAM_ATOL`` (``PARAM_FRAC``).  In bf16 masters one rounding of a
parameter is up to 2^-8 of it, far above ``PARAM_ATOL``: the share is
counted there in units of the parameter's own bf16 spacing
(``BF16_PARAM_ULPS``).  jamba's gradients are held by
``DEEP_GRAD_MAX_FRAC`` (its 8 layers, measured), and its MoE layers route
every token to every expert (``ARCHS``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import param_specs as ref_param_specs
from repro.models import reduced as ref_reduced
from repro.models.common import ParamSpec
from repro.optim import AdamW as RefAdamW
from repro.train.step import init_state as ref_init_state
from repro.train.step import make_loss_fn as ref_make_loss_fn
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import Transformer, reduced
from repro_torch.optim import AdamW
from repro_torch.train import init_state, make_loss_fn, make_train_step

from _torch_threads import bounded_torch_threads  # noqa: F401

# jamba at one super-block routes every token to each of the reduced
# config's 4 experts (top-4, a capacity that cannot bind): one bf16
# rounding of a router input can swap a token's second expert in top-2
# (ROADMAP.md §3, "Top-k routing is not continuous"), which moved layer
# 5's expert gradients by up to 39% of their largest element; the top-2
# route's gradient is tests/test_torch_train.py's granite-moe case
ARCHS = {"falcon": ("falcon-mamba-7b", {}),
         "jamba": ("jamba-1.5-large-398b",
                   {"n_layers": 8, "n_experts_active": 4})}
B, S = 4, 16
LR = 1e-3

LOSS_RTOL = 2e-3         # tests/test_torch_train.py
AUX_RTOL = 1e-3
GRAD_NORM_RTOL = 1e-2
GRAD_MAX_FRAC = 2e-2
# jamba's 8 layers carry the two packages' bf16 roundings through 4
# times the depth of test_torch_train.py's 2-layer gemma: its largest
# elementwise gradient difference was 2.0e-2 of the largest element in
# float32 masters and 2.5e-2 in bf16 masters (measured, on Mamba layers'
# dt_proj, A_log and D)
DEEP_GRAD_MAX_FRAC = 4e-2
EF_TOTAL_RTOL = 0.05
PARAM_ATOL = 0.2 * LR
PARAM_FRAC = 0.05
# a bf16 master agrees within one spacing of bf16 at its magnitude (an
# AdamW step of lr moves a weight of 0.25 by less than half a spacing)
BF16_PARAM_ULPS = 1.0


def _cfgs(name):
    arch, over = ARCHS[name]
    return (ref_reduced(ref_get_config(arch), **over),
            reduced(get_config(arch), **over))


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    """The JAX package's parameter tree drawn with numpy as ``init_tree``
    draws it, in the config's master dtype (bf16 for jamba)."""
    rcfg, _ = _cfgs(name)
    rng = np.random.default_rng(0)
    dtype = jnp.dtype(rcfg.param_dtype)

    def draw(spec):
        if spec.init == "zeros":
            a = np.zeros(spec.shape, np.float32)
        elif spec.init == "ones":
            a = np.ones(spec.shape, np.float32)
        else:
            a = (rng.standard_normal(spec.shape) * spec.scale).astype(
                np.float32)
        return np.asarray(jnp.asarray(a, dtype))

    return jax.tree.map(draw, ref_param_specs(rcfg),
                        is_leaf=lambda x: isinstance(x, ParamSpec))


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batch(cfg, step):
    return TokenPipeline(cfg.vocab_size, B, S, seed=0).batch_at(step)


def _flat_ref(tree, cfg):
    return {k: v.float().numpy()
            for k, v in convert.lm_params_from_numpy(_np32(tree),
                                                     cfg).items()}


@torch.no_grad()
def _load_state(state, tree):
    for k, src in tree.items():
        if isinstance(src, dict):
            _load_state(state[k], src)
        else:
            state[k].copy_(src)


def _rel(a, b):
    return float(abs(a - b) / max(abs(b), 1e-12))


def _port(cfg, name):
    model = Transformer(cfg, device="cpu", trainable=True)
    model.load_state_dict(convert.lm_params_from_numpy(
        _np32(_ref_params(name)), cfg))
    return model


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_master_dtype_of_each_config(name):
    """falcon trains float32 masters; jamba bf16 masters and moments, as
    their configs say, every parameter with grad."""
    _, cfg = _cfgs(name)
    model = _port(cfg, name)
    want = getattr(torch, cfg.param_dtype)
    assert all(p.dtype == want and p.requires_grad
               for p in model.parameters())
    opt = AdamW(moment_dtype=cfg.moment_dtype)
    state = init_state(dict(model.named_parameters()), opt)
    assert all(m.dtype == getattr(torch, cfg.moment_dtype)
               for m in state["opt"]["m"].values())
    kinds = {layer.kind.mixer for layer in model.layers}
    assert kinds == ({"mamba"} if name == "falcon" else {"mamba", "attn"})


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_gradients_match_reference(name):
    """Loss, aux and every parameter's gradient against ``jax.grad`` of
    the reference's ``make_loss_fn`` (its chunked scan, remat) on the
    same batch."""
    rcfg, cfg = _cfgs(name)
    params = _ref_params(name)
    batch = _batch(cfg, 0)
    ref_fn = jax.value_and_grad(
        ref_make_loss_fn(rcfg, attn_chunk=8, scan_chunk=8), has_aux=True)
    (ref_loss, ref_parts), ref_g = jax.jit(ref_fn)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port(cfg, name)
    loss, parts = make_loss_fn(model)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert _rel(float(loss.detach()), float(ref_loss)) < LOSS_RTOL
    if cfg.n_experts:
        assert _rel(float(parts["aux"].detach()),
                    float(ref_parts["aux"])) < AUX_RTOL
    got = {k: p.grad for k, p in model.named_parameters()}
    want = _flat_ref(ref_g, cfg)
    assert sorted(got) == sorted(want)
    frac = GRAD_MAX_FRAC if name == "falcon" else DEEP_GRAD_MAX_FRAC
    for k, g in got.items():
        assert g.dtype == getattr(torch, cfg.param_dtype), k
        g, w = g.float().numpy(), want[k]
        assert np.isfinite(g).all(), k
        scale = float(np.abs(w).max())
        if scale == 0.0:
            assert not g.any(), k
            continue
        assert _rel(np.linalg.norm(g), np.linalg.norm(w)) < GRAD_NORM_RTOL, k
        assert float(np.abs(g - w).max()) <= frac * scale, k


STEP_CASES = {
    # case: (arch, n_micro, compress)
    "falcon": ("falcon", 1, False),
    "falcon-micro2-compress": ("falcon", 2, True),
    # two micro-batches: gradients accumulate in the bf16 masters' dtype
    "jamba-micro2": ("jamba", 2, False),
}


def _far(got, want, cfg):
    """Elements of ``got`` further from ``want`` than the agreement
    bound: PARAM_ATOL in float32, one bf16 spacing of the element in
    bf16."""
    if cfg.param_dtype == "float32":
        return int((np.abs(got - want) > PARAM_ATOL).sum())
    spacing = np.maximum(np.abs(want), 1e-30) * 2.0 ** -7
    return int((np.abs(got - want) > BF16_PARAM_ULPS * spacing
                + PARAM_ATOL).sum())


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_three_steps_match_reference(case):
    """Three train steps from one state: loss, ce, aux and grad_norm each
    step, the optimizer step, the parameters and first moments after
    them, and the error-feedback residuals' norm."""
    name, n_micro, compress = STEP_CASES[case]
    rcfg, cfg = _cfgs(name)
    params = jax.tree.map(jnp.asarray, _ref_params(name))
    ref_opt = RefAdamW(lr=LR, warmup_steps=1, moment_dtype=rcfg.moment_dtype)
    ref_state = ref_init_state(params, ref_opt, compress=compress)
    ref_step = jax.jit(ref_make_train_step(
        rcfg, ref_opt, n_micro=n_micro, compress=compress, attn_chunk=8,
        scan_chunk=8))

    model = Transformer(cfg, device="cpu", trainable=True)
    opt = AdamW(lr=LR, warmup_steps=1, moment_dtype=cfg.moment_dtype)
    state = init_state(dict(model.named_parameters()), opt,
                       compress=compress)
    _load_state(state, convert.train_state_from_numpy(
        _np32(jax.tree.map(np.asarray, ref_state)), cfg))
    step = make_train_step(model, opt, n_micro=n_micro, compress=compress)

    for i in range(3):
        b = _batch(cfg, i)
        ref_state, rm = ref_step(ref_state,
                                 {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert _rel(float(m["loss"]), float(rm["loss"])) < LOSS_RTOL, i
        assert _rel(float(m["ce"]), float(rm["ce"])) < LOSS_RTOL, i
        if n_micro > 1:
            assert float(m["aux"]) == float(rm["aux"]) == 0.0
        elif cfg.n_experts:
            assert _rel(float(m["aux"]), float(rm["aux"])) < AUX_RTOL
        assert _rel(float(m["grad_norm"]), float(rm["grad_norm"])) \
            < GRAD_NORM_RTOL, i
    assert int(state["opt"]["step"]) == int(ref_state["opt"]["step"]) == 3

    ref_np = jax.tree.map(np.asarray, ref_state)
    if compress:
        want = _flat_ref(ref_np["ef_err"], cfg)
        total = [np.sqrt(sum(float(np.sum(t.float().numpy() ** 2))
                             for t in state["ef_err"].values())),
                 np.sqrt(sum(float(np.sum(t ** 2)) for t in want.values()))]
        assert _rel(*total) < EF_TOTAL_RTOL, total
    for what, got_tree, want_tree in (
            ("params", state["params"], ref_np["params"]),
            ("m", state["opt"]["m"], ref_np["opt"]["m"])):
        assert all(t.dtype == getattr(torch, cfg.param_dtype if what ==
                                      "params" else cfg.moment_dtype)
                   for t in got_tree.values()), what
        want = _flat_ref(want_tree, cfg)
        far = total = 0
        for k, t in got_tree.items():
            g = t.detach().float().numpy()
            if what == "params":
                far += _far(g, want[k], cfg)
            else:
                atol = DEEP_GRAD_MAX_FRAC * float(np.abs(want[k]).max())
                far += int((np.abs(g - want[k]) > atol).sum())
            total += g.size
        assert far <= PARAM_FRAC * total, (what, far, total)


def test_train_loop_trains_falcon_mamba():
    """``launch/train.py``'s ``train_loop`` on the reduced falcon-mamba
    (the CLI's ``--arch falcon-mamba-7b --reduced --device cpu``): the
    loss falls."""
    from repro_torch.launch.train import train_loop

    _, cfg = _cfgs("falcon")
    _, losses = train_loop(cfg, steps=30, batch=8, seq=32, lr=1e-2,
                           log_every=100, device="cpu")
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_train_cli_cuts_the_depth(capsys):
    """``python -m repro_torch.launch.train --arch falcon-mamba-7b
    --n-layers N``: the depth the card holds, a multiple of the block
    pattern (jamba's is 8)."""
    from repro_torch.launch.train import main

    main(["--arch", "falcon-mamba-7b", "--reduced", "--n-layers", "1",
          "--steps", "2", "--batch", "2", "--seq", "8", "--device", "cpu"])
    assert "first loss" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--arch", "jamba-1.5-large-398b", "--reduced", "--n-layers",
              "4", "--device", "cpu"])
