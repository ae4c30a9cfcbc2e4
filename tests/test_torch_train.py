"""The port's train step against the JAX package's at reduced size.

Both packages start from one state: parameters in the JAX package's
tree (drawn with numpy as its ``init_tree`` draws them), its AdamW
moments and step and its error-feedback residuals, carried across as numpy by ``convert.train_state_from_numpy``;
both run the same batches of the port's ``TokenPipeline`` (byte-equal to
the JAX package's, ``tests/test_torch_optim_data.py``).  The configs are
``tests/test_system.py``'s ``tiny_cfg`` (gemma-2b at 2 layers, d 32,
vocab 128) and the reduced granite-moe-3b (4 experts, top-2).

Tolerances.  Both forwards run in bf16 and round at different places
(the JAX model code scales q in bf16 before its float32 attention, the
port's plain attention after the cast; XLA and torch round a bf16
sigmoid differently), so the scalars and every gradient are held to a
bf16 tolerance: losses within ``LOSS_RTOL``; each gradient's norm within
``GRAD_NORM_RTOL`` relative and its largest elementwise difference
within ``GRAD_MAX_FRAC`` of its largest element.  AdamW's first steps
move each weight by about lr * sign(g), so a gradient near 0 can flip
its sign between the packages: parameters after the steps are held by
the share of elements further apart than ``PARAM_ATOL``
(``PARAM_FRAC``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import ApproxPolicy as RefApproxPolicy
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
from repro_torch.models import ApproxPolicy, Transformer, reduced
from repro_torch.optim import AdamW
from repro_torch.train import init_state, make_loss_fn, make_train_step

from _torch_threads import bounded_torch_threads  # noqa: F401

TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
            d_ff=64, vocab_size=128)
ARCHS = {"gemma": ("gemma-2b", TINY), "moe": ("granite-moe-3b-a800m", {})}
APPROX = {"ffn_in": ("mul8s_mitchell", None),
          "ffn_out": ("mul8s_mitchell", None)}
B, S = 4, 16
LR = 1e-3

LOSS_RTOL = 2e-3         # loss, ce (bf16 logits, float32 CE)
AUX_RTOL = 1e-3          # the load-balance loss (tests/test_torch_archs.py)
GRAD_NORM_RTOL = 1e-2    # each gradient's norm (measured: <= 1.3e-3)
GRAD_MAX_FRAC = 2e-2     # largest elementwise difference / largest element
                         # (measured: <= 1.2e-2, on the MoE router)
# under the approximate FFN policy an FFN tensor's gradient is one or a
# few elements, each a sum over the whole projection's output through
# the quantization scale, in which terms of both signs cancel: bf16
# rounding noise shows there at up to 4.4% (measured on layers.1)
SCALE_GRAD_RTOL = 0.1
EF_TOTAL_RTOL = 0.05     # error-feedback residuals: the whole state's
EF_NORM_RTOL = 0.1       # norm, and each matrix's (measured: <= 5.2e-2)
PARAM_ATOL = 0.2 * LR    # a parameter "agrees" within a fifth of one step
PARAM_FRAC = 0.05        # share of elements allowed past PARAM_ATOL


def _cfgs(name):
    arch, over = ARCHS[name]
    return (ref_reduced(ref_get_config(arch), **over),
            reduced(get_config(arch), **over))


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    """Initial parameters of ``name`` in the JAX package's tree, drawn
    with numpy as ``init_tree`` draws them (normal x scale, zeros,
    ones), so that both packages start from one set."""
    rcfg, _ = _cfgs(name)
    rng = np.random.default_rng(0)

    def draw(spec):
        if spec.init == "zeros":
            return np.zeros(spec.shape, np.float32)
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        return (rng.standard_normal(spec.shape) * spec.scale).astype(
            np.float32)

    return jax.tree.map(draw, ref_param_specs(rcfg),
                        is_leaf=lambda x: isinstance(x, ParamSpec))


def _batch(cfg, step, b=B, s=S):
    return TokenPipeline(cfg.vocab_size, b, s, seed=0).batch_at(step)


def _port_model(cfg, params_np):
    model = Transformer(cfg, device="cpu", trainable=True)
    model.load_state_dict(convert.lm_params_from_numpy(params_np, cfg))
    return model


@torch.no_grad()
def _load_state(state, tree):
    """Copy every leaf of ``tree`` (``convert.train_state_from_numpy``'s)
    into the port's train state, in place."""
    for k, src in tree.items():
        if isinstance(src, dict):
            _load_state(state[k], src)
        else:
            state[k].copy_(src)


def _rel(a, b):
    return float(abs(a - b) / max(abs(b), 1e-12))


def _flat_ref(tree, cfg):
    """The JAX package's parameter-shaped tree in the port's names."""
    return {k: v.float().numpy()
            for k, v in convert.lm_params_from_numpy(tree, cfg).items()}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch_pair(request):
    rcfg, cfg = _cfgs(request.param)
    return request.param, rcfg, cfg, _ref_params(request.param)


def test_master_weights_and_bits_at_use(arch_pair):
    """Every parameter of a trainable model is float32 with grad; its
    training forward's logits equal the serving model's (bf16 storage)
    on the same weights, bit for bit (the serving logits are held to the
    reference in tests/test_torch_archs.py)."""
    from repro_torch.launch.serve import build_model

    name, rcfg, cfg, params = arch_pair
    model = _port_model(cfg, params)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    serving = build_model(cfg, params=convert.lm_params_from_numpy(
        params, cfg), device="cpu")
    assert not any(p.requires_grad for p in serving.parameters())
    tokens = torch.from_numpy(_batch(cfg, 0)["tokens"])
    logits, aux = model.forward_train(tokens)
    assert logits.requires_grad
    assert torch.equal(logits.detach(), serving(tokens))
    if cfg.n_experts:
        assert aux.requires_grad
        assert float(aux.detach()) == float(serving.last_aux)
    else:
        assert float(aux) == 0.0


_GRADS = {}


def _grads_pair(rcfg, cfg, params, policy_map):
    """Both packages' loss, aux and gradients on batch 0 (memoised: the
    approximate case serves two tests)."""
    key = (cfg.name, bool(policy_map))
    if key not in _GRADS:
        _GRADS[key] = _grads(rcfg, cfg, params, policy_map)
    return _GRADS[key]


def _grads(rcfg, cfg, params, policy_map):
    batch = _batch(cfg, 0)
    ref_policy = RefApproxPolicy(policy_map) if policy_map else None
    ref_fn = jax.value_and_grad(
        ref_make_loss_fn(rcfg, ref_policy, attn_chunk=8, scan_chunk=8),
        has_aux=True)
    (ref_loss, ref_parts), ref_g = jax.jit(ref_fn)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(cfg, params)
    policy = ApproxPolicy(policy_map) if policy_map else None
    loss, parts = make_loss_fn(model, policy)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    want = _flat_ref(jax.tree.map(np.asarray, ref_g), cfg)
    return (float(loss), float(parts["aux"].detach()), float(ref_loss),
            float(ref_parts["aux"]), got, want, model)


@pytest.mark.parametrize("case", ["gemma", "gemma-approx", "moe"])
def test_gradients_match_reference(case):
    """Loss, aux and every parameter's gradient against ``jax.grad`` of
    the reference's ``make_loss_fn`` on the same batch."""
    name = case.split("-")[0]
    rcfg, cfg = _cfgs(name)
    params = _ref_params(name)
    loss, aux, ref_loss, ref_aux, got, want, model = _grads_pair(
        rcfg, cfg, params, APPROX if case.endswith("approx") else None)
    assert _rel(loss, ref_loss) < LOSS_RTOL
    if cfg.n_experts:
        assert _rel(aux, ref_aux) < AUX_RTOL
    assert sorted(got) == sorted(want)
    for k in got:
        g, w = got[k], want[k]
        assert np.isfinite(g).all(), k
        scale = float(np.abs(w).max())
        if scale == 0.0:
            assert not g.any(), k
            continue
        rtol, frac = GRAD_NORM_RTOL, GRAD_MAX_FRAC
        if case.endswith("approx") and ".mlp." in k:
            rtol = frac = SCALE_GRAD_RTOL
        assert _rel(np.linalg.norm(g), np.linalg.norm(w)) < rtol, k
        assert float(np.abs(g - w).max()) <= frac * scale, k


def test_approx_gradient_flows_only_through_the_scales():
    """Under an approximate FFN policy the quantized operands are
    integers: a projection weight's gradient reaches only its max-|w|
    elements, through the per-tensor scale, split evenly among ties; the
    port adds no straight-through estimator, as the reference has none."""
    rcfg, cfg = _cfgs("gemma")
    params = _ref_params("gemma")
    *_, got, want, model = _grads_pair(rcfg, cfg, params, APPROX)
    weights = dict(model.named_parameters())
    n_ffn = 0
    for k, g in got.items():
        if ".mlp.w" not in k:
            continue
        n_ffn += 1
        w = np.abs(weights[k].detach().numpy())
        assert not g[w < w.max()].any(), k
        assert np.array_equal(g != 0, want[k] != 0), k
        # a tie at the maximum would share the gradient evenly
        top = g[w == w.max()]
        assert np.allclose(top, top.mean()), k
    assert n_ffn == 3 * cfg.n_layers
    # the exact routes keep dense gradients
    assert np.count_nonzero(got["layers.0.attn.wq"]) > 0.9 * got[
        "layers.0.attn.wq"].size


STEP_CASES = {
    # case: (arch, n_micro, compress, policy)
    "gemma": ("gemma", 1, False, None),
    "gemma-micro2-compress": ("gemma", 2, True, None),
    "gemma-approx": ("gemma", 1, False, APPROX),
    "moe": ("moe", 1, False, None),
    "moe-micro2": ("moe", 2, False, None),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_three_steps_match_reference(case):
    """Three train steps from one state: loss, ce, aux and grad_norm each
    step, the optimizer step count, and the parameters, moments and
    residuals after them."""
    name, n_micro, compress, pmap = STEP_CASES[case]
    rcfg, cfg = _cfgs(name)
    params = _ref_params(name)
    ref_opt = RefAdamW(lr=LR, warmup_steps=1)
    ref_state = ref_init_state(params, ref_opt, compress=compress)
    ref_step = jax.jit(ref_make_train_step(
        rcfg, ref_opt, n_micro=n_micro, compress=compress,
        policy=RefApproxPolicy(pmap) if pmap else None,
        attn_chunk=8, scan_chunk=8))

    model = Transformer(cfg, device="cpu", trainable=True)
    opt = AdamW(lr=LR, warmup_steps=1)
    state = init_state(dict(model.named_parameters()), opt,
                       compress=compress)
    _load_state(state, convert.train_state_from_numpy(
        jax.tree.map(np.asarray, ref_state), cfg))
    step = make_train_step(model, opt, n_micro=n_micro, compress=compress,
                           policy=ApproxPolicy(pmap) if pmap else None)

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
        assert float(m["lr"]) == float(rm["lr"])
    assert int(state["opt"]["step"]) == int(ref_state["opt"]["step"]) == 3

    ref_np = jax.tree.map(np.asarray, ref_state)
    if compress:
        # a residual is the rounding left by int8 quantization, and
        # gradient noise at the bf16 level moves it by about as much as
        # its own size: held by norms, the whole state's and each
        # matrix's (a 32-element norm vector's residual norm is itself
        # noise, 24% apart in the measured run)
        want = _flat_ref(ref_np["ef_err"], cfg)
        got = {k: t.numpy() for k, t in state["ef_err"].items()}
        total = [np.sqrt(sum(float(np.sum(t ** 2)) for t in tree.values()))
                 for tree in (got, want)]
        assert _rel(*total) < EF_TOTAL_RTOL, total
        for k, g in got.items():
            if g.size >= 512:
                assert _rel(np.linalg.norm(g), np.linalg.norm(want[k])) \
                    < EF_NORM_RTOL, k
    trees = [("params", state["params"], ref_np["params"]),
             ("m", state["opt"]["m"], ref_np["opt"]["m"])]
    for what, got_tree, want_tree in trees:
        want = _flat_ref(want_tree, cfg)
        far = total = 0
        for k, t in got_tree.items():
            g = t.detach().float().numpy()
            atol = PARAM_ATOL if what == "params" else (
                GRAD_MAX_FRAC * float(np.abs(want[k]).max()))
            far += int((np.abs(g - want[k]) > atol).sum())
            total += g.size
        assert far <= PARAM_FRAC * total, (what, far, total)


def test_train_loop_reduces_loss():
    """tests/test_system.py::test_training_reduces_loss through the
    port's ``train_loop``."""
    from repro_torch.launch.train import train_loop

    _, cfg = _cfgs("gemma")
    _, losses = train_loop(cfg, steps=60, batch=8, seq=32, lr=1e-2,
                           log_every=100, device="cpu")
    first = float(np.mean(losses[:5]))
    last = float(np.mean(losses[-5:]))
    assert last < first - 0.3, (first, last)


def test_train_loop_with_compression_and_micro():
    from repro_torch.launch.train import train_loop

    _, cfg = _cfgs("gemma")
    _, losses = train_loop(cfg, steps=25, batch=8, seq=32, n_micro=4,
                           lr=5e-3, compress=True, log_every=100,
                           device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_train_loop_restart_resumes(tmp_path):
    """A resumed run picks up at the checkpoint's step, and ends where an
    uninterrupted run ends, bit for bit."""
    from repro_torch.launch.train import train_loop

    _, cfg = _cfgs("gemma")
    d = str(tmp_path / "ck")
    # 10 and 19 steps give one warmup, max(steps // 10, 1) = 1
    kw = dict(batch=4, seq=16, log_every=100, device="cpu")
    train_loop(cfg, steps=10, ckpt_dir=d, ckpt_every=5, **kw)
    state, losses = train_loop(cfg, steps=19, ckpt_dir=d, ckpt_every=5, **kw)
    assert len(losses) == 9  # only the remaining steps ran
    clean, clean_losses = train_loop(cfg, steps=19, **kw)
    assert clean_losses[10:] == losses
    for k, p in clean["params"].items():
        assert torch.equal(p, state["params"][k]), k
