"""The selective scan's gradient in the port against the JAX package's.

On the card a Mamba layer trains through ``SelectiveScan``: the forward
kernel writes the state entering every ``SCAN_CHUNK`` steps, and
``csrc/selective_scan_bwd.cu`` recomputes each chunk from it and runs
the reverse recurrence, its sums across blocks taken as per-block
partials summed in ascending block order.  The kernels themselves run
only on the card (``chip_smoke.py`` holds them against the plain
versions there).  Here a plain-torch model of the kernels' arithmetic
(exp2 of dt * (A * log2 e), chunk states, the reverse recurrence inside
a chunk, the partials and their order) and ``selective_scan_bwd_ref``
are held against ``jax.vjp`` of the JAX package's
``selective_scan_reference`` with h0 and dhT, within the JAX scan tests'
rtol/atol 1e-5, and 1e-4 over 1024 sequential steps (as
``chip_smoke.py``'s ``SCAN_WIDE_TOL``); and a Mamba training step, with
the device check mocked, goes through the autograd function and never
through the plain scan.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import selective_scan_reference
from repro_torch._build import SRC_DIR
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.kernels.selective_scan import (
    BWD_CHANNELS,
    SCAN_CHUNK,
    selective_scan,
    selective_scan_bwd_kernel,
    selective_scan_bwd_ref,
    selective_scan_kernel,
)
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.models import Transformer, reduced
from repro_torch.optim import AdamW
from repro_torch.train import init_state, make_loss_fn, make_train_step

from _torch_threads import bounded_torch_threads  # noqa: F401

SCAN_TOL, SCAN_WIDE_TOL = 1e-5, 1e-4     # chip_smoke.py's scan gates
LOG2E = 1.4426950408889634
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dh0")


# ---------------------------------------------------------------------------
# a model of the two kernels' arithmetic
# ---------------------------------------------------------------------------

def _step(h, a2, dtt, xt, Bt):
    """The forward kernel's step: exp2(dt * A log2 e) h + (dt x) B."""
    return (torch.exp2(dtt[..., None] * a2[None]) * h
            + (dtt * xt)[..., None] * Bt[:, None, :])


def _fwd_model(x, dt, A, B, C, h0):
    """``csrc/selective_scan.cu`` with chunk states: (y, hT, hc)."""
    a2 = A * torch.tensor(LOG2E, dtype=torch.float32)
    h, ys, hc = h0, [], []
    for t in range(x.shape[1]):
        if t % SCAN_CHUNK == 0:
            hc.append(h)
        h = _step(h, a2, dt[:, t], x[:, t], B[:, t])
        ys.append(torch.einsum("bin,bn->bi", h, C[:, t]))
    return torch.stack(ys, 1), h, torch.stack(hc, 1)


def _block_sums(v):
    """(b, di, n) -> (nblk, b, n): the sum over each block's channels."""
    b, di, n = v.shape
    nblk = -(-di // BWD_CHANNELS)
    pad = torch.zeros((b, nblk * BWD_CHANNELS - di, n))
    return torch.cat([v, pad], 1).reshape(b, nblk, BWD_CHANNELS, n).sum(
        2).transpose(0, 1)


def _ordered_sum(parts):
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _bwd_model(x, dt, A, B, C, hc, dy, dhT):
    """``csrc/selective_scan_bwd.cu``: chunks from the last to the first,
    each recomputed from its saved state, the reverse recurrence over
    it; dB, dC as per-block partials and dA as per-row partials, summed
    in ascending order."""
    b, s, di = x.shape
    n = A.shape[1]
    a2 = A * torch.tensor(LOG2E, dtype=torch.float32)
    g = dhT.clone() if dhT is not None else torch.zeros((b, di, n))
    nblk = -(-di // BWD_CHANNELS)
    dx, ddt = torch.zeros((b, s, di)), torch.zeros((b, s, di))
    dBp, dCp = torch.zeros((nblk, b, s, n)), torch.zeros((nblk, b, s, n))
    dAp = torch.zeros((b, di, n))
    for k in reversed(range(hc.shape[1])):
        t0, t1 = k * SCAN_CHUNK, min(s, (k + 1) * SCAN_CHUNK)
        states = [hc[:, k]]
        for t in range(t0, t1):
            states.append(_step(states[-1], a2, dt[:, t], x[:, t], B[:, t]))
        for t in reversed(range(t0, t1)):
            hp, hcur = states[t - t0], states[t - t0 + 1]
            e = torch.exp2(dt[:, t, :, None] * a2[None])
            G = g + dy[:, t, :, None] * C[:, t, None, :]
            dBp[:, :, t] = _block_sums(G * (dt[:, t] * x[:, t])[..., None])
            dCp[:, :, t] = _block_sums(dy[:, t, :, None] * hcur)
            s1 = (G * B[:, t, None, :]).sum(-1)
            g = e * G
            w = g * hp
            dAp += w * dt[:, t, :, None]
            dx[:, t] = dt[:, t] * s1
            ddt[:, t] = x[:, t] * s1 + (w * A[None]).sum(-1)
    return (dx, ddt, _ordered_sum(list(dAp)), _ordered_sum(list(dBp)),
            _ordered_sum(list(dCp)), g)


# ---------------------------------------------------------------------------
# against jax.vjp of the reference
# ---------------------------------------------------------------------------

def _inputs(b, s, di, n, seed):
    """Drawn as ``_inputs`` in tests/test_kernels_scan.py, with dy, dhT."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, di)).astype(np.float32),
            rng.uniform(0.01, 0.2, (b, s, di)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, (di, n))).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            (rng.standard_normal((b, di, n)) * 0.1).astype(np.float32),
            rng.standard_normal((b, s, di)).astype(np.float32),
            (rng.standard_normal((b, di, n)) * 0.1).astype(np.float32))


def _jax_grads(x, dt, A, B, C, h0, dy, dhT):
    _, vjp = jax.vjp(selective_scan_reference,
                     *(jnp.asarray(a) for a in (x, dt, A, B, C, h0)))
    gx, gdt, gA, gB, gC, gh0 = vjp((jnp.asarray(dy), jnp.asarray(dhT)))
    return [np.asarray(a) for a in (gx, gdt, gA, gB, gC, gh0)]


def _held(got, want, tol, what):
    worst = 0.0
    for name, g, w in zip(GRADS, got, want):
        g = g.numpy()
        assert g.shape == w.shape, (what, name)
        assert np.isfinite(g).all(), (what, name)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=f"{what} {name}")
        worst = max(worst, float(np.abs(g - w).max()))
    return worst


SHAPES = {
    # tests/test_kernels_scan.py's shapes
    "jax-1x16x8x4": (1, 16, 8, 4),
    "jax-2x64x32x8": (2, 64, 32, 8),
    "jax-1x128x16x16": (1, 128, 16, 16),
    # ragged: s no multiple of the chunk or the tile, di no multiple of
    # the block (two blocks), n 5, 3 and 1
    "ragged-2x37x13x5": (2, 37, 13, 5),
    "ragged-1x150x70x3": (1, 150, 70, 3),
    "ragged-2x65x9x1": (2, 65, 9, 1),
    # 33 blocks, the last with 2 channels (chip_smoke.py's ragged width)
    "ragged-1x40x2050x5": (1, 40, 2050, 5),
}


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_model_and_plain_backward_match_jax(case):
    b, s, di, n = SHAPES[case]
    arrs = _inputs(b, s, di, n, seed=s * 31 + n)
    want = _jax_grads(*arrs)
    x, dt, A, B, C, h0, dy, dhT = (torch.from_numpy(a) for a in arrs)
    y, hT, hc = _fwd_model(x, dt, A, B, C, h0)
    assert hc.shape == (b, -(-s // SCAN_CHUNK), di, n)
    assert torch.equal(hc[:, 0], h0)
    _held(_bwd_model(x, dt, A, B, C, hc, dy, dhT), want, SCAN_TOL, "model")
    _held(selective_scan_bwd_ref(x, dt, A, B, C, dy, h0, dhT), want,
          SCAN_TOL, "plain")


@pytest.mark.parametrize("n", [16, 5])
def test_model_and_plain_backward_over_1024_steps(n):
    """1024 sequential steps, as falcon-mamba-7b's training micro-batch
    runs them, within the wide gate (several blocks of channels)."""
    b, s, di = 1, 1024, 80
    arrs = _inputs(b, s, di, n, seed=1024 + n)
    want = _jax_grads(*arrs)
    x, dt, A, B, C, h0, dy, dhT = (torch.from_numpy(a) for a in arrs)
    _, _, hc = _fwd_model(x, dt, A, B, C, h0)
    worst = _held(_bwd_model(x, dt, A, B, C, hc, dy, dhT), want,
                  SCAN_WIDE_TOL, "model")
    assert worst < SCAN_WIDE_TOL
    _held(selective_scan_bwd_ref(x, dt, A, B, C, dy, h0, dhT), want,
          SCAN_WIDE_TOL, "plain")


def test_plain_backward_is_autograd_of_the_plain_scan():
    """The CPU path trains by autograd through ``selective_scan_ref``;
    the written-out reverse recurrence is the same gradient, with no
    h0 (zeros) and no dhT (unused final state)."""
    b, s, di, n = 2, 40, 12, 6
    x, dt, A, B, C, _, dy, _ = (torch.from_numpy(a)
                                for a in _inputs(b, s, di, n, seed=7))
    leaves = [t.clone().requires_grad_(True)
              for t in (x, dt, A, B, C, torch.zeros((b, di, n)))]
    y, _ = selective_scan(*leaves)
    y.backward(dy)
    got = selective_scan_bwd_ref(x, dt, A, B, C, dy)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the kernels' constants and wrappers
# ---------------------------------------------------------------------------

def _cu_constant(name, const):
    src = (SRC_DIR / f"{name}.cu").read_text()
    return int(re.search(rf"constexpr int {const} = (\d+);", src).group(1))


def test_kernels_share_the_chunk_and_the_block():
    """Both kernels' chunk (the backward recomputes the forward's chunks)
    and the backward's channels a block (its dB/dC partials) are the
    wrapper's: 4 threads a channel of 4 states each, 8 channels a warp,
    64 channels a block; tiles and their half-tiles divide the chunk."""
    bwd = "selective_scan_bwd"
    assert _cu_constant("selective_scan", "kChunk") == SCAN_CHUNK
    assert _cu_constant(bwd, "kChunk") == SCAN_CHUNK
    tile, hist = _cu_constant(bwd, "kTile"), _cu_constant(bwd, "kHist")
    assert SCAN_CHUNK % tile == 0 and tile % hist == 0
    threads, tpc = _cu_constant(bwd, "kThreads"), _cu_constant(bwd, "kTPC")
    assert tpc * 4 == _cu_constant(bwd, "kMaxState")
    assert threads % 32 == 0 and 32 % tpc == 0
    assert threads // tpc == BWD_CHANNELS


def test_backward_wrapper_refuses_what_the_kernel_does_not_take():
    b, s, di, n = 1, 8, 4, 4
    x = torch.zeros((b, s, di))
    A = -torch.ones((di, n))
    Bc = torch.zeros((b, s, n))
    hc = torch.zeros((b, 1, di, n))
    with pytest.raises(ValueError, match="CUDA device"):
        selective_scan_bwd_kernel(x, x, A, Bc, Bc, hc, x)
    with pytest.raises(ValueError, match="chunk states"):
        selective_scan_bwd_kernel(x, x, A, Bc, Bc, hc[:, :0], x)
    with pytest.raises(ValueError, match="state size"):
        selective_scan_bwd_kernel(x, x, -torch.ones((di, 17)),
                                  torch.zeros((b, s, 17)),
                                  torch.zeros((b, s, 17)),
                                  torch.zeros((b, 1, di, 17)), x)
    with pytest.raises(ValueError, match="CUDA device"):
        selective_scan_kernel(x, x, A, Bc, Bc, with_states=True)


# ---------------------------------------------------------------------------
# a Mamba training step on the card's route (the device check mocked)
# ---------------------------------------------------------------------------

def _mock_kernels(monkeypatch):
    """The card's route with the kernels replaced by their models: counts
    each call; the plain scan must not run."""
    calls = {"fwd": 0, "fwd_states": 0, "bwd": 0}

    def fwd(x, dt, A, B, C, h0=None, *, with_states=False):
        calls["fwd_states" if with_states else "fwd"] += 1
        h0 = torch.zeros((x.shape[0], x.shape[2], A.shape[1])) \
            if h0 is None else h0
        y, hT, hc = _fwd_model(x, dt, A, B, C, h0)
        return (y, hT, hc) if with_states else (y, hT)

    def bwd(x, dt, A, B, C, hc, dy, dhT=None):
        calls["bwd"] += 1
        return _bwd_model(x, dt, A, B, C, hc, dy, dhT)

    def plain(*a, **k):
        raise AssertionError("the plain scan ran on the card's route")

    monkeypatch.setattr(scan_ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(scan_ops, "selective_scan_kernel", fwd)
    monkeypatch.setattr(scan_ops, "selective_scan_bwd_kernel", bwd)
    monkeypatch.setattr(scan_ops, "selective_scan_ref", plain)
    return calls


def _falcon():
    cfg = reduced(get_config("falcon-mamba-7b"))
    model = Transformer(cfg, device="cpu", trainable=True)
    model.init_weights(0)
    b = TokenPipeline(cfg.vocab_size, 4, 24).batch_at(0)
    return cfg, model, {k: torch.from_numpy(v) for k, v in b.items()}


def test_training_goes_through_the_autograd_function(monkeypatch):
    """Under grad the kernel route is ``SelectiveScan``: per Mamba layer
    and pass, the forward with chunk states twice (remat runs it again
    in the backward) and the backward once; its gradients equal the
    plain CPU path's (autograd through ``selective_scan_ref``) within
    the scan's tolerance scaled by the loss's sums."""
    cfg, model, batch = _falcon()
    loss_fn = make_loss_fn(model)
    loss, _ = loss_fn(batch)
    loss.backward()
    plain = {k: p.grad.clone() for k, p in model.named_parameters()}
    plain_loss = float(loss.detach())
    model.zero_grad(set_to_none=True)

    calls = _mock_kernels(monkeypatch)
    loss, _ = loss_fn(batch)
    loss.backward()
    layers = cfg.n_layers
    assert calls == {"fwd": 0, "fwd_states": 2 * layers, "bwd": layers}
    assert abs(float(loss.detach()) - plain_loss) <= 1e-6 * abs(plain_loss)
    for k, p in model.named_parameters():
        assert p.grad.dtype == p.dtype, k
        scale = float(plain[k].abs().max())
        assert float((p.grad - plain[k]).abs().max()) <= 1e-4 * scale, k

    # serving (no grad) keeps the forward without chunk states
    with torch.no_grad():
        model.forward_train(batch["tokens"][:, :4])
    assert calls["fwd"] == layers


def test_train_step_launches_per_micro_batch(monkeypatch):
    """``make_train_step`` with 2 micro-batches: each Mamba layer's pass
    runs twice, so 4 forwards with chunk states and 2 backwards a layer;
    the step's loss and gradient norm are finite."""
    cfg, model, batch = _falcon()
    opt = AdamW(lr=1e-3, warmup_steps=1)
    step = make_train_step(model, opt, n_micro=2)
    state = init_state(dict(model.named_parameters()), opt)
    calls = _mock_kernels(monkeypatch)
    _, m = step(state, batch)
    assert calls == {"fwd": 0, "fwd_states": 4 * cfg.n_layers,
                     "bwd": 2 * cfg.n_layers}
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
