"""The port's optimizer, gradient compression and data pipeline against
the JAX package's (tests/test_optim.py and the pipeline cases of
tests/test_checkpoint_data.py, mirrored).

The same float32 inputs, drawn with numpy, go through both packages:
``AdamW.update``, ``clip_by_global_norm`` and ``ef_quantize`` agree
within one float32 ulp (the two frameworks' reductions and ``pow``
may round the last bit differently), bf16 moments within one bf16 ulp;
``TokenPipeline`` batches are byte-equal.  Where clipping is active the
clip scale is the reciprocal of a norm that the two frameworks sum in
another order, one ulp apart, and the moments after it can cancel to
far below the gradient's scale: there the updated tensors are held to
``CLIPPED_ULPS`` ulps of each tensor's largest element (measured: 6.5,
on a first moment, over 20 seeds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.optim import AdamW as RefAdamW
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import ef_quantize as ref_ef_quantize
from repro_torch.data import TokenPipeline
from repro_torch.optim import AdamW, clip_by_global_norm, ef_quantize

from _torch_threads import bounded_torch_threads  # noqa: F401

SHAPES = {"w": (16, 8), "b": (8,), "s": ()}
CLIPPED_ULPS = 16


def _tree(rng, scale=1.0):
    return {k: np.asarray(rng.standard_normal(s) * scale, np.float32)
            for k, s in SHAPES.items()}


def _ulps(a, b) -> int:
    """The largest distance in units of the last place between two
    float32 arrays, or two arrays of bfloat16 bits (uint16)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.uint16:
        sign, ia, ib = 0x8000, a.astype(np.int64), b.astype(np.int64)
    else:
        sign = 0x80000000
        ia = np.asarray(a, np.float32).view(np.uint32).astype(np.int64)
        ib = np.asarray(b, np.float32).view(np.uint32).astype(np.int64)
    # sign-magnitude bits to a line on which neighbours differ by 1
    ia = np.where(ia >= sign, sign - ia, ia)
    ib = np.where(ib >= sign, sign - ib, ib)
    return int(np.abs(ia - ib).max())


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a


# ---------------------------------------------------------------------------
# against the JAX package, same inputs
# ---------------------------------------------------------------------------

def _close_to_max(got, want, ulps):
    """|got - want| within ``ulps`` float32 ulps of want's largest
    element."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    return float(np.abs(got - want).max()) <= ulps * np.spacing(
        np.float32(top))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_update_matches_reference(moment_dtype, clipped):
    """Five updates, clipping on (norm ~ 12 > 1) and off, warmup across
    the steps and weight decay; before each, the port's parameters and
    state are set to the reference's, so that every update starts from
    the same inputs (one ulp of difference would otherwise compound)."""
    max_grad_norm = 1.0 if clipped else 100.0
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=3,
              max_grad_norm=max_grad_norm, moment_dtype=moment_dtype)
    ref_opt, opt = RefAdamW(**kw), AdamW(**kw)
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_s = ref_opt.init(ref_p)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    s = opt.init(p)
    assert s["step"].dtype == torch.int32
    assert all(t.dtype == getattr(torch, moment_dtype)
               for t in s["m"].values())
    for _ in range(5):
        with torch.no_grad():
            for k in SHAPES:
                p[k].copy_(torch.from_numpy(np.array(ref_p[k])))
                for mv in ("m", "v"):
                    s[mv][k].copy_(torch.from_numpy(
                        np.array(ref_s[mv][k], np.float32)))
            s["step"].fill_(int(ref_s["step"]))
        g = _tree(rng, scale=3.0)
        ref_p, ref_s, rm = ref_opt.update(
            {k: jnp.asarray(v) for k, v in g.items()}, ref_s, ref_p)
        p, s, m = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             s, p)
        assert _ulps(float(m["grad_norm"]), float(rm["grad_norm"])) <= 1
        assert _ulps(float(m["lr"]), float(rm["lr"])) <= 1
        for k in SHAPES:
            if not clipped:
                assert _ulps(p[k].numpy(), ref_p[k]) <= 1, k
                assert _ulps(_bits(s["m"][k]), _jbits(ref_s["m"][k])) <= 1, k
                assert _ulps(_bits(s["v"][k]), _jbits(ref_s["v"][k])) <= 1, k
                continue
            assert _close_to_max(p[k].numpy(), ref_p[k], CLIPPED_ULPS), k
            for mv in ("m", "v"):
                assert _close_to_max(s[mv][k].float().numpy(),
                                     np.asarray(ref_s[mv][k], np.float32),
                                     CLIPPED_ULPS), (mv, k)
    assert int(s["step"]) == int(ref_s["step"]) == 5


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    g = _tree(rng, scale=5.0)
    want, want_gn = ref_clip({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    got, gn = clip_by_global_norm({k: torch.from_numpy(v.copy())
                                   for k, v in g.items()}, 1.0)
    assert _ulps(float(gn), float(want_gn)) <= 1
    for k in SHAPES:
        assert _ulps(got[k].numpy(), want[k]) <= 1, k


def test_ef_quantize_matches_reference():
    rng = np.random.default_rng(2)
    err = np.zeros(64, np.float32)
    ref_err = jnp.asarray(err)
    t_err = torch.from_numpy(err.copy())
    for i in range(20):
        g = (rng.standard_normal(64) * rng.uniform(0.1, 5.0)).astype(np.float32)
        want, ref_err = ref_ef_quantize(jnp.asarray(g), ref_err)
        got, t_err = ef_quantize(torch.from_numpy(g), t_err)
        assert _ulps(got.numpy(), want) <= 1, i
        assert _ulps(t_err.numpy(), ref_err) <= 1, i
    # the dequantized gradient keeps the input's dtype
    deq, e = ef_quantize(torch.ones(4, dtype=torch.bfloat16), torch.zeros(4))
    assert deq.dtype == torch.bfloat16 and e.dtype == torch.float32


@pytest.mark.parametrize("seed,step,rows", [(0, 0, None), (42, 3, None),
                                            (7, 1000, range(2, 5))])
def test_pipeline_batches_byte_equal_to_reference(seed, step, rows):
    for v, b, s in ((1000, 8, 16), (128, 4, 32), (256000, 2, 1024)):
        want = RefPipeline(v, b, s, seed=seed).batch_at(step, rows=rows)
        got = TokenPipeline(v, b, s, seed=seed).batch_at(step, rows=rows)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), (k, v)


# ---------------------------------------------------------------------------
# tests/test_optim.py, mirrored
# ---------------------------------------------------------------------------

def test_adamw_minimizes_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, warmup_steps=1)
    target = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 3))
                              .astype(np.float32))
    params = {"w": torch.zeros((4, 3))}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = opt.update(grads, state, params)
    assert float((params["w"] - target).abs().max()) < 0.05


def test_adamw_weight_decay_shrinks():
    opt = AdamW(lr=0.1, weight_decay=0.5, warmup_steps=1)
    params = {"w": torch.ones(3) * 10.0}
    state = opt.init(params)
    for _ in range(50):
        params, state, _ = opt.update({"w": torch.zeros(3)}, state, params)
    assert float(params["w"].abs().max()) < 1.0


def test_adamw_bf16_moments_supported():
    opt = AdamW(lr=0.01, moment_dtype="bfloat16")
    params = {"w": torch.ones(8)}
    state = opt.init(params)
    assert state["m"]["w"].dtype == torch.bfloat16
    params2, state2, m = opt.update({"w": torch.ones(8)}, state, params)
    assert state2["m"]["w"].dtype == torch.bfloat16
    assert np.isfinite(float(m["grad_norm"]))


def test_clip_by_global_norm():
    g = {"a": torch.ones(10) * 3.0, "b": torch.ones(10) * 4.0}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(np.sqrt(90 + 160), rel=1e-5)
    total = torch.sqrt(sum(torch.sum(x ** 2) for x in clipped.values()))
    assert float(total) == pytest.approx(1.0, rel=1e-4)


def test_ef_quantize_error_feedback_unbiased_over_time():
    """Residual carrying: the cumulative applied gradient converges to the
    cumulative true gradient (compression error doesn't accumulate)."""
    rng = np.random.default_rng(0)
    err = torch.zeros(64)
    applied = np.zeros(64)
    true = np.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(64) * rng.uniform(0.1, 5.0)
                             ).float()
        deq, err = ef_quantize(g, err)
        applied += deq.numpy()
        true += g.numpy()
    assert np.abs(applied + err.numpy() - true).max() < 1e-3
    assert np.abs(applied - true).max() < np.abs(true).max() * 0.2 + 1.0


# ---------------------------------------------------------------------------
# the pipeline cases of tests/test_checkpoint_data.py, mirrored
# ---------------------------------------------------------------------------

def test_pipeline_deterministic_and_row_addressable():
    p = TokenPipeline(1000, batch=8, seq_len=16, seed=42)
    b1 = p.batch_at(3)
    b2 = p.batch_at(3)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    sub = p.batch_at(3, rows=range(2, 5))
    assert np.array_equal(sub["tokens"], b1["tokens"][2:5])
    row = p.row(3, 0)
    assert np.array_equal(b1["tokens"][0], row[:-1])
    assert np.array_equal(b1["labels"][0], row[1:])


def test_pipeline_steps_differ():
    p = TokenPipeline(1000, batch=2, seq_len=32, seed=0)
    assert not np.array_equal(p.batch_at(0)["tokens"], p.batch_at(1)["tokens"])


def test_pipeline_learnable_structure():
    p = TokenPipeline(1000, batch=1, seq_len=64, seed=1, noise=0.0)
    t = p.row(0, 0)
    deltas = np.diff(t) % 1000
    assert (deltas == deltas[0]).mean() == 1.0


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_by_slices_is_the_same_bits(monkeypatch, moment_dtype):
    """A tensor larger than ``UPDATE_SLICE`` is updated slice by slice:
    parameters and moments after three steps equal the whole-tensor
    update's bit for bit."""
    from repro_torch.optim import adamw

    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((300, 37)), "b": rng.standard_normal(5)}
    grads = [{k: rng.standard_normal(v.shape) for k, v in params.items()}
             for _ in range(3)]
    out = []
    for size in (adamw.UPDATE_SLICE, 1000):
        monkeypatch.setattr(adamw, "UPDATE_SLICE", size)
        p = {k: torch.tensor(v, dtype=torch.float32)
             for k, v in params.items()}
        opt = AdamW(lr=1e-2, warmup_steps=1, moment_dtype=moment_dtype)
        state = opt.init(p)
        for g in grads:
            _, state, _ = opt.update(
                {k: torch.tensor(v, dtype=torch.float32)
                 for k, v in g.items()}, state, p)
        out.append((p, state))
    (p1, s1), (p2, s2) = out
    for k in params:
        assert torch.equal(p1[k], p2[k]), k
        assert torch.equal(s1["m"][k], s2["m"][k]), k
        assert torch.equal(s1["v"][k], s2["v"][k]), k
