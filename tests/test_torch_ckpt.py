"""The port's checkpoints and fault-tolerant loop (the checkpoint cases
of tests/test_checkpoint_data.py, mirrored), and the layout they share
with the JAX package's: each package reads the other's float32 and int32
checkpoints, and a train state's keys are ``params/<name>``,
``opt/m/<name>``, ``opt/v/<name>``, ``opt/step`` and ``ef_err/<name>``.
bf16 leaves (numpy has none) are stored as their uint16 bits and come
back bit for bit, on the like-tree's device and in its dtype."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro_torch.checkpoint import FailureInjector, ckpt, run_resilient
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import Transformer, reduced
from repro_torch.optim import AdamW
from repro_torch.train import init_state

from _torch_threads import bounded_torch_threads  # noqa: F401


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
        "nested": {"b": torch.from_numpy(rng.integers(0, 10, (3,))
                                         .astype(np.int32)),
                   "c": torch.tensor(float(rng.standard_normal()),
                                     dtype=torch.float32),
                   "h": torch.from_numpy(rng.standard_normal((5, 3))
                                         .astype(np.float32))
                   .to(torch.bfloat16)},
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def test_save_restore_roundtrip_with_bf16_leaves(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t)
    assert ckpt.latest_step(str(tmp_path)) == 7
    manifest = json.loads((tmp_path / "step_000000007" / "MANIFEST.json")
                          .read_text())
    assert manifest["leaves"]["nested/h"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["nested/b"]["dtype"] == "int32"
    like = _zeros_like(t)
    back = ckpt.restore(str(tmp_path), 7, like)
    assert back is like
    for key in ("a",):
        assert torch.equal(back[key], t[key])
    for key in ("b", "c", "h"):
        assert back["nested"][key].dtype == t["nested"][key].dtype
        assert torch.equal(back["nested"][key], t["nested"][key]), key


def test_atomicity_ignores_partial(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t)
    # simulate a crash mid-write: orphan .tmp directory
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_latest_of_many(tmp_path):
    t = _tree()
    for s in (1, 10, 3):
        ckpt.save(str(tmp_path), s, t)
    assert ckpt.list_steps(str(tmp_path)) == [1, 3, 10]
    assert ckpt.latest_step(str(tmp_path)) == 10


def test_restore_refuses_another_shape(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(4)})


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_layout_shared_with_reference(tmp_path, writer):
    rng = np.random.default_rng(3)
    arrays = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "opt": {"step": np.asarray(5, np.int32)}}
    if writer == "port":
        ckpt.save(str(tmp_path), 2, {"w": torch.from_numpy(arrays["w"]),
                                     "opt": {"step": torch.tensor(
                                         5, dtype=torch.int32)}})
        back = ref_ckpt.restore(str(tmp_path), 2,
                                {"w": jnp.zeros((3, 4)),
                                 "opt": {"step": jnp.zeros((), jnp.int32)}})
        assert np.array_equal(np.asarray(back["w"]), arrays["w"])
        assert int(back["opt"]["step"]) == 5
    else:
        ref_ckpt.save(str(tmp_path), 2, {"w": jnp.asarray(arrays["w"]),
                                         "opt": {"step": jnp.asarray(
                                             5, jnp.int32)}})
        back = ckpt.restore(str(tmp_path), 2,
                            {"w": torch.zeros((3, 4)),
                             "opt": {"step": torch.zeros((), dtype=torch.int32)}})
        assert np.array_equal(back["w"].numpy(), arrays["w"])
        assert int(back["opt"]["step"]) == 5


def test_train_state_keys_and_restore_into_model(tmp_path):
    """A train state saves under the documented keys and restores into
    a fresh model's parameters and optimizer state in place."""
    cfg = reduced(get_config("gemma-2b"), n_layers=2, d_model=32, n_heads=2,
                  n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=128)
    opt = AdamW()
    model = Transformer(cfg, device="cpu", trainable=True).init_weights(0)
    state = init_state(dict(model.named_parameters()), opt, compress=True)
    with torch.no_grad():
        for t in state["opt"]["m"].values():
            t.normal_()
        state["opt"]["step"].fill_(4)
    ckpt.save(str(tmp_path), 4, state)
    keys = set(json.loads((tmp_path / "step_000000004" / "MANIFEST.json")
                          .read_text())["leaves"])
    names = [n for n, _ in model.named_parameters()]
    want = ({f"params/{n}" for n in names} | {f"opt/m/{n}" for n in names}
            | {f"opt/v/{n}" for n in names} | {f"ef_err/{n}" for n in names}
            | {"opt/step"})
    assert keys == want
    fresh = Transformer(cfg, device="cpu", trainable=True).init_weights(1)
    like = init_state(dict(fresh.named_parameters()), opt, compress=True)
    ckpt.restore(str(tmp_path), 4, like)
    for n, p in fresh.named_parameters():
        assert p.requires_grad and torch.equal(p, state["params"][n]), n
        assert torch.equal(like["opt"]["m"][n], state["opt"]["m"][n]), n
    assert like["opt"]["step"].dtype == torch.int32
    assert int(like["opt"]["step"]) == 4


def test_run_resilient_recovers_and_matches(tmp_path):
    """Injected failures + restart produce the same final state as an
    uninterrupted run (determinism across restarts)."""

    def init():
        return {"x": torch.zeros(()), "step_sum": torch.zeros(())}

    def step_fn(state, step):
        pipe = TokenPipeline(97, 4, 8, seed=0)
        b = pipe.batch_at(step)
        inc = float(b["tokens"].sum() % 1000)
        return (
            {"x": state["x"] + 1.0, "step_sum": state["step_sum"] + inc},
            {"inc": inc},
        )

    clean, _ = run_resilient(init, step_fn, n_steps=20,
                             ckpt_dir=str(tmp_path / "clean"), ckpt_every=5)
    inj = FailureInjector(fail_at=[7, 13])
    faulty, report = run_resilient(init, step_fn, n_steps=20,
                                   ckpt_dir=str(tmp_path / "faulty"),
                                   ckpt_every=5, injector=inj)
    assert report.restarts == 2
    assert float(faulty["x"]) == float(clean["x"]) == 20.0
    assert float(faulty["step_sum"]) == pytest.approx(float(clean["step_sum"]))


def test_restart_budget_enforced(tmp_path):
    def init():
        return {"x": torch.zeros(())}

    def bad_step(state, step):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError, match="restart budget"):
        run_resilient(init, bad_step, n_steps=5,
                      ckpt_dir=str(tmp_path), max_restarts=2)
