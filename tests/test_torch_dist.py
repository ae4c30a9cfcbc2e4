"""The port's distributed layer (``dist/``, ``launch/mesh.py``,
``launch/shapes.py``, ``launch/cluster.py``, ``optim.compress.
compressed_psum``) against the JAX package's.

The rule logic reads a mesh only through its axis sizes, so it is held
to the JAX package's on stand-in meshes of the production shapes,
(16, 16) and (2, 16, 16), and on (4,) and (2, 2), without 512 devices:
``spec_for`` over every arch's parameters at full size, ``rule_overrides``
nesting, ``runnable``, ``cell_rules`` and ``n_microbatches`` for every
arch and cell, ``host_rows``.  ``compressed_psum`` on a 2-process gloo
group is bit-equal to the JAX package's under ``shard_map`` on 2 forced
host devices (in a subprocess).  The cluster CLI's data-parallel step on
2 gloo processes against the one-process ``train_loop`` on the whole
batch: the CPU's bf16 weight gradients are rounded once a rank's rows
and once a batch, so the first moments (0.1 x the gradient) are held to
``tests/test_torch_train.py``'s bf16 tolerances (``GRAD_NORM_RTOL``,
``GRAD_MAX_FRAC``; measured 0.25% and 0.47%), the losses within
``LOSS_RTOL``.  A checkpoint the 2 processes wrote is restored by one.
Each test spawns at most 2 processes."""

import json
import os
import re
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.dist import sharding as ref_sharding
from repro.launch import cluster as ref_cluster
from repro.launch import shapes as ref_shapes
from repro.models import param_specs as ref_param_specs
from repro_torch.configs import ARCHS, get_config
from repro_torch.dist import sharding
from repro_torch.launch import cluster, shapes
from repro_torch.launch.mesh import production_shape
from repro_torch.models import reduced
from repro_torch.models.transformer import param_specs

from _torch_threads import bounded_torch_threads  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_RTOL = 2e-3
GRAD_NORM_RTOL = 1e-2
GRAD_MAX_FRAC = 2e-2


class StandIn:
    """A mesh as the rules read it: a dict of axis sizes."""

    def __init__(self, **axes):
        self.shape = dict(axes)


MESHES = {
    "16x16": StandIn(data=16, model=16),
    "2x16x16": StandIn(pod=2, data=16, model=16),
    "4": StandIn(data=4),
    "2x2": StandIn(data=2, model=2),
}


def _ref_specs(rcfg):
    """The JAX package's ParamSpecs under the port's names, each with
    whether it is stacked (a leading scan axis the port unstacks)."""
    tree = ref_param_specs(rcfg)
    period = len(rcfg.block_pattern)
    out = {}
    for i in range(period):
        for mod, params in tree["blocks"][f"layer{i}"].items():
            for name, ps in params.items():
                for sb in range(rcfg.n_superblocks):
                    out[f"layers.{sb * period + i}.{mod}.{name}"] = (ps, True)
    if "encoder" in tree:
        for mod, params in tree["encoder"]["blocks"].items():
            for name, ps in params.items():
                for j in range(rcfg.n_enc_layers):
                    out[f"encoder.layers.{j}.{mod}.{name}"] = (ps, True)
        out["encoder.final_norm"] = (tree["encoder"]["final_norm"], False)
    for name in ("embed", "final_norm", "lm_head"):
        if name in tree:
            out[name] = (tree[name], False)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_matches_reference_on_every_parameter(arch):
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    ref = _ref_specs(rcfg)
    ours = param_specs(cfg)
    assert sorted(ours) == sorted(ref)
    for mesh_name, mesh in MESHES.items():
        for cell in (None, "train_4k", "prefill_32k", "decode_32k"):
            rules = (None if cell is None
                     else shapes.cell_rules(cfg, cell, mesh))
            if cell is not None:
                assert rules == ref_shapes.cell_rules(rcfg, cell, mesh)
            for name, spec in ours.items():
                ps, stacked = ref[name]
                logical = ps.logical[1:] if stacked else ps.logical
                shape = ps.shape[1:] if stacked else ps.shape
                assert spec.logical == logical and spec.shape == shape, name
                want = tuple(ref_sharding.spec_for(ps.logical, ps.shape,
                                                   mesh, rules))
                want = want[1:] if stacked else want
                want += (None,) * (len(shape) - len(want))
                got = sharding.spec_for(spec.logical, spec.shape, mesh, rules)
                assert got == want, (arch, mesh_name, cell, name, got, want)


def test_spec_for_fallback_uniqueness_and_placements():
    mesh = MESHES["2x16x16"]
    for logical, shape in ((("batch", None), (64, 7)),
                           (("batch", "embed"), (6, 32)),
                           (("embed", "embed", "heads"), (32, 32, 48)),
                           (("vocab", "embed"), (50, 16)),
                           (("experts", "embed", "expert_mlp"), (40, 16, 8))):
        got = sharding.spec_for(logical, shape, mesh)
        assert got == tuple(ref_sharding.spec_for(logical, shape, mesh))
    spec = sharding.spec_for(("batch", "embed", "heads"), (64, 32, 48), mesh)
    assert spec == (("pod", "data"), None, "model")
    from torch.distributed.tensor import Replicate, Shard

    assert sharding.placements_for(spec, mesh) == [Shard(0), Shard(0),
                                                   Shard(2)]
    assert sharding.placements_for((None, "data"), MESHES["2x2"]) == [
        Shard(1), Replicate()]


def test_rule_overrides_nest_as_the_reference():
    mesh = MESHES["16x16"]
    cases = [(("embed", "heads"), (32, 64)), (("batch", "seq"), (32, 4096)),
             (("vocab", "embed"), (512, 64))]

    def specs(mod):
        return ([tuple(mod.spec_for(lg, sh, mesh)) for lg, sh in cases],
                dict(mod.active_rules()))

    layers = [{"embed": None}, {"heads": None, "seq": "model"},
              {"embed": "model", "vocab": None}]
    seen = [specs(sharding)]
    assert seen[0] == specs(ref_sharding)
    with sharding.rule_overrides(layers[0]), \
            ref_sharding.rule_overrides(layers[0]):
        seen.append(specs(sharding))
        assert seen[-1] == specs(ref_sharding)
        with sharding.rule_overrides(layers[1]), \
                ref_sharding.rule_overrides(layers[1]):
            with sharding.rule_overrides(layers[2]), \
                    ref_sharding.rule_overrides(layers[2]):
                assert specs(sharding) == specs(ref_sharding)
                assert sharding.active_rules() == {**layers[0], **layers[1],
                                                   **layers[2]}
            assert specs(sharding) == specs(ref_sharding)
        assert specs(sharding) == seen[-1]
    assert specs(sharding) == seen[0] and sharding.active_rules() == {}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cells_match_reference(mesh_name):
    """``runnable``, ``cell_rules`` and ``n_microbatches`` for the 10
    archs x 4 cells; the cells' table itself."""
    mesh = MESHES[mesh_name]
    assert {k: (c.name, c.seq_len, c.global_batch, c.kind)
            for k, c in shapes.SHAPES.items()} == {
        k: (c.name, c.seq_len, c.global_batch, c.kind)
        for k, c in ref_shapes.SHAPES.items()}
    assert shapes.ENC_CONTEXT == ref_shapes.ENC_CONTEXT
    for arch in ARCHS:
        rcfg, cfg = ref_get_config(arch), get_config(arch)
        assert shapes.n_microbatches(cfg, mesh) == \
            shapes.n_microbatches(cfg, mesh, 256) == \
            ref_shapes.n_microbatches(rcfg, mesh), arch
        for cell in shapes.SHAPES:
            assert shapes.runnable(cfg, cell) == \
                ref_shapes.runnable(rcfg, cell), (arch, cell)
            assert shapes.cell_rules(cfg, cell, mesh) == \
                ref_shapes.cell_rules(rcfg, cell, mesh), (arch, cell)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-72b",
                                  "jamba-1.5-large-398b"])
def test_input_specs_allocate_nothing(arch):
    """Every cell's inputs at full size: meta tensors of the JAX
    package's shapes (its ``input_specs`` on a one-device mesh), specs
    resolved on the production mesh."""
    import jax

    from repro.dist.compat import make_mesh as ref_make_mesh

    cfg, rcfg = get_config(arch), ref_get_config(arch)
    one = ref_make_mesh((1, 1), ("data", "model"))
    mesh = MESHES["2x16x16"]
    for cell in shapes.SHAPES:
        got = shapes.input_specs(cfg, cell, mesh)
        want = ref_shapes.input_specs(rcfg, cell, one)
        assert got["kind"] == want["kind"]
        assert got["rules"] == ref_shapes.cell_rules(rcfg, cell, mesh)
        leaves = [a for a in jax.tree.leaves(
            {k: got[k] for k in ("params", "batch", "caches", "tokens",
                                 "enc_out") if k in got},
            is_leaf=lambda x: isinstance(x, shapes.Abstract))]
        assert all(a.tensor.device.type == "meta" for a in leaves)
        for key in ("batch",):
            if key in want:
                assert {k: (tuple(v.shape), str(v.dtype))
                        for k, v in want[key].items()} == {
                    k: (tuple(a.tensor.shape),
                        str(a.tensor.dtype).replace("torch.", ""))
                    for k, a in got[key].items()}
        n_params = sum(int(np.prod(a.tensor.shape))
                       for a in got["params"].values())
        want_params = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
            want["param_specs"], is_leaf=lambda x: hasattr(x, "logical")))
        assert n_params == want_params
        if "caches" in got:
            n_cache = sum(int(np.prod(a.tensor.shape)) for c in got["caches"]
                          for a in jax.tree.leaves(
                              c, is_leaf=lambda x: isinstance(
                                  x, shapes.Abstract)))
            assert n_cache == sum(int(np.prod(x.shape))
                                  for x in jax.tree.leaves(want["caches"]))
        if "batch" in got:
            for a in got["batch"].values():
                assert a.spec[0] is not None   # batch spreads over the mesh


def test_production_shape_and_host_rows():
    assert production_shape(256) == ((16, 16), ("data", "model"))
    assert production_shape(512, multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    assert production_shape(1) == ((1, 1), ("data", "model"))
    for b, n in ((256, 128), (8, 2), (8, 1), (12, 4), (7, 3)):
        for i in range(n):
            assert cluster.host_rows(b, i, n) == ref_cluster.host_rows(b, i, n)


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv_or_code, world: int, *, extra_env=None):
    """Run ``world`` ranks at once (a ``-c`` program or ``-m`` argv), each
    with the torch.distributed environment; returns their outputs."""
    port = _port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=SRC, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   RANK=str(rank), OMP_NUM_THREADS="1", **(extra_env or {}))
        args = ([sys.executable, "-c", textwrap.dedent(argv_or_code)]
                if isinstance(argv_or_code, str)
                else [sys.executable] + list(argv_or_code))
        procs.append(subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_compressed_psum_bit_equal_to_reference(tmp_path):
    rng = np.random.default_rng(0)
    x = np.stack([rng.standard_normal((5, 33)) * 3.0,
                  rng.standard_normal((5, 33)) * 0.01]).astype(np.float32)
    x[1, 0, :4] = [0.5, -0.5, 1.5, 2.5]   # ties round to even in both
    np.save(tmp_path / "x.npy", x)
    _spawn(f"""
        import os, numpy as np, torch, torch.distributed as dist
        from repro_torch.optim.compress import compressed_psum
        rank = int(os.environ["RANK"])
        dist.init_process_group(
            "gloo", init_method="tcp://127.0.0.1:" + os.environ["MASTER_PORT"],
            world_size=2, rank=rank)
        x = torch.from_numpy(np.load("{tmp_path}/x.npy")[rank])
        np.save("{tmp_path}/port%d.npy" % rank, compressed_psum(x).numpy())
        dist.destroy_process_group()
    """, 2)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    code = textwrap.dedent(f"""
        import numpy as np, jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        try:
            from jax import shard_map
        except ImportError:
            from jax.experimental.shard_map import shard_map
        from repro.dist.compat import make_mesh
        from repro.optim.compress import compressed_psum
        mesh = make_mesh((2,), ("pod",))
        x = jnp.asarray(np.load("{tmp_path}/x.npy").reshape(10, 33))
        f = shard_map(lambda t: compressed_psum(t, "pod"), mesh=mesh,
                      in_specs=P("pod"), out_specs=P("pod"))
        np.save("{tmp_path}/ref.npy", np.asarray(f(x)).reshape(2, 5, 33))
    """)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.load(tmp_path / "ref.npy")
    for rank in range(2):
        got = np.load(tmp_path / f"port{rank}.npy")
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want[rank].view(np.uint32))
    assert np.array_equal(want[0], want[1])


CLI = ["-m", "repro_torch.launch.cluster", "--arch", "gemma-2b", "--reduced",
       "--batch", "8", "--seq", "32", "--device", "cpu"]


def _m(ckpt_dir, step):
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        leaves = json.load(f)["leaves"]
    return {k[len("opt/m/"):]: np.load(os.path.join(path, v["file"]))
            for k, v in leaves.items() if k.startswith("opt/m/")}


def test_two_process_step_matches_one_process_and_restores_at_one(tmp_path):
    from repro_torch.launch.train import train_loop

    d = str(tmp_path / "ck")
    outs = _spawn(CLI + ["--steps", "1", "--ckpt-dir", d], 2)
    assert "process 0/2, backend gloo" in outs[0]
    loss2 = float(re.search(r"step 0 loss=([\d.]+)", outs[0]).group(1))
    cfg = reduced(get_config("gemma-2b"))
    state, losses = train_loop(cfg, steps=2, batch=8, seq=32, device="cpu",
                               log_every=100)
    assert abs(loss2 - losses[0]) <= LOSS_RTOL * losses[0]
    # the first moments after one step are 0.1 x the averaged gradient
    got = _m(d, 1)
    one = train_loop(cfg, steps=1, batch=8, seq=32, device="cpu",
                     log_every=100)[0]
    assert sorted(got) == sorted(one["opt"]["m"])
    for k, want in one["opt"]["m"].items():
        want = want.numpy()
        scale = float(np.abs(want).max())
        assert float(np.abs(got[k] - want).max()) <= GRAD_MAX_FRAC * scale, k
        assert abs(np.linalg.norm(got[k]) - np.linalg.norm(want)) \
            <= GRAD_NORM_RTOL * np.linalg.norm(want), k
    # world 1 restores the world-2 checkpoint and takes the second step
    out = _spawn(CLI + ["--steps", "2", "--ckpt-dir", d], 1)[0]
    assert "restored step 1" in out
    loss = float(re.search(r"step 1 loss=([\d.]+)", out).group(1))
    assert abs(loss - losses[1]) <= LOSS_RTOL * losses[1]
    assert os.path.isdir(os.path.join(d, f"step_{2:09d}"))


def test_cluster_cli_as_one_cpu_process(capsys, monkeypatch):
    """The CLI in-process with no cluster environment: a group of one
    (gloo) on a one-axis mesh, compressed gradients with error feedback,
    so its steps are ``train_loop``'s with compression; the production
    mesh and ``constrain`` on it."""
    from repro_torch.launch.train import train_loop

    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "MASTER_ADDR",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    losses = cluster.main(CLI[2:] + ["--steps", "3", "--compress"])
    out = capsys.readouterr().out
    assert "process 0/1, backend gloo, device cpu" in out
    assert "mesh {'data': 1} n_micro 1" in out
    _, want = train_loop(reduced(get_config("gemma-2b")), steps=3, batch=8,
                         seq=32, compress=True, device="cpu", log_every=100)
    assert len(losses) == 3
    for got, w in zip(losses, want):
        assert abs(got - w) <= LOSS_RTOL * w

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.dist import compat
    from repro_torch.launch.mesh import make_production_mesh

    assert not dist.is_initialized()
    cluster.init_distributed("cpu")
    try:
        mesh = make_production_mesh()
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        x = torch.arange(12.0).reshape(4, 3)
        assert sharding.constrain(x, ("batch", None)) is x
        dt = distribute_tensor(x, *sharding.sharding_for(
            ("batch", None), x.shape, mesh))
        with compat.mesh_context(mesh):
            assert compat.ambient_mesh() is mesh
            y = sharding.constrain(dt, ("batch", None))
        assert compat.ambient_mesh() is None
        assert list(y.placements) == [Replicate(), Replicate()]
        assert torch.equal(y.full_tensor(), x)
        # on a group of one, compressed_psum is its plain formula
        from repro_torch.optim.compress import compressed_psum

        g = torch.randn(7, 5, generator=torch.Generator().manual_seed(0))
        scale = torch.clamp(g.abs().max() / 127.0, min=1e-12)
        plain = torch.clamp(torch.round(g / scale), -127, 127) * scale
        assert torch.equal(compressed_psum(g), plain)
    finally:
        dist.destroy_process_group()


def test_train_dp_splits_front_end_inputs_by_rank():
    """A rank's rows of the encoder frames are the global batch's rows."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.train import step_embeds

    cfg = reduced(get_config("seamless-m4t-medium"))
    pipe = TokenPipeline(cfg.vocab_size, 8, 16)
    whole = step_embeds(cfg, 5, 8, 16)["enc_embeds"]
    for rank in range(2):
        b = cluster.make_global_batch(pipe, 5, rank, 2, cfg)
        rows = cluster.host_rows(8, rank, 2)
        assert torch.equal(b["enc_embeds"], whole[rows.start:rows.stop])
        assert np.array_equal(b["tokens"].numpy(), pipe.batch_at(
            5, rows=rows)["tokens"])
