"""Multi-process cluster bootstrap, the JAX package's ``launch/cluster.py``
on ``torch.distributed``: data-parallel training, one process a device.

  * ``init_distributed`` joins the process group from the environment:
    the JAX package's ``COORDINATOR_ADDRESS`` (host:port),
    ``NUM_PROCESSES`` and ``PROCESS_ID``, else torch's ``MASTER_ADDR``
    (and ``MASTER_PORT``), ``WORLD_SIZE`` and ``RANK``; with none of
    them set, a group of one process on a free localhost port.  The
    backend is NCCL on the card and gloo only where the caller asked for
    the CPU.
  * ``host_rows`` is each rank's contiguous share of the global batch;
    the data pipeline is counter-based, so ranks need no coordination
    (``make_global_batch`` draws only a rank's rows).
  * ``main`` builds the JAX package's mesh (``launch/mesh.py``'s
    production mesh from 256 ranks, else one "data" axis over the
    ranks), makes it and ``launch/shapes.py``'s ``train_4k`` rules
    ambient (``dist.compat.mesh_context``, ``dist.sharding.
    rule_overrides``) and takes the micro-batch count from
    ``n_microbatches`` at the run's batch (1 with ``--reduced``), as the
    JAX package's ``main`` does.  It then trains data-parallel: every
    rank builds the same model from the seed and runs its rows, and the
    gradients are averaged over the group (an all-reduce in float32, or
    under ``--compress`` each leaf's int8 error-feedback-quantized
    gradient, ``optim.compress.ef_quantize``, summed by
    ``compressed_psum``) before AdamW, so every rank takes the same step.
    A rank's residual is its own quantization's; the sum's requantization
    to the group's shared scale is not carried (none on one rank, where
    the step is ``launch/train.py --compress``'s).  No tensor is sharded
    by the mesh yet: the port's step replicates the model on every rank.
    Rank 0 writes the checkpoints; a restart on any number of ranks reads
    them.

    # 2 processes on the CPU (gloo)
    MASTER_ADDR=127.0.0.1 MASTER_PORT=29511 WORLD_SIZE=2 RANK=$i \\
      PYTHONPATH=src python -m repro_torch.launch.cluster --arch gemma-2b \\
      --reduced --batch 8 --seq 32 --steps 3 --device cpu
    # one process on the card (NCCL)
    python -m repro_torch.launch.cluster --arch gemma-2b --batch 8 \\
      --seq 1024 --steps 3 --compress --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import time
from typing import Dict, List, Optional

import torch

from ..device import resolve_device

__all__ = ["init_distributed", "host_rows", "make_global_batch",
           "train_dp", "main"]

CKPT_EVERY = 100   # steps between checkpoints, and the last step's
LR = 1e-3          # launch/train.py's default rate


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(device=None) -> tuple:
    """Join (or form) the default process group from the environment;
    returns (rank, world size).  ``device`` "cpu" takes gloo, else NCCL
    on the card (which raises on a machine without one); on the card
    each process takes device ``LOCAL_RANK`` (else rank modulo the
    devices)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    env = os.environ
    if env.get("COORDINATOR_ADDRESS") and env.get("NUM_PROCESSES"):
        addr = env["COORDINATOR_ADDRESS"]
        world = int(env["NUM_PROCESSES"])
        rank = int(env.get("PROCESS_ID") or 0)
    elif env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        world = int(env["WORLD_SIZE"])
        rank = int(env.get("RANK") or 0)
    else:
        addr, world, rank = f"127.0.0.1:{_free_port()}", 1, 0
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo" if dev.type == "cpu" else "nccl",
            init_method=f"tcp://{addr}", world_size=world, rank=rank)
    return dist.get_rank(), dist.get_world_size()


def host_rows(global_batch: int, process_index: int,
              process_count: int) -> range:
    """The contiguous row range of the global batch this process
    produces."""
    per = global_batch // process_count
    return range(process_index * per, (process_index + 1) * per)


def make_global_batch(pipe, step: int, rank: int, world: int, cfg,
                      device=None) -> Dict[str, torch.Tensor]:
    """This rank's rows of step ``step``'s global batch on ``device``:
    tokens and labels, and ``cfg``'s front-end inputs
    (``launch.train.step_embeds`` of those rows)."""
    from .train import step_embeds

    rows = host_rows(pipe.batch, rank, world)
    local = pipe.batch_at(step, rows=rows)
    out = {k: torch.from_numpy(v).to(device) for k, v in local.items()}
    out.update(step_embeds(cfg, step, pipe.batch, pipe.seq_len, device,
                           rows=rows))
    return out


def _grad_mean(world: int, compress: bool):
    """The train step's ``grad_reduce``: a gradient's mean over the
    default process group, by ``compressed_psum`` under ``compress``."""
    import torch.distributed as dist

    from ..optim.compress import compressed_psum

    def reduce(g: torch.Tensor) -> torch.Tensor:
        if compress:
            return (compressed_psum(g) / world).to(g.dtype)
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g.div_(world)

    return reduce


def _mesh(world: int):
    """The JAX package's choice of mesh: the production mesh on 256 or
    more ranks (two pods from 512), else one "data" axis."""
    from ..dist.compat import make_mesh
    from .mesh import make_production_mesh

    if world >= 512:
        return make_production_mesh(multi_pod=True)
    if world >= 256:
        return make_production_mesh()
    return make_mesh((world,), ("data",))


def train_dp(cfg, *, steps: int, batch: int, seq: int, rank: int,
             world: int, n_micro: int = 1, compress: bool = False,
             ckpt_dir: Optional[str] = None, seed: int = 0, device=None):
    """Data-parallel ``launch/train.py`` ``train_loop`` over the default
    process group: returns (state, losses), each loss the mean over the
    ranks of their rows' losses (the whole batch's loss)."""
    import torch.distributed as dist

    from ..checkpoint import ckpt
    from ..data.pipeline import TokenPipeline
    from ..models.transformer import Transformer
    from ..optim.adamw import AdamW
    from ..train.step import init_state, make_train_step

    if batch % world or (batch // world) % n_micro:
        raise ValueError(f"batch {batch} does not split into {world} ranks "
                         f"of {n_micro} micro-batches")
    pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=seed)
    opt = AdamW(lr=LR, warmup_steps=max(steps // 10, 1),
                moment_dtype=cfg.moment_dtype)
    model = Transformer(cfg, device=device, trainable=True)
    model.init_weights(seed)
    state = init_state(dict(model.named_parameters()), opt,
                       compress=compress)
    step_fn = make_train_step(model, opt, n_micro=n_micro,
                              compress=compress,
                              grad_reduce=_grad_mean(world, compress))
    start = 0
    if ckpt_dir is not None:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            ckpt.restore(ckpt_dir, latest, state)
            start = latest
            if rank == 0:
                print(f"[cluster] restored step {latest}", flush=True)
    losses: List[float] = []
    for step in range(start, steps):
        t0 = time.perf_counter()
        b = make_global_batch(pipe, step, rank, world, cfg, model.device)
        state, metrics = step_fn(state, b)
        loss = metrics["loss"].detach().reshape(1).clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM)
        losses.append(float(loss) / world)
        if rank == 0:
            print(f"[cluster] step {step} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"step_s={time.perf_counter() - t0:.4f}", flush=True)
        if ckpt_dir is not None and ((step + 1) % CKPT_EVERY == 0
                                     or step == steps - 1):
            if rank == 0:
                ckpt.save(ckpt_dir, step + 1, state)
            dist.barrier()
    return state, losses


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (single-host validation)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress", action="store_true",
                    help="average the gradients with the int8 "
                         "compressed_psum, with error feedback")
    ap.add_argument("--device", default=None,
                    help="cuda (default, NCCL) or cpu (gloo)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from .. import _build
    from ..configs import get_config
    from ..dist.compat import mesh_context
    from ..dist.sharding import mesh_sizes, rule_overrides
    from ..models import reduced as reduce_cfg
    from .shapes import cell_rules, n_microbatches

    rank, world = init_distributed(args.device)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    print(f"[cluster] process {rank}/{world}, backend "
          f"{dist.get_backend()}, device {dev}", flush=True)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    try:
        mesh = _mesh(world)
        rules = cell_rules(cfg, "train_4k", mesh)
        nm = 1 if args.reduced else n_microbatches(cfg, mesh, args.batch)
        if rank == 0:
            print(f"[cluster] mesh {mesh_sizes(mesh)} n_micro {nm}",
                  flush=True)
        with mesh_context(mesh), rule_overrides(rules):
            _, losses = train_dp(
                cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                rank=rank, world=world, n_micro=nm, compress=args.compress,
                ckpt_dir=args.ckpt_dir, seed=args.seed, device=dev)
        if rank == 0 and losses:
            print(f"[cluster] first loss {losses[0]:.4f} -> last "
                  f"{losses[-1]:.4f}", flush=True)
            print(f"[cluster] launches {json.dumps(_build.LAUNCHES)}",
                  flush=True)
    finally:
        dist.destroy_process_group()
    return losses


if __name__ == "__main__":
    main()
