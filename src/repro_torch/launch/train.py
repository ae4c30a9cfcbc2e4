"""Training entry point: runs end to end on the card at full size, and on the
CPU at reduced scale.

    python -m repro_torch.launch.train --arch gemma-2b --steps 12 \\
        --batch 8 --seq 1024 --n-micro 2
    python -m repro_torch.launch.train --arch falcon-mamba-7b \\
        --n-layers 32 --steps 12 --batch 8 --seq 1024 --n-micro 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --reduced --steps 50 --batch 8 --seq 64 --device cpu

Features, as the JAX package's ``launch/train.py``: deterministic data
pipeline, AdamW, microbatch accumulation, periodic checkpointing and
restart from the latest checkpoint, optional int8 error-feedback
gradient compression, optional approximation policy on the FFN
projections (the paper's technique applied to the LM).  Weights are
random, drawn from ``seed``.  Without ``--device`` it runs on the GPU
and raises on a machine without one.  Attention, Mamba (falcon-mamba)
and hybrid (jamba) stacks train, each layer rematerialised, through the
attention and selective-scan kernels each way; masters and AdamW
moments in the config's ``param_dtype`` and ``moment_dtype`` (bf16 for
jamba).  ``--n-layers`` cuts the depth (a multiple of the block
pattern; the widths stay published) where the training state exceeds
one card: falcon-mamba-7b's 64 layers take 7.27 B x 16 B = 117 GB, 32
fit an 80 GB card.  An encoder-decoder's batch carries ``enc_embeds``
(batch, seq, d_model) and a vision front end's ``embeds`` (batch,
frontend_len, d_model), normals of standard deviation 0.1 as the JAX
package's loop draws them, but on the model's device from a
``torch.Generator`` seeded with the step and the row (``step_embeds``):
the port cannot draw ``jax.random``'s bits, so its embeddings differ
from the JAX package's; a caller that needs them equal passes its own
(``train_loop``'s ``embeds_at``).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace
from typing import Callable, Dict, List, Optional

import torch

from ..checkpoint import ckpt
from ..configs import get_config
from ..data.pipeline import TokenPipeline
from ..models import ApproxPolicy, reduced
from ..models.transformer import Transformer
from ..optim.adamw import AdamW
from ..train.step import init_state, make_train_step

__all__ = ["train_loop", "step_embeds", "main"]


def step_embeds(cfg, step: int, batch: int, seq: int, device=None,
                rows: Optional[range] = None) -> Dict[str, torch.Tensor]:
    """The front-end inputs of step ``step``'s batch: an encoder-decoder's
    ``enc_embeds`` (batch, seq, d_model), a vision front end's ``embeds``
    (batch, frontend_len, d_model), float32 normals of standard deviation
    0.1 drawn on ``device``, row ``r`` from a ``torch.Generator`` seeded
    with ``step * batch + r``; {} for the other archs.  ``rows`` draws only those
    rows of the batch (a rank's share), the same values as the whole
    batch's.  A CPU and a CUDA generator draw different values."""
    if cfg.is_encoder_decoder:
        key, n = "enc_embeds", seq
    elif cfg.frontend == "vision":
        key, n = "embeds", cfg.frontend_len
    else:
        return {}
    dev = torch.device(device if device is not None else "cpu")
    rows = range(batch) if rows is None else rows
    x = torch.empty((len(rows), n, cfg.d_model), dtype=torch.float32,
                    device=dev)
    for i, r in enumerate(rows):
        gen = torch.Generator(dev).manual_seed(int(step) * batch + r)
        x[i].normal_(0.0, 0.1, generator=gen)
    return {key: x}


def train_loop(
    cfg,
    *,
    steps: int = 50,
    batch: int = 8,
    seq: int = 64,
    n_micro: int = 1,
    lr: float = 1e-3,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 25,
    compress: bool = False,
    policy: Optional[ApproxPolicy] = None,
    seed: int = 0,
    log_every: int = 10,
    device=None,
    history: Optional[List[dict]] = None,
    embeds_at: Optional[Callable[[int], Dict[str, torch.Tensor]]] = None,
):
    """Train ``cfg`` for ``steps`` steps; returns (state, losses).

    ``history``, if given, receives one dict a step: its metrics as
    floats and ``step_s``, the host seconds from the batch's upload to
    the loss read back (which waits for the card).  ``embeds_at(step)``,
    if given, returns the step's front-end inputs in place of
    ``step_embeds``."""
    pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=seed)
    opt = AdamW(lr=lr, warmup_steps=max(steps // 10, 1),
                moment_dtype=cfg.moment_dtype)
    model = Transformer(cfg, device=device, trainable=True)
    model.init_weights(seed)
    state = init_state(dict(model.named_parameters()), opt,
                       compress=compress)
    step_fn = make_train_step(model, opt, n_micro=n_micro, policy=policy,
                              compress=compress)

    start = 0
    if ckpt_dir is not None:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            ckpt.restore(ckpt_dir, latest, state)
            start = latest
            print(f"[train] restored checkpoint @ step {latest}")

    losses = []
    t0 = time.perf_counter()
    for step in range(start, steps):
        t_step = time.perf_counter()
        b = pipe.batch_at(step)
        batch_dev = {k: torch.from_numpy(b[k]).to(model.device)
                     for k in ("tokens", "labels")}
        extra = (embeds_at(step) if embeds_at is not None
                 else step_embeds(cfg, step, batch, seq, model.device))
        batch_dev.update({k: v.to(model.device) for k, v in extra.items()})
        state, metrics = step_fn(state, batch_dev)
        loss = float(metrics["loss"])
        losses.append(loss)
        if history is not None:
            history.append({"step": step, "step_s": time.perf_counter() - t_step,
                            **{k: float(v) for k, v in metrics.items()}})
        if step % log_every == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            print(f"[train] step {step:5d} loss={loss:8.4f} "
                  f"ce={float(metrics['ce']):8.4f} "
                  f"gnorm={float(metrics['grad_norm']):7.3f} ({dt:5.1f}s)",
                  flush=True)
        if ckpt_dir is not None and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, state)
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="depth to train at, a multiple of the arch's "
                         "block pattern (widths unchanged)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--approx", default=None,
                    help="apply a circuit to ffn projections, e.g. mul8s_trunc2")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.n_layers is not None:
        period = len(cfg.block_pattern)
        if args.n_layers < 1 or args.n_layers % period:
            ap.error(f"--n-layers must be a positive multiple of "
                     f"{cfg.name}'s block pattern ({period} layers)")
        cfg = replace(cfg, n_layers=args.n_layers)
    policy = None
    if args.approx:
        policy = ApproxPolicy({
            "ffn_in": (args.approx, None), "ffn_out": (args.approx, None),
        })
    _, losses = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        n_micro=args.n_micro, lr=args.lr, ckpt_dir=args.ckpt_dir,
        compress=args.compress, policy=policy, device=args.device,
    )
    print(f"[train] first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
