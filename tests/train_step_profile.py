"""Where a training step of seamless-m4t-medium goes, on the card (a
script, not a test).

    PYTHONPATH=src python tests/train_step_profile.py prof   # one step traced
    PYTHONPATH=src python tests/train_step_profile.py lr     # 12 steps at two lrs

``prof`` builds seamless-m4t-medium at full size, trains one warm-up
step of 8 x 1024 tokens and 1024 encoder frames in 2 micro-batches at
``chip_smoke.py``'s ``TRAIN``, then traces the next step with
``torch.profiler`` (host and device) and prints its wall and the
profiler's tables by device and by host time.  ``lr`` runs
``launch/train.py`` ``train_loop`` at ``chip_smoke.py``'s ``TRAIN`` (12
steps) at lr 1e-3 and 3e-4, each through the attention kernels and
through the plain attention (``make_loss_fn``'s ``impl="plain"``), and
prints each run's losses and median seconds a step: a rise that both
routes show is the model's at that rate, not the kernels'."""

import contextlib
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.train import step_embeds, train_loop
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamW
import repro_torch.train.step as step_mod
from repro_torch.train.step import init_state, make_train_step

ARCH = "seamless-m4t-medium"
BATCH, SEQ, N_MICRO = 8, 1024, 2


def profile_step() -> None:
    cfg = get_config(ARCH)
    model = Transformer(cfg, device="cuda", trainable=True)
    model.init_weights(0)
    opt = AdamW(lr=1e-3, warmup_steps=1)
    state = init_state(dict(model.named_parameters()), opt)
    step = make_train_step(model, opt, n_micro=N_MICRO)
    pipe = TokenPipeline(cfg.vocab_size, BATCH, SEQ, seed=0)

    def batch(i):
        b = {k: torch.from_numpy(v).cuda()
             for k, v in pipe.batch_at(i).items()}
        b.update(step_embeds(cfg, i, BATCH, SEQ, "cuda"))
        return b

    state, _ = step(state, batch(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch(1))
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"step wall {wall:.4f} s (traced)")
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=25))
    print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=25))


@contextlib.contextmanager
def _attention(impl: str):
    """``make_train_step``'s loss through ``impl``'s attention."""
    orig = step_mod.make_loss_fn
    step_mod.make_loss_fn = lambda model, policy=None: orig(
        model, policy, impl=impl)
    try:
        yield
    finally:
        step_mod.make_loss_fn = orig


def lr_probe() -> None:
    cfg = get_config(ARCH)
    for impl in ("kernel", "plain"):
        for lr in (1e-3, 3e-4):
            hist: list = []
            with _attention(impl), contextlib.redirect_stdout(sys.stderr):
                _, losses = train_loop(cfg, steps=12, batch=BATCH, seq=SEQ,
                                       n_micro=N_MICRO, lr=lr, device="cuda",
                                       log_every=100, history=hist)
            step_s = statistics.median(h["step_s"] for h in hist[1:])
            print(f"{impl} lr {lr}: losses {[round(x, 4) for x in losses]} "
                  f"step_s median {step_s:.4f}", flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    modes = {"prof": profile_step, "lr": lr_probe}
    for mode in sys.argv[1:] or ["prof"]:
        modes[mode]()
