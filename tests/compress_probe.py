"""What int8 error-feedback compression does to gemma-2b's first steps at
full size, on the card (a script, not a test).

    PYTHONPATH=src python tests/compress_probe.py

First, step 0's gradients of ``chip_smoke.py``'s ``TRAIN`` batch (8 x
1024, seed 0) in 4 micro-batches, as its ``cluster`` line takes them
(with 2, the compressed run's residual and temporaries did not fit the
80 GB card after the uncompressed run): for each of the JAX package's
leaves (``train/step.py`` ``_leaf_groups``, one int8 scale a leaf), the
share of its nonzero gradient elements that ``ef_quantize`` rounds to 0.
AdamW's first update moves every element whose gradient is nonzero by
about the learning rate, so an element rounded to 0 is not moved until
its residual reaches half a quantization step. Then ``launch/train.py``
``train_loop`` for 6 steps at lr 1e-3, without and with ``compress``,
from the same seed and batches: both losses a step.
"""

import contextlib
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.train import train_loop
from repro_torch.models.transformer import Transformer
from repro_torch.optim.compress import ef_quantize
from repro_torch.train.step import _leaf_groups, _split_micro, make_loss_fn

ARCH = "gemma-2b"
BATCH, SEQ, N_MICRO, LR, STEPS = 8, 1024, 4, 1e-3, 6


def zeroed_by_leaf() -> None:
    cfg = get_config(ARCH)
    model = Transformer(cfg, device="cuda", trainable=True)
    model.init_weights(0)
    loss_fn = make_loss_fn(model)
    batch = {k: _split_micro(torch.from_numpy(v).cuda(), N_MICRO)
             for k, v in TokenPipeline(cfg.vocab_size, BATCH, SEQ,
                                       seed=0).batch_at(0).items()}
    for i in range(N_MICRO):
        loss_fn({k: v[i] for k, v in batch.items()})[0].backward()
    params = dict(model.named_parameters())
    rows = []
    total_nz = total_zeroed = 0
    for names in _leaf_groups(list(params), cfg):
        g = torch.stack([params[k].grad for k in names]) / N_MICRO
        deq, _ = ef_quantize(g, torch.zeros_like(g, dtype=torch.float32))
        nz = int((g != 0).sum())
        zeroed = int(((g != 0) & (deq == 0)).sum())
        total_nz += nz
        total_zeroed += zeroed
        rows.append((zeroed, nz, g.numel(), names[0], len(names)))
        del g, deq
    print(f"step 0: {total_zeroed} of {total_nz} nonzero gradient elements "
          f"rounded to 0 ({total_zeroed / total_nz:.4f})")
    for zeroed, nz, n, name, k in sorted(rows, reverse=True)[:8]:
        print(f"  {name} (x{k}): {zeroed} of {nz} nonzero rounded to 0 "
              f"({zeroed / max(nz, 1):.4f}), {n} elements")


def losses() -> None:
    cfg = get_config(ARCH)
    for compress in (False, True):
        torch.cuda.empty_cache()
        with contextlib.redirect_stdout(sys.stderr):
            state, got = train_loop(cfg, steps=STEPS, batch=BATCH, seq=SEQ,
                                    n_micro=N_MICRO, lr=LR,
                                    compress=compress, device="cuda",
                                    log_every=100)
        del state
        print(f"compress={compress}: losses {[round(x, 4) for x in got]}",
              flush=True)


if __name__ == "__main__":
    zeroed_by_leaf()
    torch.cuda.empty_cache()
    losses()
