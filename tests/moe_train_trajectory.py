"""Print the JAX package's and the port's MoE training trajectories side
by side on the CPU: loss, ce, the load-balance loss ``aux`` and the
gradient norm a step, from one numpy-drawn state on the same batches.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/moe_train_trajectory.py \\
        --preset width --lr 1e-3 --steps 5

``--preset reduced`` is ``tests/test_torch_train.py``'s granite-moe (4
experts, top-2, d 64); ``width`` keeps granite-moe-3b's width (d 1536,
24/8 heads, 40 experts top-8, d_ff 512) on 2 layers with a 4096-entry
vocabulary, at batch 2 x 256 (about 2 minutes).  ``--reference-only``
skips the port.  Warmup is the training entry point's at these step
counts, 1; one micro-batch.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import param_specs as ref_param_specs
from repro.models import reduced as ref_reduced
from repro.models.common import ParamSpec
from repro.optim import AdamW as RefAdamW
from repro.train.step import init_state as ref_init_state
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import Transformer, reduced
from repro_torch.optim import AdamW
from repro_torch.train import init_state, make_train_step

PRESETS = {
    "reduced": (dict(), 2, 64),
    "width": (dict(n_layers=2, d_model=1536, n_heads=24, n_kv_heads=8,
                   head_dim=64, d_ff=512, vocab_size=4096, n_experts=40,
                   n_experts_active=8), 2, 256),
}


@torch.no_grad()
def _load(state, tree):
    for k, src in tree.items():
        if isinstance(src, dict):
            _load(state[k], src)
        else:
            state[k].copy_(src)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="width")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--reference-only", action="store_true")
    args = ap.parse_args(argv)

    over, b, s = PRESETS[args.preset]
    arch = "granite-moe-3b-a800m"
    rcfg = ref_reduced(ref_get_config(arch), **over)
    cfg = reduced(get_config(arch), **over)
    rng = np.random.default_rng(0)

    def draw(spec):
        if spec.init == "zeros":
            return np.zeros(spec.shape, np.float32)
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        return (rng.standard_normal(spec.shape) * spec.scale).astype(
            np.float32)

    params = jax.tree.map(draw, ref_param_specs(rcfg),
                          is_leaf=lambda x: isinstance(x, ParamSpec))
    warmup = max(args.steps // 10, 1)
    ref_opt = RefAdamW(lr=args.lr, warmup_steps=warmup)
    ref_state = ref_init_state(params, ref_opt)
    ref_step = jax.jit(ref_make_train_step(rcfg, ref_opt, attn_chunk=s))
    port = not args.reference_only
    if port:
        model = Transformer(cfg, device="cpu", trainable=True)
        opt = AdamW(lr=args.lr, warmup_steps=warmup)
        state = init_state(dict(model.named_parameters()), opt)
        _load(state, convert.train_state_from_numpy(
            jax.tree.map(np.asarray, ref_state), cfg))
        step = make_train_step(model, opt)
    pipe = TokenPipeline(cfg.vocab_size, b, s, seed=0)
    print(f"{args.preset} lr={args.lr} warmup={warmup} batch {b} x {s}")
    for i in range(args.steps):
        batch = pipe.batch_at(i)
        ref_state, rm = ref_step(
            ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
        line = (f"step {i}: reference loss {float(rm['loss']):.4f} "
                f"ce {float(rm['ce']):.4f} aux {float(rm['aux']):.3f} "
                f"grad_norm {float(rm['grad_norm']):.3f}")
        if port:
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
            line += (f" | port loss {float(m['loss']):.4f} "
                     f"ce {float(m['ce']):.4f} aux {float(m['aux']):.3f} "
                     f"grad_norm {float(m['grad_norm']):.3f}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
