"""Serving driver: batched prefill + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu

Weights are random, drawn from ``--seed``, and so are the stub front
ends' inputs (``train.serve.frontend_inputs``): 16 encoder frames for
seamless-m4t-medium, ``frontend_len`` patch embeddings before the prompt
for qwen2-vl-72b.  Without ``--device`` it runs on the GPU and raises on
a machine without one.  ``--approx`` serves the
FFN projections (``ffn_in``/``ffn_out``) on one circuit of the library.

The approximate-serving path can draw its policy from a stored Pareto
front instead: ``--front front.json --tier budget`` loads the front (a
``FrontCatalog.to_json`` file, or the JAX package's ``GET /front``
payload shape), resolves the tier to a genome, and decodes it to the
``ApproxPolicy`` the model is built with.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from ..configs import get_config
from ..models import ApproxPolicy, reduced
from ..models.transformer import Transformer
from ..train.serve import Generator

__all__ = ["build_model", "serve_batch", "policy_from_front", "main"]


def build_model(cfg, *, policy: Optional[ApproxPolicy] = None, seed: int = 0,
                device=None, params: Optional[Dict] = None) -> Transformer:
    """The model of ``cfg`` on ``device`` (default the GPU), its weights
    drawn from ``seed`` or loaded from ``params`` (a state_dict such as
    ``convert.lm_params_from_numpy`` returns), stored in the dtypes
    ``policy`` needs."""
    model = Transformer(cfg, policy=policy, device=device)
    if params is None:
        model.init_weights(seed)
    else:
        model.load_state_dict(params)
    return model


def serve_batch(
    cfg,
    *,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 16,
    policy: Optional[ApproxPolicy] = None,
    seed: int = 0,
    params: Optional[Dict] = None,
    prompts=None,
    device=None,
    model: Optional[Transformer] = None,
    impl: str = "kernel",
    timings: Optional[Dict[str, float]] = None,
    embeds=None,
    enc_embeds=None,
):
    """Greedy-decode ``gen`` tokens for a batch of prompts (random from
    ``seed`` by default), after a vision front end's ``embeds`` and
    against an encoder-decoder's ``enc_embeds`` (each drawn from ``seed``
    where the config takes it and none is given).  Returns (tokens (b,
    prompt+gen), tokens/s).

    ``model`` serves an already built model (its config must be
    ``cfg``); otherwise one is built on ``device`` from ``params`` or
    ``seed``.  ``timings``, if given, receives the run's ``prefill_s``
    and ``decode_s``."""
    if model is None:
        model = build_model(cfg, policy=policy, seed=seed, device=device,
                            params=params)
    elif model.cfg != cfg:
        raise ValueError(f"model was built for {model.cfg.name}, not "
                         f"{cfg.name}")
    elif policy is not None and model.policy is not policy:
        raise ValueError("model was built under another policy")
    if prompts is None:
        g = torch.Generator().manual_seed(int(seed))
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=g, dtype=torch.int64)
    prompts = torch.as_tensor(prompts)
    gen_ = Generator(model, impl=impl)
    tokens, tps = gen_.generate(prompts, gen, embeds=embeds,
                                enc_embeds=enc_embeds, seed=seed)
    if timings is not None:
        timings.update(gen_.timings)
    return tokens, tps


def policy_from_front(cfg, front_path: str, tier: str = "balanced"):
    """(policy, selection) for ``tier`` of the stored front at
    ``front_path``: the CLI's bridge from a DSE campaign's output to a
    runnable serving configuration.  The ``LMAccelerator`` built here
    only decodes the genome; it draws no weights."""
    from ..accel.lm import LMAccelerator
    from ..serving import FrontCatalog

    cat = FrontCatalog.from_file(front_path)
    expect = f"lm:{cfg.name}"
    if cat.accel != expect:
        print(f"[serve] WARNING: front is for {cat.accel!r}, "
              f"serving {expect!r}")
    sel = cat.select(tier=tier)
    accel = LMAccelerator(cfg, use_reduced=False)
    policy = accel.policy_for_genome(
        sel.point.genome_array(), rank_genes=cat.rank_genes)
    return policy, sel


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--approx", default=None,
                    help="hand-picked circuit for ffn_in/ffn_out")
    ap.add_argument("--front", default=None,
                    help="stored front JSON (FrontCatalog.to_json or the "
                         "GET /front shape); the policy comes from its "
                         "--tier operating point")
    ap.add_argument("--tier", default="balanced",
                    choices=("exact", "balanced", "budget"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    policy = None
    if args.front and args.approx:
        ap.error("--front and --approx are mutually exclusive")
    if args.front:
        policy, sel = policy_from_front(cfg, args.front, args.tier)
        labels = " ".join(
            f"{k}={v:.3g}" for k, v in sel.point.labels.items())
        print(f"[serve] tier={args.tier} genome={list(sel.point.genome)} "
              f"({labels})")
    elif args.approx:
        policy = ApproxPolicy({
            "ffn_in": (args.approx, None), "ffn_out": (args.approx, None),
        })
    timings: Dict[str, float] = {}
    tokens, tps = serve_batch(
        cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
        policy=policy, seed=args.seed, device=args.device, timings=timings,
    )
    print(f"[serve] {cfg.name}: generated {tuple(tokens.shape)} on "
          f"{tokens.device} @ {tps:.1f} tok/s "
          f"(prefill {timings['prefill_s']:.3f} s)")
    print(tokens[0].tolist())


if __name__ == "__main__":
    main()
