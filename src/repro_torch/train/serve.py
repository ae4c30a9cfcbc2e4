"""Serving steps: prefill (prompt -> last-token logits + filled caches)
and greedy decode (one token against the cache).

Prefill slices the residual stream to the final position *before* the
LM head: (b, s, vocab) logits of a long prompt would be gigabytes.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..models import ApproxPolicy
from ..models.config import ModelConfig
from ..models.transformer import Caches, Transformer

__all__ = ["Generator", "make_prefill_step", "make_decode_step",
           "frontend_inputs", "ENC_LEN"]


def make_prefill_step(model: Transformer, *, impl: str = "kernel",
                      policy: Optional[ApproxPolicy] = None) -> Callable:
    """``prefill(tokens (b, L), caches, *, embeds=None, enc_embeds=None)
    -> (last_logits (b, 1, V), caches)``, as the JAX package's prefill
    takes its batch's ``tokens``, ``embeds`` and ``enc_embeds``: front-end
    ``embeds`` (b, f, d) go before the tokens; an encoder-decoder config
    encodes ``enc_embeds`` (b, s_enc, d) and its cross layers cache the
    encoder's k/v, which decode reads (so, unlike the JAX package's, it
    returns no ``enc_out``).  ``impl`` picks the attention / scan route
    ("kernel" or "plain"); ``policy``, where given, replaces the model's
    own."""

    @torch.no_grad()
    def prefill(tokens: torch.Tensor, caches: Caches, *,
                embeds: Optional[torch.Tensor] = None,
                enc_embeds: Optional[torch.Tensor] = None):
        enc_out = (model.encode(enc_embeds, impl=impl, policy=policy)
                   if model.cfg.is_encoder_decoder else None)
        x = model.run_layers(model.embed_tokens(tokens, embeds),
                             caches=caches, impl=impl, policy=policy,
                             enc_out=enc_out)
        return model.logits(x[:, -1:, :]), caches

    return prefill


def make_decode_step(model: Transformer, *,
                     policy: Optional[ApproxPolicy] = None) -> Callable:
    """``serve_step(caches, tokens (b, 1), pos) -> (next_tokens (b, 1),
    logits, caches)``, greedy; ``policy`` as ``make_prefill_step``'s."""

    @torch.no_grad()
    def serve_step(caches: Caches, tokens: torch.Tensor, pos: int):
        logits = model.decode_step(caches, tokens, pos, policy=policy)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, logits, caches

    return serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# encoder frames an encoder-decoder serves against when the caller gives
# none (the JAX package's ``Generator``)
ENC_LEN = 16


def frontend_inputs(cfg: ModelConfig, batch: int, *, seed: int = 0,
                    embeds: Optional[torch.Tensor] = None,
                    enc_embeds: Optional[torch.Tensor] = None) -> Dict:
    """The stub front ends' inputs of one batch, as the JAX package's
    ``Generator`` synthesizes them: ``enc_embeds`` (b, 16, d) for an
    encoder-decoder, ``embeds`` (b, frontend_len, d) for a vision front
    end, each drawn float32 x 0.1 from a ``torch.Generator`` seeded with
    ``seed`` where the caller gives none (torch's RNG: not the JAX
    package's numbers).  Given ones are checked and kept."""
    g = torch.Generator().manual_seed(int(seed))
    out: Dict[str, Optional[torch.Tensor]] = {"embeds": None,
                                              "enc_embeds": None}
    d = cfg.d_model
    if cfg.is_encoder_decoder:
        if enc_embeds is None:
            enc_embeds = torch.randn((batch, ENC_LEN, d), generator=g) * 0.1
        enc_embeds = torch.as_tensor(enc_embeds)
        if enc_embeds.dim() != 3 or enc_embeds.shape[0] != batch \
                or enc_embeds.shape[2] != d:
            raise ValueError(f"enc_embeds must be ({batch}, s_enc, {d}), got "
                             f"{tuple(enc_embeds.shape)}")
        out["enc_embeds"] = enc_embeds
    elif enc_embeds is not None:
        raise ValueError(f"{cfg.name} has no encoder: enc_embeds given")
    if cfg.frontend == "vision":
        if embeds is None:
            embeds = torch.randn((batch, cfg.frontend_len, d),
                                 generator=g) * 0.1
        embeds = torch.as_tensor(embeds)
        if tuple(embeds.shape) != (batch, cfg.frontend_len, d):
            raise ValueError(f"embeds must be ({batch}, {cfg.frontend_len}, "
                             f"{d}), got {tuple(embeds.shape)}")
        out["embeds"] = embeds
    elif embeds is not None:
        raise ValueError(f"{cfg.name} has no vision front end: embeds given")
    return out


class Generator:
    """One model's prefill + decode steps, reused across prompt batches.
    Caches are allocated per ``generate`` call, sized (batch, frontend +
    prompt_len + gen), and the encoder's length for an encoder-decoder.
    ``policy``, where given, replaces the model's own in every step (one
    float32 model serving many policies, ``accel.lm``).  ``timings``
    holds the last call's ``prefill_s`` and ``decode_s`` (host clock
    around work that ends in a synchronise on the card)."""

    def __init__(self, model: Transformer, *, impl: str = "kernel",
                 policy: Optional[ApproxPolicy] = None):
        self.model = model
        self.impl = impl
        self._prefill = make_prefill_step(model, impl=impl, policy=policy)
        self._decode = make_decode_step(model, policy=policy)
        self.timings: Dict[str, float] = {}

    def generate(self, prompts: torch.Tensor, gen: int, *,
                 embeds: Optional[torch.Tensor] = None,
                 enc_embeds: Optional[torch.Tensor] = None,
                 seed: int = 0) -> Tuple[torch.Tensor, float]:
        """Greedy-decode ``gen`` tokens after ``prompts`` (b, L), and
        after the front end's ``embeds`` / against ``enc_embeds`` where
        the config has one (``frontend_inputs``: drawn from ``seed``
        where not given).  Returns (tokens (b, L + gen) int32, decode
        tokens/s)."""
        if gen < 1:
            raise ValueError(f"gen must be >= 1, got {gen}")
        cfg = self.model.cfg
        dev = self.model.device
        prompts = prompts.to(device=dev, dtype=torch.int32)
        batch, prompt_len = prompts.shape
        extra = frontend_inputs(cfg, batch, seed=seed, embeds=embeds,
                                enc_embeds=enc_embeds)
        extra = {k: None if v is None else v.to(dev)
                 for k, v in extra.items()}
        vis = cfg.frontend_len if cfg.frontend == "vision" else 0
        enc_len = (extra["enc_embeds"].shape[1]
                   if extra["enc_embeds"] is not None else 0)
        caches = self.model.init_caches(batch, prompt_len + int(gen) + vis,
                                        enc_len)

        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = self._prefill(prompts, caches, **extra)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        _sync(dev)
        t1 = time.perf_counter()
        toks = [prompts, nxt]
        pos0 = prompt_len + vis
        for i in range(int(gen) - 1):
            nxt, logits, caches = self._decode(caches, nxt, pos0 + i)
            toks.append(nxt)
        _sync(dev)
        t2 = time.perf_counter()
        self.timings = {"prefill_s": t1 - t0, "decode_s": t2 - t1}
        tps = batch * (int(gen) - 1) / max(t2 - t1, 1e-9)
        return torch.cat(toks, dim=1), tps
