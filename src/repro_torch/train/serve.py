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
from ..models.transformer import Caches, Transformer

__all__ = ["Generator", "make_prefill_step", "make_decode_step"]


def make_prefill_step(model: Transformer, *, impl: str = "kernel",
                      policy: Optional[ApproxPolicy] = None) -> Callable:
    """``prefill(tokens (b, L), caches) -> (last_logits (b, 1, V),
    caches)``; ``impl`` picks the attention / scan route ("kernel" or
    "plain"); ``policy``, where given, replaces the model's own."""

    @torch.no_grad()
    def prefill(tokens: torch.Tensor, caches: Caches):
        x = model.run_layers(model.embed_tokens(tokens), caches=caches,
                             impl=impl, policy=policy)
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


class Generator:
    """One model's prefill + decode steps, reused across prompt batches.
    Caches are allocated per ``generate`` call, sized (batch, prompt_len +
    gen).  ``policy``, where given, replaces the model's own in every
    step (one float32 model serving many policies, ``accel.lm``).
    ``timings`` holds the last call's ``prefill_s`` and ``decode_s``
    (host clock around work that ends in a synchronise on the card)."""

    def __init__(self, model: Transformer, *, impl: str = "kernel",
                 policy: Optional[ApproxPolicy] = None):
        self.model = model
        self.impl = impl
        self._prefill = make_prefill_step(model, impl=impl, policy=policy)
        self._decode = make_decode_step(model, policy=policy)
        self.timings: Dict[str, float] = {}

    def generate(self, prompts: torch.Tensor,
                 gen: int) -> Tuple[torch.Tensor, float]:
        """Greedy-decode ``gen`` tokens after ``prompts`` (b, L).
        Returns (tokens (b, L + gen) int32, decode tokens/s)."""
        if gen < 1:
            raise ValueError(f"gen must be >= 1, got {gen}")
        dev = self.model.device
        prompts = prompts.to(device=dev, dtype=torch.int32)
        batch, prompt_len = prompts.shape
        caches = self.model.init_caches(batch, prompt_len + int(gen))

        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = self._prefill(prompts, caches)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        _sync(dev)
        t1 = time.perf_counter()
        toks = [prompts, nxt]
        for i in range(int(gen) - 1):
            nxt, logits, caches = self._decode(caches, nxt, prompt_len + i)
            toks.append(nxt)
        _sync(dev)
        t2 = time.perf_counter()
        self.timings = {"prefill_s": t1 - t0, "decode_s": t2 - t1}
        tps = batch * (int(gen) - 1) / max(t2 - t1, 1e-9)
        return torch.cat(toks, dim=1), tps
