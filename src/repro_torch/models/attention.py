"""Attention layers: GQA self-attention (causal, or full in an encoder)
with RoPE and a preallocated KV cache, and an encoder-decoder's cross
attention with a fixed cache of the encoder's k/v.  Prefill runs the
flash-attention kernel over the prompt's own k/v; self-attention decode
attends one token over the masked cache in float32, plain PyTorch, as
the JAX package does; cross attention runs the kernel (non-causal) in
both, over the encoder's keys.  Projections route through
``approx_linear.linear`` so a DSE policy applies."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..kernels.flash_attention import attention as attn_op
from .approx_linear import ApproxPolicy, linear, param_dtypes
from .common import ParamModule, ParamSpec, apply_rope, rms_norm
from .config import ModelConfig

__all__ = [
    "Attention",
    "CrossAttention",
    "attn_param_specs",
    "gqa_decode_attention",
    "init_cross_cache",
    "init_kv_cache",
]

# projection class of each weight
_CLASSES = {"wq": "qkv", "wk": "qkv", "wv": "qkv", "wo": "attn_out"}


def attn_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    return {
        "norm": ParamSpec((d,), init="zeros", logical=("norm",)),
        "wq": ParamSpec((d, cfg.n_heads * hd), logical=("embed", "heads")),
        "wk": ParamSpec((d, cfg.n_kv_heads * hd),
                        logical=("embed", "kv_heads")),
        "wv": ParamSpec((d, cfg.n_kv_heads * hd),
                        logical=("embed", "kv_heads")),
        "wo": ParamSpec((cfg.n_heads * hd, d), logical=("heads", "embed")),
    }


def gqa_decode_attention(
    q: torch.Tensor,     # (b, h, 1, d)
    ck: torch.Tensor,    # (b, kvh, S, d)
    cv: torch.Tensor,
    pos: int,            # attend to cache positions <= pos
) -> torch.Tensor:
    """Single-token decode attention over the whole preallocated cache,
    masked past ``pos``; float32 math, GQA by a grouped einsum."""
    b, h, _, d = q.shape
    kvh, s = ck.shape[1], ck.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d)
    scale = d ** -0.5
    scores = torch.einsum("bgrd,bgsd->bgrs", (qg * scale).float(), ck.float())
    mask = torch.arange(s, device=q.device) <= pos
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bgsd->bgrd", probs, cv.float())
    return out.reshape(b, h, 1, d).to(q.dtype)


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1).transpose(1, 2)   # (b, h, s, d)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class Attention(ParamModule):
    def __init__(self, cfg: ModelConfig, policy: Optional[ApproxPolicy],
                 device, proj_dtype: Optional[torch.dtype] = None):
        specs = attn_param_specs(cfg)
        super().__init__(specs, param_dtypes(specs, _CLASSES, policy,
                                             proj_dtype), device)
        self.cfg = cfg
        self.policy = policy

    def forward(
        self,
        x: torch.Tensor,                   # (b, s, d)
        inv_freq: torch.Tensor,
        *,
        cache: Optional[Dict[str, torch.Tensor]] = None,
        pos: Optional[int] = None,         # decode position
        impl: str = "kernel",
        policy: Optional[ApproxPolicy] = None,
        causal: bool = True,
    ) -> torch.Tensor:
        """Prefill (``pos`` None): attention over the sequence through
        the flash kernel, causal unless ``causal`` is False (an encoder);
        with a cache, this sequence's k/v are written to its first
        positions.  Decode (``pos`` given, s == 1): k/v written at
        ``pos`` and attention over the cache.  The cache is updated in
        place.  ``policy``, where given, replaces the one the layer was
        built with for this call."""
        cfg = self.cfg
        policy = self.policy if policy is None else policy
        s = x.shape[1]
        h = rms_norm(x, self.norm, cfg.rms_eps)
        q = _split_heads(linear(h, self.wq, "qkv", policy), cfg.n_heads)
        k = _split_heads(linear(h, self.wk, "qkv", policy), cfg.n_kv_heads)
        v = _split_heads(linear(h, self.wv, "qkv", policy), cfg.n_kv_heads)

        positions = None
        if pos is not None:
            positions = torch.full((s,), pos, dtype=torch.int32,
                                   device=x.device)
        q = apply_rope(q, inv_freq, positions)
        k = apply_rope(k, inv_freq, positions)

        if cache is not None:
            start = 0 if pos is None else pos
            cache["k"][:, :, start:start + s] = k
            cache["v"][:, :, start:start + s] = v

        if pos is not None:
            out = gqa_decode_attention(q, cache["k"], cache["v"], pos)
        else:
            # prefill attends over the locally computed k/v, as the JAX
            # package does, not over the bf16 cache copy
            out = attn_op(q, k, v, causal=causal, impl=impl)
        return linear(_merge_heads(out), self.wo, "attn_out", policy)


class CrossAttention(ParamModule):
    """An encoder-decoder layer's cross attention: the decoder stream's
    queries (RMS-normed, no RoPE) over keys and values projected from
    the encoder's output (no norm, no RoPE), non-causal.  Its weights are
    declared as self-attention's."""

    def __init__(self, cfg: ModelConfig, policy: Optional[ApproxPolicy],
                 device, proj_dtype: Optional[torch.dtype] = None):
        specs = attn_param_specs(cfg)
        super().__init__(specs, param_dtypes(specs, _CLASSES, policy,
                                             proj_dtype), device)
        self.cfg = cfg
        self.policy = policy

    def forward(
        self,
        x: torch.Tensor,                   # (b, s, d)
        enc_out: Optional[torch.Tensor],   # (b, s_enc, d)
        *,
        cache: Optional[Dict[str, torch.Tensor]] = None,
        pos: Optional[int] = None,         # decode position
        impl: str = "kernel",
        policy: Optional[ApproxPolicy] = None,
    ) -> torch.Tensor:
        """Prefill (``pos`` None): k/v projected from ``enc_out`` and
        attended; with a cache, their bf16 copies written to it.  Decode
        (``pos`` given): attention over the cached k/v (``enc_out`` is
        not read), as the JAX package's decode step does.  Training
        (grad enabled, no cache) takes the prefill path in every layer:
        ``attn_op`` runs ``FlashAttention``, the forward and backward
        kernels non-causally at sq = the decoder's length, sk = the
        encoder's."""
        cfg = self.cfg
        policy = self.policy if policy is None else policy
        h = rms_norm(x, self.norm, cfg.rms_eps)
        q = _split_heads(linear(h, self.wq, "qkv", policy), cfg.n_heads)
        if pos is not None:
            k, v = cache["k"], cache["v"]
        else:
            k = _split_heads(linear(enc_out, self.wk, "qkv", policy),
                             cfg.n_kv_heads)
            v = _split_heads(linear(enc_out, self.wv, "qkv", policy),
                             cfg.n_kv_heads)
            if cache is not None:
                cache["k"].copy_(k)
                cache["v"].copy_(v)
        out = attn_op(q, k, v, causal=False, impl=impl)
        return linear(_merge_heads(out), self.wo, "attn_out", policy)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device) -> Dict[str, torch.Tensor]:
    """One layer's KV cache: bf16 zeros of (b, kvh, max_len, hd)."""
    shape = (batch, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def init_cross_cache(cfg: ModelConfig, batch: int, enc_len: int,
                     device) -> Dict[str, torch.Tensor]:
    """One cross-attention layer's cache of the encoder's k/v: bf16 zeros
    of (b, kvh, enc_len, hd), filled by prefill."""
    return init_kv_cache(cfg, batch, enc_len, device)
