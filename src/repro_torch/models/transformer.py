"""Model assembly: the embedding, the layer stack, the final norm and
the LM head; full forward (teacher forcing / prefill), single-token
decode and cache allocation.

The JAX package scans stacked super-blocks; here the stack is a flat
``nn.ModuleList`` of ``n_layers`` layers, super-block-major (layer
``sb * len(block_pattern) + i`` is position ``i`` of super-block ``sb``).
Weights are stored in the dtype their use needs (``approx_linear``):
the policy a model is built with is its default.  ``forward`` takes a
``policy`` for one call, as the JAX package's forward does; a model
that serves several policies from one set of weights is built with
``proj_dtype=torch.float32`` (``accel.lm``).  The LM head is never
approximated: ``logits`` runs it exact under every policy, as the JAX
package's ``_logits`` does.

A model built with ``trainable=True`` holds every parameter as a
master copy in ``cfg.param_dtype`` (float32, or bf16 for jamba), all
with ``requires_grad``; every use casts to bf16 as serving's storage
does, so the bits at use are serving's.  ``forward_train`` is its
differentiable forward: ``(logits, aux)`` as the JAX package's
``forward`` returns them, each layer rematerialised in the backward
(``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint``
does there: an attention layer runs its forward kernel twice and its
backward kernel once a pass, a Mamba layer the scan's forward kernel
(with chunk states) twice and its backward kernel once.  Serving's
``forward`` and ``decode_step`` stay under ``no_grad``.

MoE layers return their routing beside their output; ``last_aux`` is
the Switch load-balance loss summed over the layers of the last
``run_layers`` call (forward, prefill or decode; None for a model
without MoE layers), where the training step reads it, as the JAX
package's forward returns it.  It is computed from the kept routings
when read, so serving, which never reads it, does not pay for it.

An encoder-decoder config (``is_encoder_decoder``) adds an ``Encoder``
(``n_enc_layers`` of non-causal self-attention and a dense MLP, then its
own final norm) over ``enc_embeds``, and each decoder layer a
``CrossAttention`` over the encoder's output, between its mixer and its
MLP; a front-end config (``frontend="vision"``) takes ``embeds``, placed
before the token embeddings, as the JAX package's ``forward`` does.
Both front ends are stubs there: the caller gives the embeddings.
``forward_train`` takes them too: the encoder's layers run each under
its own remat as the decoder's do, and cross attention's k/v are
projected from the encoder's output in every layer (no cache in
training); its attention runs non-causally at sq = s_dec, sk = s_enc.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .approx_linear import ApproxPolicy
from .attention import (Attention, CrossAttention, attn_param_specs,
                        init_cross_cache, init_kv_cache)
from .common import ParamSpec, init_params, make_rope, rms_norm
from .config import LayerKind, ModelConfig
from .moe import (DenseMLP, MoE, Routing, dense_mlp_param_specs, moe_aux,
                  moe_param_specs)
from .ssm import Mamba, init_mamba_cache, mamba_param_specs

__all__ = ["Encoder", "Layer", "Transformer", "init_caches", "param_specs"]

Caches = List[Dict[str, torch.Tensor]]


def param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Every parameter's ParamSpec under the ``Transformer``'s names, from
    the config alone: no tensor is allocated (``launch.shapes`` reads it
    at full size)."""
    d, v = cfg.d_model, cfg.padded_vocab
    specs: Dict[str, ParamSpec] = {
        "embed": ParamSpec((v, d), logical=("vocab", "embed"))}
    for j, kind in enumerate(k for _ in range(cfg.n_superblocks)
                             for k in cfg.block_pattern):
        mods = [("attn", attn_param_specs(cfg)) if kind.mixer == "attn"
                else ("mamba", mamba_param_specs(cfg))]
        if kind.cross_attn:
            mods.append(("cross", attn_param_specs(cfg)))
        if kind.mlp == "dense":
            mods.append(("mlp", dense_mlp_param_specs(cfg)))
        elif kind.mlp == "moe":
            mods.append(("moe", moe_param_specs(cfg)))
        for mod, mspecs in mods:
            for name, spec in mspecs.items():
                specs[f"layers.{j}.{mod}.{name}"] = spec
    specs["final_norm"] = ParamSpec((d,), init="zeros", logical=("norm",))
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), logical=("embed", "vocab"))
    if cfg.is_encoder_decoder:
        for j in range(cfg.n_enc_layers):
            for mod, mspecs in (("attn", attn_param_specs(cfg)),
                                ("mlp", dense_mlp_param_specs(cfg))):
                for name, spec in mspecs.items():
                    specs[f"encoder.layers.{j}.{mod}.{name}"] = spec
        specs["encoder.final_norm"] = ParamSpec((d,), init="zeros",
                                                logical=("norm",))
    return specs


class Layer(nn.Module):
    """One layer of ``block_pattern``: a mixer (attention or Mamba), an
    encoder-decoder's cross attention where the kind has one, and an
    optional dense MLP or MoE, each a residual branch.  ``forward``
    returns ``(x, routing)``: the MoE's routing, or None."""

    def __init__(self, cfg: ModelConfig, kind: LayerKind,
                 policy: Optional[ApproxPolicy], device,
                 proj_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kind = kind
        if kind.mixer == "attn":
            self.attn = Attention(cfg, policy, device, proj_dtype)
        elif kind.mixer == "mamba":
            self.mamba = Mamba(cfg, policy, device, proj_dtype)
        else:
            raise ValueError(f"unknown mixer {kind.mixer!r}")
        if kind.cross_attn:
            self.cross = CrossAttention(cfg, policy, device, proj_dtype)
        self.mlp = (DenseMLP(cfg, policy, device, proj_dtype)
                    if kind.mlp == "dense" else None)
        if kind.mlp == "moe":
            self.moe = MoE(cfg, device)
        elif kind.mlp not in ("dense", "none"):
            raise ValueError(f"unknown mlp {kind.mlp!r}")

    def forward(self, x, inv_freq, *, cache=None, pos=None, impl="kernel",
                policy=None, enc_out=None):
        if self.kind.mixer == "attn":
            x = x + self.attn(x, inv_freq, cache=cache, pos=pos, impl=impl,
                              policy=policy)
        else:
            x = x + self.mamba(x, cache=cache, decode=pos is not None,
                               impl=impl, policy=policy)
        if self.kind.cross_attn:
            x = x + self.cross(x, enc_out,
                               cache=cache["cross"] if cache is not None
                               else None,
                               pos=pos, impl=impl, policy=policy)
        routing = None
        if self.mlp is not None:
            x = x + self.mlp(x, policy=policy)
        elif self.kind.mlp == "moe":
            y, routing = self.moe(x, policy=policy)
            x = x + y
        return x, routing


class EncoderLayer(nn.Module):
    """One encoder layer: non-causal self-attention (RoPE at positions
    0..s-1), then a dense MLP, each a residual branch."""

    def __init__(self, cfg: ModelConfig, policy: Optional[ApproxPolicy],
                 device, proj_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.attn = Attention(cfg, policy, device, proj_dtype)
        self.mlp = DenseMLP(cfg, policy, device, proj_dtype)

    def forward(self, x, inv_freq, *, impl="kernel", policy=None):
        x = x + self.attn(x, inv_freq, impl=impl, policy=policy,
                          causal=False)
        return x + self.mlp(x, policy=policy)


class Encoder(nn.Module):
    """An encoder-decoder's encoder, as the JAX package's ``encode``:
    ``n_enc_layers`` of ``EncoderLayer`` over the source embeddings (cast
    to bf16), then its own final RMS norm.  Its RoPE rotates the whole
    head dim, whatever the decoder's ``rope_style``."""

    def __init__(self, cfg: ModelConfig, policy: Optional[ApproxPolicy],
                 device, proj_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, policy, device, proj_dtype)
            for _ in range(cfg.n_enc_layers))
        self.final_norm = nn.Parameter(
            torch.empty((cfg.d_model,), dtype=torch.float32, device=device),
            requires_grad=False)
        inv = make_rope(cfg.resolved_head_dim, cfg.rope_theta)
        self.register_buffer("inv_freq", torch.from_numpy(inv).to(device),
                             persistent=False)

    def forward(self, enc_embeds: torch.Tensor, *, impl: str = "kernel",
                policy: Optional[ApproxPolicy] = None) -> torch.Tensor:
        x = enc_embeds.to(torch.bfloat16)
        for layer in self.layers:
            x = layer(x, self.inv_freq, impl=impl, policy=policy)
        return rms_norm(x, self.final_norm, self.cfg.rms_eps)


class Transformer(nn.Module):
    """An LM of a ``ModelConfig``: a decoder stack, with an encoder where
    the config is an encoder-decoder's.  Parameters are allocated
    uninitialised on ``device``; seed them with ``init_weights(seed)`` or
    load a ``state_dict`` (``convert.lm_params_from_numpy``).  Projection
    weights are stored as ``policy`` needs them, or all in ``proj_dtype``
    where given; with ``trainable``, every parameter in
    ``cfg.param_dtype``, with grad."""

    def __init__(self, cfg: ModelConfig, *,
                 policy: Optional[ApproxPolicy] = None, device=None,
                 proj_dtype: Optional[torch.dtype] = None,
                 trainable: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.policy = policy
        d, v = cfg.d_model, cfg.padded_vocab
        # embedding rows and the head are only ever used cast to bf16
        self.embed = nn.Parameter(
            torch.empty((v, d), dtype=torch.bfloat16, device=dev),
            requires_grad=False)
        self.layers = nn.ModuleList(
            Layer(cfg, kind, policy, dev, proj_dtype)
            for _ in range(cfg.n_superblocks) for kind in cfg.block_pattern)
        self.final_norm = nn.Parameter(
            torch.empty((d,), dtype=torch.float32, device=dev),
            requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty((d, v), dtype=torch.bfloat16, device=dev),
                requires_grad=False)
        if cfg.is_encoder_decoder:
            self.encoder = Encoder(cfg, policy, dev, proj_dtype)
        self.trainable = trainable
        if trainable:
            # master weights: re-declared (still uninitialised) in the
            # training dtype
            master = getattr(torch, cfg.param_dtype)
            for mod in self.modules():
                for name, p in list(mod.named_parameters(recurse=False)):
                    setattr(mod, name, nn.Parameter(torch.empty(
                        p.shape, dtype=master, device=dev)))
        self._routings: List[Routing] = []
        inv = make_rope(cfg.resolved_head_dim, cfg.rope_theta,
                        fraction=0.5 if cfg.rope_style == "half" else 1.0)
        self.register_buffer("inv_freq", torch.from_numpy(inv).to(dev),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_specs(self) -> Dict[str, ParamSpec]:
        """Every parameter's ParamSpec, keyed and ordered as
        ``named_parameters``."""
        specs = param_specs(self.cfg)
        return {name: specs[name] for name, _ in self.named_parameters()}

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Transformer":
        """Draw every parameter from one ``torch.Generator`` seeded with
        ``seed``, in place (``common.init_params``)."""
        params = dict(self.named_parameters())
        specs = self.param_specs()
        if list(specs) != list(params):
            raise RuntimeError("parameter specs out of step with the module")
        init_params(specs, seed, self.device, out=params)
        return self

    @property
    def last_aux(self) -> Optional[torch.Tensor]:
        """The load-balance loss of the last ``run_layers`` call, summed
        over its MoE layers (float32), or None without MoE layers."""
        if not self._routings:
            return None
        return sum(moe_aux(r, self.cfg) for r in self._routings)

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    # -- forward pieces ------------------------------------------------------

    def embed_tokens(self, tokens: Optional[torch.Tensor],
                     embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The decoder's input: front-end ``embeds`` (b, f, d) cast to
        bf16, where given, then the tokens' embedding rows; gemma scales
        the whole by sqrt(d), as the JAX package's forward does."""
        parts = []
        if embeds is not None:
            parts.append(embeds.to(device=self.device, dtype=torch.bfloat16))
        if tokens is not None:
            # F.embedding, not indexing: its backward on the card sums a
            # token's rows in a fixed order (indexing's scatters with
            # float atomics), so a training step gives the same bits
            # every run
            parts.append(F.embedding(tokens.long(), self.embed).to(
                torch.bfloat16))
        if not parts:
            raise ValueError("need tokens, embeds or both")
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        if self.cfg.name.startswith("gemma"):
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def encode(self, enc_embeds: Optional[torch.Tensor], *,
               impl: str = "kernel",
               policy: Optional[ApproxPolicy] = None) -> torch.Tensor:
        """The encoder's output (b, s_enc, d) bf16 of an encoder-decoder
        config's source embeddings."""
        if not self.cfg.is_encoder_decoder:
            raise ValueError(f"{self.cfg.name} has no encoder")
        if enc_embeds is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder: pass "
                             "enc_embeds")
        return self.encoder(enc_embeds.to(self.device), impl=impl,
                            policy=policy)

    def run_layers(self, x: torch.Tensor, *, caches: Optional[Caches] = None,
                   pos: Optional[int] = None, impl: str = "kernel",
                   policy: Optional[ApproxPolicy] = None,
                   enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        routings = []
        for j, layer in enumerate(self.layers):
            x, r = layer(x, self.inv_freq,
                         cache=caches[j] if caches is not None else None,
                         pos=pos, impl=impl, policy=policy, enc_out=enc_out)
            if r is not None:
                routings.append(r)
        self._routings = routings
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.rms_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x.to(torch.bfloat16) @ head.to(torch.bfloat16)

    @torch.no_grad()
    def forward(self, tokens: Optional[torch.Tensor], *,
                embeds: Optional[torch.Tensor] = None,
                enc_embeds: Optional[torch.Tensor] = None,
                caches: Optional[Caches] = None,
                impl: str = "kernel",
                policy: Optional[ApproxPolicy] = None) -> torch.Tensor:
        """Teacher-forcing / prefill forward: (b, f + s, padded_vocab)
        bf16 logits of the front-end ``embeds`` (f of them, where given)
        and the tokens.  An encoder-decoder config encodes ``enc_embeds``
        first.  With ``caches``, they are filled with this sequence (and
        the encoder's k/v).  ``policy``, where given, replaces the built
        one for this call (``ApproxPolicy.exact()`` runs every projection
        exact)."""
        enc_out = (self.encode(enc_embeds, impl=impl, policy=policy)
                   if self.cfg.is_encoder_decoder else None)
        x = self.run_layers(self.embed_tokens(tokens, embeds), caches=caches,
                            impl=impl, policy=policy, enc_out=enc_out)
        return self.logits(x)

    def forward_train(self, tokens: Optional[torch.Tensor], *,
                      embeds: Optional[torch.Tensor] = None,
                      enc_embeds: Optional[torch.Tensor] = None,
                      impl: str = "kernel",
                      policy: Optional[ApproxPolicy] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Differentiable teacher-forcing forward: ((b, f + s,
        padded_vocab) bf16 logits, the load-balance loss summed over the
        MoE layers, float32, 0 without them), with ``embeds`` and
        ``enc_embeds`` as ``forward`` takes them.  Each layer, the
        encoder's too, keeps only its inputs for the backward and runs
        again there."""
        enc_out = None
        if self.cfg.is_encoder_decoder:
            if enc_embeds is None:
                raise ValueError(f"{self.cfg.name} is an encoder-decoder: "
                                 "pass enc_embeds")
            enc = self.encoder
            e = enc_embeds.to(device=self.device, dtype=torch.bfloat16)
            for layer in enc.layers:
                e = checkpoint(functools.partial(
                    layer, inv_freq=enc.inv_freq, impl=impl, policy=policy),
                    e, use_reentrant=False)
            enc_out = rms_norm(e, enc.final_norm, self.cfg.rms_eps)
        x = self.embed_tokens(tokens, embeds)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            fn = functools.partial(self._train_layer, layer, impl=impl,
                                   policy=policy)
            x, a = checkpoint(fn, x, enc_out, use_reentrant=False)
            aux = aux + a
        return self.logits(x), aux

    def _train_layer(self, layer: Layer, x: torch.Tensor,
                     enc_out: Optional[torch.Tensor], *, impl: str,
                     policy: Optional[ApproxPolicy]):
        x, r = layer(x, self.inv_freq, impl=impl, policy=policy,
                     enc_out=enc_out)
        if r is None:
            return x, torch.zeros((), dtype=torch.float32, device=x.device)
        return x, moe_aux(r, self.cfg)

    @torch.no_grad()
    def decode_step(self, caches: Caches, tokens: torch.Tensor,
                    pos: int, *,
                    policy: Optional[ApproxPolicy] = None) -> torch.Tensor:
        """One autoregressive step (tokens (b, 1)) at write position
        ``pos`` against preallocated caches: (b, 1, V) logits.  Cross
        attention reads the encoder's k/v that prefill cached.
        ``policy``, where given, replaces the built one for this step."""
        x = self.run_layers(self.embed_tokens(tokens), caches=caches,
                            pos=int(pos), policy=policy)
        return self.logits(x)

    def init_caches(self, batch: int, max_len: int,
                    enc_len: int = 0) -> Caches:
        return init_caches(self.cfg, batch, max_len, self.device, enc_len)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                enc_len: int = 0) -> Caches:
    """One cache dict per layer: attention layers get a bf16 KV cache of
    ``max_len`` positions, Mamba layers a float32 (conv, ssm) state, and
    a layer with cross attention also ``"cross"``, a bf16 k/v of the
    encoder's ``enc_len`` positions (the JAX package's ``cache_specs``)."""
    out: Caches = []
    for _ in range(cfg.n_superblocks):
        for kind in cfg.block_pattern:
            c = (init_kv_cache(cfg, batch, max_len, device)
                 if kind.mixer == "attn"
                 else init_mamba_cache(cfg, batch, device))
            if kind.cross_attn:
                c["cross"] = init_cross_cache(cfg, batch, enc_len, device)
            out.append(c)
    return out

