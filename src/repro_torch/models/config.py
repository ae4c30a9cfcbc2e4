"""ModelConfig — one dataclass covering all assigned architecture families
(dense / MoE / enc-dec / SSM / hybrid / VLM-audio-backbone).

A copy of the JAX package's ``models/config.py`` (pure Python).  Layers
are organized as repeated *super-blocks*: ``block_pattern`` describes
the layers inside one super-block, and the stack is ``n_layers /
len(block_pattern)`` of them.  The port builds the stack as a flat
``nn.ModuleList`` of ``n_layers`` layers, super-block-major.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

__all__ = ["LayerKind", "ModelConfig", "reduced"]


@dataclass(frozen=True)
class LayerKind:
    mixer: str = "attn"        # "attn" | "mamba"
    mlp: str = "dense"         # "dense" | "moe" | "none"
    cross_attn: bool = False   # decoder cross-attention (enc-dec)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | encdec | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None            # default d_model // n_heads
    # --- normalization / activations ---
    mlp_act: str = "silu"                     # silu->SwiGLU, gelu->GeGLU
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- rope ---
    rope_theta: float = 10000.0
    rope_style: str = "standard"              # standard | half (chatglm 2d) | mrope
    # --- MoE ---
    n_experts: int = 0
    n_experts_active: int = 0
    moe_period: int = 1                       # MoE every `moe_period` layers
    capacity_factor: float = 1.25
    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                          # default ceil(d_model/16)
    attn_period: int = 0                      # hybrid: 1 attn per N layers
    attn_offset: int = 4                      # position of attn in the block
    # --- enc-dec ---
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    # --- frontend stub ---
    frontend: str = "none"                    # none | audio | vision
    frontend_len: int = 0                     # embeddings prepended (vlm)
    # --- numerics / training ---
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"              # master weights
    moment_dtype: str = "float32"             # Adam moments
    # --- sharding rule overrides (kept for parity; the port has no mesh) ---
    sharding_overrides: Tuple[Tuple[str, object], ...] = ()
    # --- notes carried into DESIGN/EXPERIMENTS ---
    notes: str = ""

    @property
    def sharding_rules(self) -> Dict[str, object]:
        return dict(self.sharding_overrides)

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 256) * 256

    @property
    def padded_experts(self) -> int:
        """Experts padded to 16-way EP divisibility (e.g. granite-moe
        40 -> 48; padded experts are masked out of routing).  Small expert
        counts (<=16) are left unpadded and replicate under the fallback
        rule when they don't divide the model axis."""
        if self.n_experts > 16:
            return -(-self.n_experts // 16) * 16
        return self.n_experts

    @property
    def block_pattern(self) -> Tuple[LayerKind, ...]:
        """Layer kinds inside one super-block."""
        if self.family == "ssm":
            return (LayerKind(mixer="mamba", mlp="none"),)
        if self.family == "hybrid":
            period = self.attn_period or 8
            kinds = []
            for i in range(period):
                mixer = "attn" if i == (self.attn_offset % period) else "mamba"
                mlp = (
                    "moe"
                    if self.n_experts and i % self.moe_period == self.moe_period - 1
                    else "dense"
                )
                kinds.append(LayerKind(mixer=mixer, mlp=mlp))
            return tuple(kinds)
        mlp = "moe" if self.n_experts else "dense"
        xattn = self.is_encoder_decoder
        if self.n_experts and self.moe_period > 1:
            kinds = [
                LayerKind(
                    mlp="moe" if i % self.moe_period else "dense",
                    cross_attn=xattn,
                )
                for i in range(self.moe_period)
            ]
            return tuple(kinds)
        return (LayerKind(mlp=mlp, cross_attn=xattn),)

    @property
    def n_superblocks(self) -> int:
        p = len(self.block_pattern)
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        return self.n_layers // p

    @property
    def is_attention_free(self) -> bool:
        return all(k.mixer != "attn" for k in self.block_pattern)

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for SSM/hybrid archs (assignment brief)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate dense parameter count (embeddings included)."""
        d, ff, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        total = v * d * (1 if self.tie_embeddings else 2)
        for kind in self.block_pattern:
            n = self.n_superblocks
            if kind.mixer == "attn":
                total += n * d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
            else:
                di, st, dtr = self.d_inner, self.ssm_state, self.resolved_dt_rank
                total += n * (
                    d * 2 * di + di * self.ssm_conv + di * (dtr + 2 * st)
                    + dtr * di + di * st + di + di * d
                )
            if kind.cross_attn:
                total += n * d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
            if kind.mlp == "dense":
                total += n * 3 * d * ff
            elif kind.mlp == "moe":
                total += n * (self.n_experts * 3 * d * ff + d * self.n_experts)
        if self.is_encoder_decoder:
            # encoder layers mirror the decoder's self-attn + mlp
            total += self.n_enc_layers * (
                d * hd * (self.n_heads * 2 + self.n_kv_heads * 2) + 3 * d * ff
            )
        return int(total)

    def active_param_count(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6*N_active*D)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(
            1 for k in self.block_pattern if k.mlp == "moe"
        ) * self.n_superblocks
        inactive = (
            moe_layers
            * (self.n_experts - self.n_experts_active)
            * 3 * self.d_model * self.d_ff
        )
        return int(full - inactive)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A small same-family config for CPU smoke tests."""
    pattern = len(cfg.block_pattern)
    defaults = dict(
        n_layers=pattern * (2 if pattern > 1 else 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        n_experts_active=min(cfg.n_experts_active, 2) if cfg.n_experts else 0,
        n_enc_layers=2 if cfg.is_encoder_decoder else 0,
        dt_rank=8 if cfg.family in ("ssm", "hybrid") else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        frontend_len=min(cfg.frontend_len, 8) if cfg.frontend_len else 0,
        name=cfg.name + "-smoke",
    )
    defaults.update(overrides)
    return replace(cfg, **defaults)
