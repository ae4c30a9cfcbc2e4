"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave (attn at
position 4 of each 8-layer block), MoE 16e top-2 every other layer
[arXiv:2403.19887]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    n_experts=16, n_experts_active=2, moe_period=2,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    attn_period=8, attn_offset=4,
    moment_dtype="bfloat16", param_dtype="bfloat16",
    # 398B: FSDP across pods too (512-way weight sharding) — intra-pod
    # FSDP alone leaves 12.4 GB/chip of optimizer+param state
    sharding_overrides=(("embed", ("data", "pod")),),
    notes="398B params: bf16 master weights + bf16 moments (stochastic-"
          "rounding regime) + cross-pod FSDP to fit 16 GB/chip.",
)
