"""granite-moe-3b-a800m [moe] — 40 experts top-8 (padded to 48 for 16-way
EP divisibility; pads masked out of routing)
[hf:ibm-granite/granite-3.0-*-base]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    n_experts=40, n_experts_active=8, moe_period=1,
)
