"""falcon-mamba-7b [ssm] — pure Mamba-1, attention-free
[arXiv:2410.05355]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    notes="n_heads/n_kv_heads are nominal; no attention layers exist.",
)
