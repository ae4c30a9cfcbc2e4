"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution; the vision frontend is
a STUB: input_specs() provides precomputed patch embeddings prepended to
the text sequence [arXiv:2409.12191]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    rope_style="mrope", frontend="vision", frontend_len=256,
    notes="M-RoPE stub: temporal/h/w position ids collapse to text "
          "positions for the backbone dry-run (DESIGN.md).",
)
