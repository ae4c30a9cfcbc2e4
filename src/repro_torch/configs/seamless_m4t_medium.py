"""seamless-m4t-medium [audio] — encoder-decoder backbone; the speech
frontend is a STUB: input_specs() provides precomputed frame embeddings
(assignment brief) [arXiv:2308.11596]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    is_encoder_decoder=True, n_enc_layers=12,
    frontend="audio",
    notes="12L decoder + 12L encoder; decode shapes lower the decoder "
          "step against a fixed-length encoder context.",
)
