"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].
Backbone only; the audio frontend is a stub (input_specs provides
precomputed frame embeddings).

Copy of src/repro/configs/seamless_m4t_large_v2.py."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, encoder_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, head_dim=64, d_ff=8192, vocab_size=256206,
    mlp_type="gelu", norm_type="layernorm",
    frontend="frames",
)
