"""llava-next-34b [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].  Backbone only; the
vision tower is a stub (input_specs provides anyres patch embeddings that
occupy the leading positions).

Copy of src/repro/configs/llava_next_34b.py."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=20480, vocab_size=64000,
    rope_theta=5e6,
    frontend="patches", frontend_len=2880,   # anyres: 5 tiles x 576
)
