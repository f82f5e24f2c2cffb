"""qwen3-4b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

Copy of src/repro/configs/qwen3_4b.py."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=9728, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
)
