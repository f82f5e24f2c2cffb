"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attn block
[arXiv:2411.15242; hf].  38 mamba2 layers; one shared-weight transformer
block applied every 6 layers (6 applications; 2 trailing mamba layers).

Copy of src/repro/configs/zamba2_1_2b.py."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=8192, vocab_size=32000,
    ssm=SSMConfig(version=2, state_dim=64, conv_dim=4, expand=2,
                  head_dim=64, chunk=256, attn_every=6),
    subquadratic=True,
)
