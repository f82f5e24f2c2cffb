"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf].

Copy of src/repro/configs/deepseek_v3_671b.py."""
from repro_torch.models.config import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    head_dim=128, d_ff=2048, vocab_size=129280,
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, first_k_dense=3,
                  dense_d_ff=18432),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    mtp_depth=1,
)
