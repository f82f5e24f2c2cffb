"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

Copy of src/repro/configs/deepseek_v2_236b.py."""
from repro_torch.models.config import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    head_dim=128, d_ff=1536, vocab_size=102400,
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                  num_shared_experts=2, first_k_dense=1,
                  dense_d_ff=12288),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
)
