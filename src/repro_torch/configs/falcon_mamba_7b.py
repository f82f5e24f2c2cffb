"""falcon-mamba-7b [ssm] — mamba1 arch, attention-free
[arXiv:2410.05355; unverified].

Copy of src/repro/configs/falcon_mamba_7b.py."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=65024,
    ssm=SSMConfig(version=1, state_dim=16, conv_dim=4, expand=2,
                  dt_rank=256, chunk=256),
    subquadratic=True,
)
