"""Model configuration — one dataclass family covers all 10 assigned
architectures (dense GQA / enc-dec / hybrid / MoE+MLA / SSM / VLM-backbone).

Copy of src/repro/models/config.py.  The port runs all six families; the
sharding, remat and scan levers (and `ssm.chunk`: the port's scan walks S
in order) have no effect in it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    first_k_dense: int = 1          # leading dense layers (DeepSeek style)
    dense_d_ff: int | None = None   # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int | None = None  # None → full-rank Q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    version: Literal[1, 2] = 1
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    head_dim: int = 64              # mamba2 only
    dt_rank: int | None = None      # mamba1 only; None → ceil(d_model/16)
    chunk: int = 256                # scan chunk length
    attn_every: int = 0             # hybrid: shared attn block period (0=off)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "encdec", "hybrid", "moe", "ssm", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None     # None → d_model // num_heads
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # families
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    encoder_layers: int = 0
    mtp_depth: int = 0              # multi-token prediction heads (DeepSeek-V3)
    # frontend stubs ([audio]/[vlm]): input_specs provide embeddings directly
    frontend: Literal[None, "patches", "frames"] = None
    frontend_len: int = 576         # patches/frames consumed per example
    # layer flavors
    mlp_type: Literal["swiglu", "gelu"] = "swiglu"
    norm_type: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    # numerics / memory
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: Literal["none", "dots", "full"] = "full"
    scan_unroll: bool = False       # python-loop layers (cost-model lowers)
    attn_q_chunk: int = 1024        # query-chunked attention block (0=off)
    mla_decode_mode: Literal["absorbed", "materialize"] = "absorbed"
    # §Perf hillclimb levers (default off = faithful baseline)
    attn_kv_pregather: bool = False  # gather K/V once before the q-chunk loop
    moe_2d: bool = False             # F-sharded expert compute (no FSDP re-gather)
    ssm_shard_scan: bool = False     # constrain SSM scan intermediates to TP
    ssm_scan_dtype: str = "float32"  # bf16 halves the scan's HBM traffic
    tie_embeddings: bool = False
    # long-context attention capability (sub-quadratic): SSM/hybrid only
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return replace(self, **kw)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config: few layers, narrow width, small vocab."""
    kw = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.family in ("hybrid",) else 2),
        d_model=128,
        num_heads=4, num_kv_heads=min(4, max(1, cfg.num_kv_heads)),
        head_dim=32,
        d_ff=256, vocab_size=512, dtype="float32", remat="none",
        frontend_len=8,
    )
    if cfg.moe:
        # capacity_factor high enough to avoid dropping: keeps the cached
        # decode path bit-identical to the full forward in tests.
        kw["moe"] = replace(cfg.moe, num_experts=8, top_k=2, d_ff_expert=64,
                            dense_d_ff=256, first_k_dense=1,
                            capacity_factor=8.0)
    if cfg.mla:
        kw["mla"] = replace(cfg.mla, kv_lora_rank=64,
                            q_lora_rank=64 if cfg.mla.q_lora_rank else None,
                            qk_nope_head_dim=32, qk_rope_head_dim=16,
                            v_head_dim=32)
    if cfg.ssm:
        kw["ssm"] = replace(cfg.ssm, state_dim=16, head_dim=16, chunk=16,
                            dt_rank=8 if cfg.ssm.version == 1 else None,
                            attn_every=2 if cfg.ssm.attn_every else 0)
        kw["num_layers"] = 4
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.mtp_depth:
        kw["mtp_depth"] = 1
    return cfg.scaled(**kw)
