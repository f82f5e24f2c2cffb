"""LM models of the port: configuration, layers, MLA and MoE, Mamba1 and
Mamba2, decoder-only and encoder-decoder assembly."""
from .config import ModelConfig, MoEConfig, MLAConfig, SSMConfig, smoke_config
from .registry import build, Model

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "smoke_config", "build", "Model"]
