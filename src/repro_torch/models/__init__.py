"""LM models of the port: configuration, layers, Mamba1, assembly."""
from .config import ModelConfig, MoEConfig, MLAConfig, SSMConfig, smoke_config
from .registry import build, Model

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "smoke_config", "build", "Model"]
