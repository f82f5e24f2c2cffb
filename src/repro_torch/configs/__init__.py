"""Architecture registry: `get(name)` → ModelConfig; `ARCHES` lists all ids.

Counterpart of src/repro/configs/__init__.py.  All ten configurations are
ported: the dense llama3.2-3b, qwen3-4b, qwen2.5-32b and
deepseek-coder-33b, the vlm backbone llava-next-34b, the moe (MLA + MoE)
deepseek-v2-236b and deepseek-v3-671b, the Mamba1 falcon-mamba-7b, the
Mamba2 hybrid zamba2-1.2b and the encoder-decoder seamless-m4t-large-v2.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHES = [
    "deepseek-coder-33b",
    "qwen3-4b",
    "llama3.2-3b",
    "qwen2.5-32b",
    "seamless-m4t-large-v2",
    "zamba2-1.2b",
    "llava-next-34b",
    "deepseek-v2-236b",
    "deepseek-v3-671b",
    "falcon-mamba-7b",
]

_MODULES = {
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-4b": "qwen3_4b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen2.5-32b": "qwen2_5_32b",
    "llava-next-34b": "llava_next_34b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def get(name: str) -> ModelConfig:
    if name not in ARCHES:
        raise KeyError(f"unknown arch {name!r}; have {ARCHES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
