"""Architecture registry: `get(name)` → ModelConfig; `ARCHES` lists all ids.

Counterpart of src/repro/configs/__init__.py.  Two configurations are
ported so far (llama3.2-3b, dense; falcon-mamba-7b, Mamba1); `get` raises
NotImplementedError for the other eight, which wait on the model families
ROADMAP.md queue 1 item 15 lists.
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
    "llama3.2-3b": "llama3_2_3b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}


def get(name: str) -> ModelConfig:
    if name not in ARCHES:
        raise KeyError(f"unknown arch {name!r}; have {ARCHES}")
    if name not in _MODULES:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md queue 1 item 15); "
            f"ported: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
