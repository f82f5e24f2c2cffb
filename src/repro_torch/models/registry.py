"""Uniform model interface over the ported decoder-only families.

Counterpart of src/repro/models/registry.py.  `build(cfg, device=...)`
binds the functions of `transformer` to one configuration and one device
(the dense, vlm, moe and Mamba1 families); the reference's `specs` and
`train_loss` wait for sharding and training, and the encdec and hybrid
families raise (ROADMAP.md queue 1 item 15).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.distmat.types import resolve_device
from .config import ModelConfig
from . import transformer as TF


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable                    # generator -> params (TF.Params)
    init_caches: Callable             # (batch, max_len) -> caches
    prefill: Callable                 # (params, batch, caches) -> (logits, caches)
    decode_step: Callable             # (params, tokens, caches, pos) -> ...


def build(cfg: ModelConfig, device="cuda") -> Model:
    """The model for `cfg` on `device` (default the card; raises when there
    is none)."""
    if cfg.family == "encdec":
        raise NotImplementedError("the encdec family is not ported yet "
                                  "(ROADMAP.md queue 1 item 15)")
    TF.lm_structure(cfg)               # raises for what is not ported
    dev = resolve_device(device)

    def init(gen: torch.Generator) -> TF.Params:
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        return TF.init_lm(gen, cfg)

    def prefill(params, batch, caches):
        return TF.prefill(params, batch["tokens"], caches, cfg,
                          frontend_embeds=batch.get("frontend_embeds"))

    return Model(
        cfg=cfg, device=dev, init=init,
        init_caches=lambda batch, max_len: TF.init_caches(cfg, batch,
                                                          max_len, dev),
        prefill=prefill,
        decode_step=lambda p, t, c, pos: TF.decode_step(p, t, c, pos, cfg),
    )
