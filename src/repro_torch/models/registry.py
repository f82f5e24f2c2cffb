"""Uniform model interface over all ten ported families.

Counterpart of src/repro/models/registry.py.  `build(cfg, device=...)`
binds the functions of `transformer` (dense, vlm, moe, ssm, hybrid) or
`encdec` to one configuration and one device; the reference's `specs`
and `train_loss` wait for sharding and training.  An encdec model's
`init_caches(batch, max_len, enc_len=None)` sizes the cross K/V for
`enc_len` encoder positions (default `max_len`, as in the reference), and
its prefill reads `batch["frontend_embeds"]`, the encoder's frames.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.distmat.types import resolve_device
from .config import ModelConfig
from . import encdec as ED
from . import transformer as TF


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable                    # generator -> params (TF.Params)
    init_caches: Callable             # (batch, max_len[, enc_len]) -> caches
    prefill: Callable                 # (params, batch, caches) -> (logits, caches)
    decode_step: Callable             # (params, tokens, caches, pos) -> ...


def build(cfg: ModelConfig, device="cuda") -> Model:
    """The model for `cfg` on `device` (default the card; raises when there
    is none)."""
    if cfg.family != "encdec":
        TF.lm_structure(cfg)           # raises for an unknown family
    dev = resolve_device(device)

    def init(gen: torch.Generator) -> TF.Params:
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        if cfg.family == "encdec":
            return ED.init_encdec(gen, cfg)
        return TF.init_lm(gen, cfg)

    if cfg.family == "encdec":
        return Model(
            cfg=cfg, device=dev, init=init,
            init_caches=lambda batch, max_len, enc_len=None: ED.init_caches(
                cfg, batch, max_len, enc_len or max_len, dev),
            prefill=lambda p, batch, caches: ED.prefill(
                p, batch["tokens"], batch["frontend_embeds"], caches, cfg),
            decode_step=lambda p, t, c, pos: ED.decode_step(p, t, c, pos,
                                                            cfg))

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
