"""Decoder-only LM assembly: per-layer blocks, caches, prefill and decode.

Counterpart of src/repro/models/transformer.py for the dense, vlm and ssm
(Mamba1) families; moe, hybrid, MLA and MTP raise NotImplementedError
(ROADMAP.md queue 1 item 15).  The reference stacks the layers and drives
them with `lax.scan` under remat; here each layer is its own module in an
`nn.ModuleList` and a Python loop applies them (remat has no meaning in
inference).  Caches are one dict a layer, updated in place and returned.
`forward` returns (hidden, caches): the reference's third value, the MoE
auxiliary loss, is always 0 without MoE.
"""
from __future__ import annotations

import torch
from torch import nn

from .config import ModelConfig
from . import layers as L
from . import ssm as SSM


class Params(nn.Module):
    """A nested mapping of parameters as a module, read like the
    reference's pytree: ``p["blocks"][i]["attn"]["wq"]``.  Dicts become
    submodules, lists `nn.ModuleList`s and tensors frozen parameters."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, Params(v))
            elif isinstance(v, list):
                self.add_module(name, nn.ModuleList(Params(e) for e in v))
            else:
                self.register_parameter(name, nn.Parameter(
                    v, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def _unsupported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue 1 "
            "item 15); ported: dense, vlm, ssm")
    if cfg.mla or cfg.moe or cfg.mtp_depth:
        raise NotImplementedError("MLA, MoE and MTP are not ported yet "
                                  "(ROADMAP.md queue 1 item 15)")
    if cfg.family == "ssm" and cfg.ssm.version != 1:
        raise NotImplementedError("Mamba2 is not ported yet (ROADMAP.md "
                                  "queue 1 item 15)")


# ---------------------------------------------------------- layer kinds ----
def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    """kind ∈ {dense, mamba1}."""
    dev = gen.device
    if kind == "dense":
        return {"norm1": L.init_norm(cfg, dev),
                "attn": L.init_attention(gen, cfg),
                "norm2": L.init_norm(cfg, dev),
                "ffn": L.init_mlp(gen, cfg)}
    if kind == "mamba1":
        return {"norm1": L.init_norm(cfg, dev),
                "mixer": SSM.init_mamba1(gen, cfg)}
    raise ValueError(kind)


def apply_block(p, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                kind: str, *, cache=None, cache_pos: int = 0):
    """Returns (x, cache)."""
    if kind == "dense":
        a, cache = L.attention(p["attn"], L.apply_norm(p["norm1"], x, cfg),
                               pos, cfg, cache=cache, cache_pos=cache_pos)
        x = x + a
        return x + L.apply_mlp(p["ffn"], L.apply_norm(p["norm2"], x, cfg),
                               cfg), cache
    if kind == "mamba1":
        a, cache = SSM.mamba1_block(p["mixer"],
                                    L.apply_norm(p["norm1"], x, cfg), cfg,
                                    cache=cache)
        return x + a, cache
    raise ValueError(kind)


def block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                device) -> dict:
    if kind == "dense":
        return L.init_attention_cache(cfg, batch, max_len, device)
    if kind == "mamba1":
        return SSM.init_mamba1_cache(cfg, batch, device)
    raise ValueError(kind)


# ------------------------------------------------------------ structure ----
def lm_structure(cfg: ModelConfig) -> list[tuple[str, int, str]]:
    """[(stack_name, n_layers, kind)] per family."""
    _unsupported(cfg)
    kind = "mamba1" if cfg.family == "ssm" else "dense"
    return [("blocks", cfg.num_layers, kind)]


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Parameters on gen's device, drawn from `gen` with the reference's
    initial distributions."""
    tree = {"embed": L.init_embedding(gen, cfg),
            "final_norm": L.init_norm(cfg, gen.device)}
    for name, n, kind in lm_structure(cfg):
        tree[name] = [init_block(gen, cfg, kind) for _ in range(n)]
    return Params(tree)


# ------------------------------------------------------------- forward -----
def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            frontend_embeds: torch.Tensor | None = None,
            caches: dict | None = None, cache_pos: int = 0):
    """Full forward.  Returns (hidden (B, S, D), caches)."""
    B, S = tokens.shape
    pos = (cache_pos + torch.arange(S, device=tokens.device)).expand(B, S)
    x = L.embed(params["embed"], tokens, cfg, frontend_embeds)
    for name, _, kind in lm_structure(cfg):
        layer_caches = caches[name] if caches is not None else None
        for i, lp in enumerate(params[name]):
            x, _ = apply_block(
                lp, x, pos, cfg, kind, cache_pos=cache_pos,
                cache=None if layer_caches is None else layer_caches[i])
    return L.apply_norm(params["final_norm"], x, cfg), caches


# ------------------------------------------------------------- serving -----
def init_caches(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    return {name: [block_cache(cfg, kind, batch, max_len, device)
                   for _ in range(n)]
            for name, n, kind in lm_structure(cfg)}


def prefill(params, tokens: torch.Tensor, caches: dict, cfg: ModelConfig, *,
            frontend_embeds: torch.Tensor | None = None):
    """Fill caches from a prompt; returns (last-position logits, caches)."""
    h, caches = forward(params, tokens, cfg, frontend_embeds=frontend_embeds,
                        caches=caches, cache_pos=0)
    return L.lm_logits(params["embed"], h[:, -1:], cfg), caches


def decode_step(params, tokens: torch.Tensor, caches: dict, pos: int,
                cfg: ModelConfig):
    """One token step: tokens (B, 1), pos the current length."""
    h, caches = forward(params, tokens, cfg, caches=caches, cache_pos=int(pos))
    return L.lm_logits(params["embed"], h, cfg), caches
