"""Decoder-only LM assembly: per-layer blocks, caches, prefill and decode.

Counterpart of src/repro/models/transformer.py for the dense, vlm, moe
(DeepSeek: MLA attention, a dense prefix then MoE FFN layers, MTP
weights), ssm (Mamba1) and hybrid (zamba2: Mamba2 layers in groups of
`attn_every`, each group led by one shared-weight attention block with
its own KV cache, then a tail of the remaining Mamba2 layers) families;
the encdec family is models/encdec.py.  The reference stacks the layers
and drives them with `lax.scan` under remat; here each layer is its own
module in an `nn.ModuleList` and a Python loop applies them (remat has no
meaning in inference).  Caches are one dict a layer (a hybrid group's:
{"attn": its attention cache, "mamba": [one a Mamba2 layer]}), updated in
place and returned.  `forward` returns (hidden, caches) and drops the
reference's third value, the MoE auxiliary loss (`moe.apply_moe` returns
it; serving never reads it).  The MTP block's weights are made and carried
(`init_lm`); the reference runs them only in `train_loss`, which waits for
training.
"""
from __future__ import annotations

import torch
from torch import nn

from .config import ModelConfig
from . import layers as L
from . import mla as MLA
from . import moe as MOE
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


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid"):
        raise ValueError(f"family {cfg.family!r} is not a decoder-only "
                         "family (encdec: models/encdec.py)")
    if cfg.family == "moe" and cfg.moe is None:
        raise ValueError("family 'moe' needs cfg.moe")
    if cfg.family in ("ssm", "hybrid") and cfg.ssm is None:
        raise ValueError(f"family {cfg.family!r} needs cfg.ssm")


# ---------------------------------------------------------- layer kinds ----
def _init_attn(gen: torch.Generator, cfg: ModelConfig) -> dict:
    if cfg.mla:
        return MLA.init_mla(gen, cfg)
    return L.init_attention(gen, cfg)


def _apply_attn(p, x, pos, cfg: ModelConfig, cache=None, cache_pos: int = 0):
    if cfg.mla:
        return MLA.mla_attention(p, x, pos, cfg, cache=cache,
                                 cache_pos=cache_pos,
                                 decode_mode=cfg.mla_decode_mode)
    return L.attention(p, x, pos, cfg, cache=cache, cache_pos=cache_pos)


def _attn_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    if cfg.mla:
        return MLA.init_mla_cache(cfg, batch, max_len, device)
    return L.init_attention_cache(cfg, batch, max_len, device)


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    """kind ∈ {dense, moe_ffn, mamba1, mamba2}."""
    dev = gen.device
    if kind in ("dense", "moe_ffn"):
        p = {"norm1": L.init_norm(cfg, dev), "attn": _init_attn(gen, cfg),
             "norm2": L.init_norm(cfg, dev)}
        if kind == "moe_ffn":
            p["ffn"] = MOE.init_moe(gen, cfg)
        else:
            d_ff = (cfg.moe.dense_d_ff or cfg.d_ff) if cfg.moe else cfg.d_ff
            p["ffn"] = L.init_mlp(gen, cfg, d_ff=d_ff)
        return p
    if kind in ("mamba1", "mamba2"):
        init = SSM.init_mamba1 if kind == "mamba1" else SSM.init_mamba2
        return {"norm1": L.init_norm(cfg, dev), "mixer": init(gen, cfg)}
    raise ValueError(kind)


def apply_block(p, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                kind: str, *, cache=None, cache_pos: int = 0):
    """Returns (x, cache); a moe_ffn block's auxiliary loss is dropped."""
    if kind in ("dense", "moe_ffn"):
        a, cache = _apply_attn(p["attn"], L.apply_norm(p["norm1"], x, cfg),
                               pos, cfg, cache=cache, cache_pos=cache_pos)
        x = x + a
        h = L.apply_norm(p["norm2"], x, cfg)
        if kind == "moe_ffn":
            return x + MOE.apply_moe(p["ffn"], h, cfg)[0], cache
        return x + L.apply_mlp(p["ffn"], h, cfg), cache
    if kind in ("mamba1", "mamba2"):
        fn = SSM.mamba1_block if kind == "mamba1" else SSM.mamba2_block
        a, cache = fn(p["mixer"], L.apply_norm(p["norm1"], x, cfg), cfg,
                      cache=cache)
        return x + a, cache
    raise ValueError(kind)


def block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                device) -> dict:
    if kind in ("dense", "moe_ffn"):
        return _attn_cache(cfg, batch, max_len, device)
    if kind == "mamba1":
        return SSM.init_mamba1_cache(cfg, batch, device)
    if kind == "mamba2":
        return SSM.init_mamba2_cache(cfg, batch, device)
    if kind == "hybrid_group":
        return {"attn": block_cache(cfg, "dense", batch, max_len, device),
                "mamba": [SSM.init_mamba2_cache(cfg, batch, device)
                          for _ in range(cfg.ssm.attn_every)]}
    raise ValueError(kind)


# ------------------------------------------------------------ structure ----
def lm_structure(cfg: ModelConfig) -> list[tuple[str, int, str]]:
    """[(stack_name, n_layers, kind)] per family; a hybrid_group entry
    counts groups of `attn_every` Mamba2 layers."""
    _check_family(cfg)
    if cfg.family == "moe":
        fk = cfg.moe.first_k_dense
        return [("dense_prefix", fk, "dense"),
                ("moe_blocks", cfg.num_layers - fk, "moe_ffn")]
    if cfg.family == "hybrid":
        per = cfg.ssm.attn_every or cfg.num_layers
        out = [("groups", cfg.num_layers // per, "hybrid_group")]
        if cfg.num_layers % per:
            out.append(("tail", cfg.num_layers % per, "mamba2"))
        return out
    kind = "mamba1" if cfg.family == "ssm" else "dense"
    return [("blocks", cfg.num_layers, kind)]


def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    """One entry of a stack: a block, or a hybrid group's Mamba2 layers
    (the shared attention block lives outside the groups)."""
    if kind == "hybrid_group":
        return {"mamba": [init_block(gen, cfg, "mamba2")
                          for _ in range(cfg.ssm.attn_every)]}
    return init_block(gen, cfg, kind)


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Parameters on gen's device, drawn from `gen` with the reference's
    initial distributions; with mtp_depth, the MTP block ("mtp": proj
    (2d, d), block, norm) as well, and for hybrid the shared attention
    block ("shared_attn", one dense block)."""
    tree = {"embed": L.init_embedding(gen, cfg),
            "final_norm": L.init_norm(cfg, gen.device)}
    for name, n, kind in lm_structure(cfg):
        tree[name] = [_init_layer(gen, cfg, kind) for _ in range(n)]
    if cfg.family == "hybrid":
        tree["shared_attn"] = init_block(gen, cfg, "dense")
    if cfg.mtp_depth:
        block = init_block(gen, cfg, "moe_ffn" if cfg.moe else "dense")
        tree["mtp"] = {"proj": L._dense_init(gen, (2 * cfg.d_model,
                                                   cfg.d_model),
                                             L.pdtype(cfg)),
                       "block": block, "norm": L.init_norm(cfg, gen.device)}
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
            c = None if layer_caches is None else layer_caches[i]
            if kind == "hybrid_group":
                x = _apply_group(lp, params["shared_attn"], x, pos, cfg, c,
                                 cache_pos)
            else:
                x, _ = apply_block(lp, x, pos, cfg, kind, cache=c,
                                   cache_pos=cache_pos)
    return L.apply_norm(params["final_norm"], x, cfg), caches


def _apply_group(gp, shared, x, pos, cfg: ModelConfig, cache, cache_pos):
    """One zamba2 group (the reference's _scan_hybrid body): the shared
    attention block with this group's attention cache, then the group's
    Mamba2 layers."""
    x, _ = apply_block(shared, x, pos, cfg, "dense", cache_pos=cache_pos,
                       cache=None if cache is None else cache["attn"])
    for j, lp in enumerate(gp["mamba"]):
        x, _ = apply_block(lp, x, pos, cfg, "mamba2",
                           cache=None if cache is None else cache["mamba"][j])
    return x


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
