"""Encoder–decoder LM (seamless-m4t-large-v2 backbone).

Counterpart of src/repro/models/encdec.py.  The audio frontend is a stub,
as in the reference: the encoder takes precomputed frame embeddings (B,
S_enc, D).  The decoder is a causal LM with a cross-attention in every
layer; at prefill the cross K/V are projected once from the encoder memory
and cached, so a decode step touches only its self-attention update and
the cached cross K/V.

Attention dispatch: the encoder's non-causal self-attention, the
decoder's causal self-attention at cache position 0 and the prefill's
cross-attention (Sq decoder positions against Sk encoder positions) go to
`ops.flash_attention`, three launches a layer pair; a decode step runs the
plain `layers.mha` for both of its attentions, as the other families'
decode steps do.  The reference stacks layers and scans them; here layers
are lists, and caches are one dict a decoder layer ({"self": {"k", "v"},
"cross_k", "cross_v"}), updated in place.  `train_loss` waits for
training (ROADMAP.md queue 1 item 15).
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from . import layers as L
from .transformer import Params

TRAINING_ITEM = "ROADMAP.md queue 1 item 15 (LM training)"


def _init_enc_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dev = gen.device
    return {"norm1": L.init_norm(cfg, dev), "attn": L.init_attention(gen, cfg),
            "norm2": L.init_norm(cfg, dev), "mlp": L.init_mlp(gen, cfg)}


def _init_dec_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dev = gen.device
    return {"norm1": L.init_norm(cfg, dev),
            "self_attn": L.init_attention(gen, cfg),
            "norm_x": L.init_norm(cfg, dev),
            "cross_attn": L.init_attention(gen, cfg),
            "norm2": L.init_norm(cfg, dev), "mlp": L.init_mlp(gen, cfg)}


def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Parameters on gen's device with the reference's distributions."""
    return Params({
        "embed": L.init_embedding(gen, cfg),
        "encoder": [_init_enc_layer(gen, cfg)
                    for _ in range(cfg.encoder_layers)],
        "decoder": [_init_dec_layer(gen, cfg) for _ in range(cfg.num_layers)],
        "enc_norm": L.init_norm(cfg, gen.device),
        "final_norm": L.init_norm(cfg, gen.device)})


def _positions(B: int, S: int, base: int, device) -> torch.Tensor:
    return (base + torch.arange(S, device=device)).expand(B, S)


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings → encoder memory."""
    B, S, _ = frames.shape
    pos = _positions(B, S, 0, frames.device)
    x = frames.to(L.pdtype(cfg))
    for lp in params["encoder"]:
        a, _ = L.attention(lp["attn"], L.apply_norm(lp["norm1"], x, cfg),
                           pos, cfg, causal=False)
        x = x + a
        x = x + L.apply_mlp(lp["mlp"], L.apply_norm(lp["norm2"], x, cfg), cfg)
    return L.apply_norm(params["enc_norm"], x, cfg)


def _cross_kv(lp, memory: torch.Tensor, cfg: ModelConfig):
    B, S, _ = memory.shape
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = (memory @ lp["cross_attn"]["wk"]).reshape(B, S, KV, hd)
    v = (memory @ lp["cross_attn"]["wv"]).reshape(B, S, KV, hd)
    return k, v


def _dec_layer(lp, x, pos, cfg: ModelConfig, *, cross_k, cross_v, fresh,
               cache=None, cache_pos: int = 0):
    """One decoder layer; `fresh` cross K/V (just projected from the
    memory, at prefill) go through flash, cached ones through mha."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    h = L.apply_norm(lp["norm1"], x, cfg)
    a, _ = L.attention(lp["self_attn"], h, pos, cfg, cache=cache,
                       cache_pos=cache_pos)
    x = x + a
    h = L.apply_norm(lp["norm_x"], x, cfg)
    q = (h @ lp["cross_attn"]["wq"]).reshape(B, S, H, hd)
    if fresh:
        o = L.flash(q, cross_k, cross_v, causal=False)
    else:
        o = L.mha(q, cross_k, cross_v, causal=False,
                  q_chunk=cfg.attn_q_chunk)
    x = x + o.reshape(B, S, H * hd) @ lp["cross_attn"]["wo"]
    h = L.apply_norm(lp["norm2"], x, cfg)
    return x + L.apply_mlp(lp["mlp"], h, cfg)


def decode_forward(params, tokens: torch.Tensor,
                   memory: torch.Tensor | None, cfg: ModelConfig, *,
                   caches: dict | None = None, cache_pos: int = 0):
    """Decoder pass.  With `memory` the cross K/V are projected from it
    (and written into `caches`); without, they are the cached ones.
    Returns (hidden (B, S, D), caches)."""
    B, S = tokens.shape
    pos = _positions(B, S, cache_pos, tokens.device)
    x = L.embed(params["embed"], tokens, cfg)
    for i, lp in enumerate(params["decoder"]):
        c = None if caches is None else caches["decoder"][i]
        if memory is not None:
            ck, cv = _cross_kv(lp, memory, cfg)
            if c is not None:
                c["cross_k"], c["cross_v"] = ck, cv
        else:
            ck, cv = c["cross_k"], c["cross_v"]
        x = _dec_layer(lp, x, pos, cfg, cross_k=ck, cross_v=cv,
                       fresh=memory is not None,
                       cache=None if c is None else c["self"],
                       cache_pos=cache_pos)
    return L.apply_norm(params["final_norm"], x, cfg), caches


def train_loss(params, batch: dict, cfg: ModelConfig):
    raise NotImplementedError(f"encdec training waits for {TRAINING_ITEM}")


def init_caches(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
                device) -> dict:
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = L.pdtype(cfg)

    def zeros(n):
        return torch.zeros(batch, n, KV, hd, dtype=dt, device=device)
    return {"decoder": [{"self": {"k": zeros(max_len), "v": zeros(max_len)},
                         "cross_k": zeros(enc_len), "cross_v": zeros(enc_len)}
                        for _ in range(cfg.num_layers)]}


def prefill(params, tokens: torch.Tensor, frames: torch.Tensor, caches: dict,
            cfg: ModelConfig):
    """Encode `frames`, fill the caches from the prompt; returns
    (last-position logits, caches)."""
    memory = encode(params, frames, cfg)
    h, caches = decode_forward(params, tokens, memory, cfg, caches=caches,
                               cache_pos=0)
    return L.lm_logits(params["embed"], h[:, -1:], cfg), caches


def decode_step(params, tokens: torch.Tensor, caches: dict, pos: int,
                cfg: ModelConfig):
    """One token step: tokens (B, 1), pos the current length."""
    h, caches = decode_forward(params, tokens, None, cfg, caches=caches,
                               cache_pos=int(pos))
    return L.lm_logits(params["embed"], h, cfg), caches
