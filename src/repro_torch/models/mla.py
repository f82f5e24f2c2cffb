"""Multi-head Latent Attention (DeepSeek V2/V3).

Counterpart of src/repro/models/mla.py.  The KV path is a low-rank
factorization: W_DKV (d_model → kv_lora_rank) with per-head
up-projections W_UK and W_UV, so the cache holds the latent c_kv (B, T, r)
and one shared rotary key k_r (B, T, r_rope) a position, not H heads of
keys and values.

Prefill (the first query at position 0, with or without a cache) takes the
materialized form through ``ops.flash_attention``: q = [q_nope, q_rope] a
head, k = [c_kv W_UK, k_r broadcast over the heads], so the head dim is
D = qk_nope_head_dim + qk_rope_head_dim (192 for DeepSeek), and
v = c_kv W_UV zero-padded from v_head_dim to D (the kernel has one D for
q, k and v, as the TPU kernel does); the scale is 1/√D and the output's
first v_head_dim columns are kept.  That is the reference's prefill up to
rounding: its absorbed mode folds W_UK into the query and W_UV into the
output, its materialize mode forms the same k and v, and at offset 0 the
causal mask hides every cache slot at or past S.  Decode steps (and
prompts continued at an offset > 0) are plain torch over the whole cache
with its validity mask, in ``cfg.mla_decode_mode`` exactly as the
reference: absorbed (attention against the rank-r latent cache) or
materialize (K and V rebuilt for every cached position each step); the
plain path chunks the queries by ``attn_q_chunk`` as the reference does.
Caches are written in place at cache_pos.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .config import ModelConfig
from .layers import _dense_init, apply_rope, pdtype


def init_mla(gen: torch.Generator, cfg: ModelConfig) -> dict:
    c = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk_head = c.qk_nope_head_dim + c.qk_rope_head_dim
    dt, dev = pdtype(cfg), gen.device
    p = {}
    if c.q_lora_rank:
        p |= {"w_dq": _dense_init(gen, (d, c.q_lora_rank), dt),
              "q_norm": torch.ones(c.q_lora_rank, device=dev),
              "w_uq": _dense_init(gen, (c.q_lora_rank, H * qk_head), dt)}
    else:
        p["w_q"] = _dense_init(gen, (d, H * qk_head), dt)
    p |= {"w_dkv": _dense_init(gen, (d, c.kv_lora_rank), dt),
          "kv_norm": torch.ones(c.kv_lora_rank, device=dev),
          "w_kr": _dense_init(gen, (d, c.qk_rope_head_dim), dt),
          "w_uk": _dense_init(gen, (c.kv_lora_rank,
                                    H * c.qk_nope_head_dim), dt),
          "w_uv": _dense_init(gen, (c.kv_lora_rank, H * c.v_head_dim), dt),
          "wo": _dense_init(gen, (H * c.v_head_dim, d), dt)}
    return p


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
            * scale).to(x.dtype)


def _queries(p, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    c = cfg.mla
    B, S, _ = x.shape
    qk_head = c.qk_nope_head_dim + c.qk_rope_head_dim
    if c.q_lora_rank:
        q = _rms(x @ p["w_dq"], p["q_norm"], cfg.norm_eps) @ p["w_uq"]
    else:
        q = x @ p["w_q"]
    q = q.reshape(B, S, cfg.num_heads, qk_head)
    return (q[..., :c.qk_nope_head_dim],
            apply_rope(q[..., c.qk_nope_head_dim:], pos, cfg.rope_theta))


def _latents(p, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    """The tall-skinny KV path: (B, S, r) latent + (B, S, r_rope) shared
    key."""
    ckv = _rms(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    kr = apply_rope((x @ p["w_kr"])[:, :, None, :], pos,
                    cfg.rope_theta)[:, :, 0]
    return ckv, kr


def _materialized(p, q_nope, q_rope, ckv, kr, cfg: ModelConfig):
    """q, k, v (B, H, S, D) of the materialized form, as views: the rotary
    key broadcast over the heads, and whichever of q·k's width and v's is
    narrower zero-padded to the wider (zero columns change neither q·k nor
    the kept output)."""
    c = cfg.mla
    B, S, H, _ = q_nope.shape
    k_nope = (ckv @ p["w_uk"]).reshape(B, S, H, c.qk_nope_head_dim)
    v = (ckv @ p["w_uv"]).reshape(B, S, H, c.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, -1)], -1)
    D = max(q.shape[-1], c.v_head_dim)
    q, k, v = (F.pad(t, (0, D - t.shape[-1])) if t.shape[-1] < D else t
               for t in (q, k, v))
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def flash_inputs(p, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    """The prefill's q, k, v (B, H, S, D) for hidden states x (B, S, d),
    as ``mla_attention`` gives them to ``ops.flash_attention``, and the
    scale 1/√(qk_nope_head_dim + qk_rope_head_dim)."""
    q_nope, q_rope = _queries(p, x, pos, cfg)
    ckv, kr = _latents(p, x, pos, cfg)
    return _materialized(p, q_nope, q_rope, ckv, kr, cfg) + (_scale(cfg),)


def _scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim
                           + cfg.mla.qk_rope_head_dim)


def _attend_plain(p, q_nope, q_rope, ckv, kr, cfg: ModelConfig, *,
                  q_offset: int, valid: torch.Tensor, absorbed: bool):
    """The reference's attention of q (B, S, H, ·) against the whole latent
    cache (B, T, ·), queries chunked by attn_q_chunk; (B, S, H, v)."""
    c = cfg.mla
    B, S, H, _ = q_nope.shape
    T = ckv.shape[1]
    scale = _scale(cfg)
    w_uk = p["w_uk"].reshape(c.kv_lora_rank, H, c.qk_nope_head_dim)
    w_uv = p["w_uv"].reshape(c.kv_lora_rank, H, c.v_head_dim)
    if not absorbed:
        k_nope = torch.einsum("btr,rhn->bthn", ckv, w_uk)
        v = torch.einsum("btr,rhv->bthv", ckv, w_uv)
    kpos = torch.arange(T, device=ckv.device)

    def attend(qn, qr, off):
        if absorbed:
            q_lat = torch.einsum("bshn,rhn->bshr", qn, w_uk)
            logits = (torch.einsum("bshr,btr->bhst", q_lat, ckv)
                      + torch.einsum("bshn,btn->bhst", qr, kr)) * scale
        else:
            logits = (torch.einsum("bshn,bthn->bhst", qn, k_nope)
                      + torch.einsum("bshn,btn->bhst", qr, kr)) * scale
        logits = logits.float()
        qpos = off + torch.arange(qn.shape[1], device=ckv.device)[:, None]
        logits = logits.masked_fill(~(qpos >= kpos[None, :]), -1e30)
        logits = logits.masked_fill(~valid, -1e30)
        w = torch.softmax(logits, dim=-1)
        if absorbed:
            # attention against the latent, then W_UV on the output
            o_lat = torch.einsum("bhst,btr->bshr", w.to(ckv.dtype), ckv)
            return torch.einsum("bshr,rhv->bshv", o_lat, w_uv)
        return torch.einsum("bhst,bthv->bshv", w.to(v.dtype), v)

    qc = cfg.attn_q_chunk
    if qc and S > qc and S % qc == 0:
        return torch.cat([attend(q_nope[:, i:i + qc], q_rope[:, i:i + qc],
                                 q_offset + i) for i in range(0, S, qc)], 1)
    return attend(q_nope, q_rope, q_offset)


def mla_attention(p, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                  *, cache: dict | None = None, cache_pos: int = 0,
                  decode_mode: str = "absorbed"):
    """Returns (out, cache); cache = {"ckv": (B, T, r), "kr": (B, T,
    r_rope)}, written in place at cache_pos."""
    c = cfg.mla
    B, S, _ = x.shape
    q_nope, q_rope = _queries(p, x, pos, cfg)
    ckv, kr = _latents(p, x, pos, cfg)
    if cache is not None:
        cache["ckv"][:, cache_pos:cache_pos + S] = ckv
        cache["kr"][:, cache_pos:cache_pos + S] = kr
    if cache_pos == 0:
        q, k, v = _materialized(p, q_nope, q_rope, ckv, kr, cfg)
        out = ops.flash_attention(q, k, v, causal=True, scale=_scale(cfg))
        out = out[..., :c.v_head_dim].transpose(1, 2)
    else:
        T = cache["ckv"].shape[1]
        valid = torch.arange(T, device=x.device) < cache_pos + S
        out = _attend_plain(p, q_nope, q_rope, cache["ckv"], cache["kr"],
                            cfg, q_offset=cache_pos, valid=valid,
                            absorbed=decode_mode == "absorbed")
    out = out.reshape(B, S, cfg.num_heads * c.v_head_dim) @ p["wo"]
    return out, cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                   dtype=None) -> dict:
    c = cfg.mla
    dt = dtype or pdtype(cfg)
    return {"ckv": torch.zeros(batch, max_len, c.kv_lora_rank, dtype=dt,
                               device=device),
            "kr": torch.zeros(batch, max_len, c.qk_rope_head_dim, dtype=dt,
                              device=device)}
