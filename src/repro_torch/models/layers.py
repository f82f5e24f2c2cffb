"""Core transformer layers: norms, RoPE, GQA attention (qk_norm / bias
options), gated MLP, embeddings and logits.

Counterpart of src/repro/models/layers.py.  Every layer is an (init,
apply) pair over a mapping of tensors (a plain dict from `init_*`, a
`transformer.Params` module once assembled); the reference's
PartitionSpecs have no counterpart on one card.  Weights are drawn from an
explicit `torch.Generator` with the reference's distributions.

Attention dispatch: causal self-attention over the fresh keys and values
with the first query at position 0 (the cache-free forward, and the
prefill that `transformer.prefill` starts at cache position 0) goes to
`ops.flash_attention`.  This equals the reference's attention over the
whole cache with its validity mask, since at offset 0 the causal mask
already hides every cache slot at or past S.  Decode steps, and prompts
continued at an offset > 0, take the plain masked attention `mha`, as in
the reference.  Non-causal self-attention without a cache (the encdec
encoder) and cross-attention (keys and values from `xattn_kv`, no RoPE,
any Sq and Sk) go to `ops.flash_attention(causal=False)`.
`softmax_xent` waits for training.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .config import ModelConfig


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _dense_init(gen: torch.Generator, shape, dtype,
                scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    x = torch.randn(shape, generator=gen, device=gen.device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------- norms ----
def init_norm(cfg: ModelConfig, device) -> dict:
    p = {"scale": torch.ones(cfg.d_model, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, device=device)
    return p


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"] + p["bias"]
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"]
    return out.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Per-head RMS norm (qk_norm, Qwen3-style): x (..., hd)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ----------------------------------------------------------------- rope ----
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd), pos: (B, S) integer → rotated x.  The two halves
    of hd rotate together (the reference's split-halves convention)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)             # (hd/2,)
    ang = pos[..., None].float() * freqs                # (B, S, hd/2)
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    dt, dev = pdtype(cfg), gen.device
    p = {"wq": _dense_init(gen, (d, H * hd), dt),
         "wk": _dense_init(gen, (d, KV * hd), dt),
         "wv": _dense_init(gen, (d, KV * hd), dt),
         "wo": _dense_init(gen, (H * hd, d), dt)}
    if cfg.qkv_bias:
        p |= {"bq": torch.zeros(H * hd, dtype=dt, device=dev),
              "bk": torch.zeros(KV * hd, dtype=dt, device=dev),
              "bv": torch.zeros(KV * hd, dtype=dt, device=dev)}
    if cfg.qk_norm:
        p |= {"q_norm": torch.ones(hd, device=dev),
              "k_norm": torch.ones(hd, device=dev)}
    return p


def _qkv(p, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos,
                                                          cfg.rope_theta), v


def _mha_direct(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, q_offset: int = 0,
                kv_mask: torch.Tensor | None = None,
                scale: float | None = None) -> torch.Tensor:
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, KV, g, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(T, device=q.device)[None, :]
        logits = logits.masked_fill(~(qpos >= kpos), -1e30)
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, None, :], -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
        q_offset: int = 0, kv_mask: torch.Tensor | None = None,
        scale: float | None = None, q_chunk: int = 0) -> torch.Tensor:
    """Grouped-query attention, f32 softmax, plain torch.  q: (B,S,H,hd);
    k/v: (B,T,KV,·).  q_offset: position of the first query (decode into a
    cache); kv_mask: (B, T) validity.  With q_chunk > 0 and long S the
    queries go through in chunks, so only a (B, H, q_chunk, T) score block
    is live."""
    B, S, H, hd = q.shape
    if not q_chunk or S <= q_chunk or S % q_chunk:
        return _mha_direct(q, k, v, causal=causal, q_offset=q_offset,
                           kv_mask=kv_mask, scale=scale)
    return torch.cat([
        _mha_direct(q[:, c:c + q_chunk], k, v, causal=causal,
                    q_offset=q_offset + c, kv_mask=kv_mask, scale=scale)
        for c in range(0, S, q_chunk)], 1)


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool) -> torch.Tensor:
    """`ops.flash_attention` on the (B, S, H, hd) layout: q (B, Sq, H, hd),
    k and v (B, Sk, KV, hd); returns (B, Sq, H, hd)."""
    return ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal
                               ).transpose(1, 2)


def attention(p, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig, *,
              cache: dict | None = None, cache_pos: int = 0,
              xattn_kv: torch.Tensor | None = None, causal: bool = True):
    """Self-attention with an optional KV cache, or cross-attention.

    cache: {"k": (B, Smax, KV, hd), "v": ...}; the new keys and values are
    written into it at cache_pos in place (a cached call is causal, as in
    the reference).  xattn_kv: (B, Sk, D) memory whose projections are the
    keys and values (no RoPE, no cache).  Returns (out, cache), cache None
    for cross-attention."""
    B, S, _ = x.shape
    if xattn_kv is not None:
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        Sk = xattn_kv.shape[1]
        q = (x @ p["wq"]).reshape(B, S, H, hd)
        k = (xattn_kv @ p["wk"]).reshape(B, Sk, KV, hd)
        v = (xattn_kv @ p["wv"]).reshape(B, Sk, KV, hd)
        out = flash(q, k, v, causal=False)
        return out.reshape(B, S, -1) @ p["wo"], None
    q, k, v = _qkv(p, x, pos, cfg)
    if cache is None and not causal:
        out = flash(q, k, v, causal=False)
        return out.reshape(B, S, -1) @ p["wo"], None
    if cache is not None:
        cache["k"][:, cache_pos:cache_pos + S] = k
        cache["v"][:, cache_pos:cache_pos + S] = v
    if cache_pos == 0:
        out = flash(q, k, v, causal=True)
    else:
        T = cache["k"].shape[1]
        kv_mask = (torch.arange(T, device=x.device) < cache_pos + S
                   ).expand(B, T)
        out = mha(q, cache["k"], cache["v"], causal=True,
                  q_offset=cache_pos, kv_mask=kv_mask,
                  q_chunk=cfg.attn_q_chunk)
    out = out.reshape(B, S, -1) @ p["wo"]
    return out, cache


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int,
                         device, dtype=None) -> dict:
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = dtype or pdtype(cfg)
    return {"k": torch.zeros(batch, max_len, KV, hd, dtype=dt, device=device),
            "v": torch.zeros(batch, max_len, KV, hd, dtype=dt, device=device)}


# ----------------------------------------------------------------- mlp -----
def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = pdtype(cfg)
    if cfg.mlp_type == "swiglu":
        return {"w_gate": _dense_init(gen, (d, f), dt),
                "w_up": _dense_init(gen, (d, f), dt),
                "w_down": _dense_init(gen, (f, d), dt)}
    return {"w_up": _dense_init(gen, (d, f), dt),
            "b_up": torch.zeros(f, dtype=dt, device=gen.device),
            "w_down": _dense_init(gen, (f, d), dt),
            "b_down": torch.zeros(d, dtype=dt, device=gen.device)}


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    # jax.nn.gelu's default is the tanh approximation.
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]


# ------------------------------------------------------------ embedding ----
VOCAB_PAD = 256   # the reference pads the vocab so the table shards evenly


def padded_vocab(cfg: ModelConfig) -> int:
    return ((cfg.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = pdtype(cfg)
    vp = padded_vocab(cfg)
    p = {"table": _dense_init(gen, (vp, cfg.d_model), dt, 0.02)}
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(gen, (cfg.d_model, vp), dt)
    return p


def embed(p, tokens: torch.Tensor, cfg: ModelConfig,
          frontend_embeds: torch.Tensor | None = None) -> torch.Tensor:
    x = p["table"][tokens]
    if frontend_embeds is not None:
        # [vlm]/[audio] stub: the first `frontend_len` positions are
        # precomputed modality embeddings.
        n = frontend_embeds.shape[1]
        x = torch.cat([frontend_embeds.to(x.dtype), x[:, n:]], 1)
    return x


def lm_logits(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p["table"].T if cfg.tie_embeddings else p["head"]
    logits = x @ w.to(x.dtype)
    vp = padded_vocab(cfg)
    if vp != cfg.vocab_size:
        # padded vocab columns out of the softmax and the argmax
        logits[..., cfg.vocab_size:] = -1e30
    return logits
