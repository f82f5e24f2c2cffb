"""Selective state-space block: Mamba1 (falcon-mamba-7b).

Counterpart of the Mamba1 half of src/repro/models/ssm.py (Mamba2 and the
hybrid family wait, ROADMAP.md queue 1 item 15).  The reference evaluates
the prefill recurrence as a chunked associative scan in XLA; here the same
projections (x_proj in x's dtype, softplus dt, A = −exp(A_log)) feed
`ops.selective_scan`, the hand-written scan kernel on the card, which walks
S in order with the state in registers and returns the final state for the
cache.  The config's chunk length `ssm.chunk` therefore has no part here.
Decode is the plain one-step recurrence, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .config import ModelConfig
from .layers import _dense_init, pdtype


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by shift and add; x (B, S, C), w (width, C)."""
    width, S = w.shape[0], x.shape[1]
    out = x * w[-1] + b
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[-1 - i]
    return out


def _conv_step(state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """Single-token conv: state (B, width-1, C), x_t (B, C)."""
    full = torch.cat([state, x_t[:, None]], 1)              # (B, width, C)
    y = (full * w[None]).sum(1) + b
    return full[:, 1:], y


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, state dim N, dt_rank)."""
    s = cfg.ssm
    return (s.expand * cfg.d_model, s.state_dim,
            s.dt_rank or -(-cfg.d_model // 16))


def init_mamba1(gen: torch.Generator, cfg: ModelConfig) -> dict:
    s = cfg.ssm
    D = cfg.d_model
    di, N, dt_rank = _dims(cfg)
    dt, dev = pdtype(cfg), gen.device
    u = torch.rand(di, generator=gen, device=dev) * 0.099 + 0.001
    return {
        "w_in": _dense_init(gen, (D, 2 * di), dt),
        "conv_w": torch.randn(s.conv_dim, di, generator=gen, device=dev) * 0.1,
        "conv_b": torch.zeros(di, device=dev),
        "x_proj": _dense_init(gen, (di, dt_rank + 2 * N), dt),
        "dt_proj": _dense_init(gen, (dt_rank, di), torch.float32,
                               scale=dt_rank ** -0.5),
        "dt_bias": torch.log(torch.expm1(u.clamp_min(1e-4))),
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                        device=dev)).repeat(di, 1),
        "D": torch.ones(di, device=dev),
        "w_out": _dense_init(gen, (di, D), dt),
    }


def _scan_inputs(p, x: torch.Tensor, dt_rank: int, N: int):
    """The scan's (dt, A, B, C) from post-conv x (Bt, S, di), as the
    reference's _mamba1_inner makes them: dt (Bt, S, di), A (di, N), B and
    C (Bt, S, N), all f32."""
    dtBC = (x @ p["x_proj"].to(x.dtype)).float()
    dtr, Bm, Cm = torch.split(dtBC, [dt_rank, N, N], -1)
    dt = F.softplus(dtr @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return dt, A, Bm.contiguous(), Cm.contiguous()


def _mamba1_inner(p, x: torch.Tensor, dt_rank: int, N: int,
                  h0: torch.Tensor | None):
    """x: (B, S, di) post-conv activations; returns (y f32, h_final)."""
    dt, A, Bm, Cm = _scan_inputs(p, x, dt_rank, N)
    return ops.selective_scan(x.float().contiguous(), dt, A, Bm, Cm, p["D"],
                              h0=h0)


def mamba1_block(p, x: torch.Tensor, cfg: ModelConfig, *, cache=None):
    """x: (B, S, D).  cache: {"conv": (B, w-1, di), "h": (B, di, N)},
    replaced in place.  Returns (out, cache)."""
    di, N, dt_rank = _dims(cfg)
    S = x.shape[1]
    xr, z = (x @ p["w_in"]).chunk(2, -1)

    if cache is None or S > 1:
        # cache-free forward, or prefill into the cache (scan + final state)
        xc = F.silu(_causal_conv(xr.float(), p["conv_w"], p["conv_b"])
                    ).to(x.dtype)
        y, h_fin = _mamba1_inner(p, xc, dt_rank, N,
                                 None if cache is None else cache["h"])
        if cache is not None:
            cache["conv"] = xr[:, S - (cfg.ssm.conv_dim - 1):].float()
            cache["h"] = h_fin
    else:
        cache["conv"], xc = _conv_step(cache["conv"], xr[:, 0].float(),
                                       p["conv_w"], p["conv_b"])
        xc = F.silu(xc)                                        # (B, di)
        dtBC = (xc.to(x.dtype) @ p["x_proj"].to(x.dtype)).float()
        dtr, Bm, Cm = torch.split(dtBC, [dt_rank, N, N], -1)
        dt = F.softplus(dtr @ p["dt_proj"] + p["dt_bias"])     # (B, di)
        A = -torch.exp(p["A_log"])
        h = torch.exp(dt[..., None] * A) * cache["h"] + \
            (dt * xc)[..., None] * Bm[:, None, :]
        cache["h"] = h
        y = (torch.einsum("bdn,bn->bd", h, Cm) + xc * p["D"])[:, None]

    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p["w_out"], cache


def init_mamba1_cache(cfg: ModelConfig, batch: int, device) -> dict:
    di, N, _ = _dims(cfg)
    return {"conv": torch.zeros(batch, cfg.ssm.conv_dim - 1, di,
                                device=device),
            "h": torch.zeros(batch, di, N, device=device)}
