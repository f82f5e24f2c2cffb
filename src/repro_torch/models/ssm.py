"""Selective state-space blocks: Mamba1 (falcon-mamba-7b) and Mamba2
(zamba2's backbone).

Counterpart of src/repro/models/ssm.py.  The reference evaluates the
prefill recurrence in chunks in XLA (Mamba1: a chunked associative scan;
Mamba2: the chunked SSD matmul form); here the same projections feed
`ops.selective_scan`, the hand-written scan kernel on the card, which
walks S in order with the state in registers and returns the final state
for the cache.  The config's chunk length `ssm.chunk` therefore has no
part here, in either block.

Mamba1: x_proj in x's dtype, softplus dt, A = −exp(A_log), as the
reference's _mamba1_inner makes them.

Mamba2: head h of Pd channels runs h_t = exp(dt_h·A_h)·h_{t−1} +
dt_h·B_t·x_tᵀ with state (N, Pd) and B_t, C_t shared by every head, which
is the Mamba1 recurrence over di = H·Pd channels (channel h·Pd + p) with
dt[c] = dt_h, A[c, n] = A_h and D[c] = D_h: the prefill passes those,
repeated per channel, to the same kernel.  The cache keeps the reference's
state layout (B, H, N, Pd); the kernel's (B, di, N) is converted at the
boundary.  As in the reference, a prefill continued at an offset starts
from the cached state but pads its three convolutions with zeros.

Decode is the plain one-step recurrence of each block, as in the
reference.
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


# ================================================================ Mamba 2 ==
def _dims2(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, state dim N, head dim Pd, heads H)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return di, s.state_dim, s.head_dim, di // s.head_dim


def init_mamba2(gen: torch.Generator, cfg: ModelConfig) -> dict:
    s = cfg.ssm
    D = cfg.d_model
    di, N, _, H = _dims2(cfg)
    dt, dev = pdtype(cfg), gen.device
    return {
        "w_z": _dense_init(gen, (D, di), dt),
        "w_x": _dense_init(gen, (D, di), dt),
        "w_B": _dense_init(gen, (D, N), dt),
        "w_C": _dense_init(gen, (D, N), dt),
        "w_dt": _dense_init(gen, (D, H), torch.float32),
        "dt_bias": torch.zeros(H, device=dev),
        "conv_w": torch.randn(s.conv_dim, di, generator=gen, device=dev) * 0.1,
        "conv_b": torch.zeros(di, device=dev),
        "convB_w": torch.randn(s.conv_dim, N, generator=gen, device=dev) * 0.1,
        "convB_b": torch.zeros(N, device=dev),
        "convC_w": torch.randn(s.conv_dim, N, generator=gen, device=dev) * 0.1,
        "convC_b": torch.zeros(N, device=dev),
        "A_log": torch.zeros(H, device=dev),
        "D": torch.ones(H, device=dev),
        "norm_scale": torch.ones(di, device=dev),
        "w_out": _dense_init(gen, (di, D), dt),
    }


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    g = y * F.silu(z.float())
    var = (g * g).mean(-1, keepdim=True)
    return g * torch.rsqrt(var + eps) * scale


def mamba2_scan_inputs(p, xc: torch.Tensor, Bc: torch.Tensor,
                       Cc: torch.Tensor, dt: torch.Tensor, cfg: ModelConfig):
    """The selective_scan arguments (x, dt, A, B, C, D) of a Mamba2
    prefill: post-conv xc (B, S, di), Bc and Cc (B, S, N), dt (B, S, H),
    all f32, with dt, A and D repeated over each head's Pd channels."""
    di, N, Pd, _ = _dims2(cfg)
    A = (-torch.exp(p["A_log"])).repeat_interleave(Pd)
    return (xc.contiguous(), dt.repeat_interleave(Pd, -1).contiguous(),
            A[:, None].expand(di, N).contiguous(), Bc.contiguous(),
            Cc.contiguous(), p["D"].repeat_interleave(Pd).contiguous())


def mamba2_block(p, x: torch.Tensor, cfg: ModelConfig, *, cache=None):
    """SSD block.  x: (B, S, D).  cache: {"conv": (B, w-1, di), "convB",
    "convC": (B, w-1, N), "h": (B, H, N, Pd)}, replaced in place.  Returns
    (out, cache)."""
    di, N, Pd, H = _dims2(cfg)
    B, S, _ = x.shape

    z = x @ p["w_z"]
    xr = x @ p["w_x"]
    Br = x @ p["w_B"]
    Cr = x @ p["w_C"]
    dt = F.softplus(x.float() @ p["w_dt"] + p["dt_bias"])      # (B, S, H)
    A = -torch.exp(p["A_log"])                                 # (H,)

    if cache is None or S > 1:
        xc = F.silu(_causal_conv(xr.float(), p["conv_w"], p["conv_b"]))
        Bc = F.silu(_causal_conv(Br.float(), p["convB_w"], p["convB_b"]))
        Cc = F.silu(_causal_conv(Cr.float(), p["convC_w"], p["convC_b"]))
        h0 = (None if cache is None else
              cache["h"].permute(0, 1, 3, 2).reshape(B, di, N))
        y, h_fin = ops.selective_scan(
            *mamba2_scan_inputs(p, xc, Bc, Cc, dt, cfg), h0=h0)
        if cache is not None:
            w = cfg.ssm.conv_dim - 1
            cache["conv"] = xr[:, S - w:].float()
            cache["convB"] = Br[:, S - w:].float()
            cache["convC"] = Cr[:, S - w:].float()
            cache["h"] = h_fin.reshape(B, H, Pd, N).permute(0, 1, 3, 2
                                                            ).contiguous()
    else:
        cache["conv"], xc1 = _conv_step(cache["conv"], xr[:, 0].float(),
                                        p["conv_w"], p["conv_b"])
        cache["convB"], Bc1 = _conv_step(cache["convB"], Br[:, 0].float(),
                                         p["convB_w"], p["convB_b"])
        cache["convC"], Cc1 = _conv_step(cache["convC"], Cr[:, 0].float(),
                                         p["convC_w"], p["convC_b"])
        xc1, Bc1, Cc1 = F.silu(xc1), F.silu(Bc1), F.silu(Cc1)
        dt1 = dt[:, 0]                                         # (B, H)
        xh = xc1.reshape(B, H, Pd)
        h = torch.exp(dt1 * A)[..., None, None] * cache["h"] + \
            torch.einsum("bn,bh,bhp->bhnp", Bc1, dt1, xh)
        cache["h"] = h
        y = torch.einsum("bn,bhnp->bhp", Cc1, h) + p["D"][None, :, None] * xh
        y = y.reshape(B, 1, di)

    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps).to(x.dtype)
    return y @ p["w_out"], cache


def init_mamba2_cache(cfg: ModelConfig, batch: int, device) -> dict:
    di, N, Pd, H = _dims2(cfg)
    w = cfg.ssm.conv_dim - 1
    return {"conv": torch.zeros(batch, w, di, device=device),
            "convB": torch.zeros(batch, w, N, device=device),
            "convC": torch.zeros(batch, w, N, device=device),
            "h": torch.zeros(batch, H, N, Pd, device=device)}
