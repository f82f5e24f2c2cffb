"""Plain torch oracles for the ported kernels (the allclose ground truth).

Counterpart of src/repro/kernels/ref.py: independent two-pass math in f32,
whatever the storage type.
"""
from __future__ import annotations

import math

import torch


def gemm_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return (a.float() @ b.float()).to(out_dtype)


def tsgram_ref(a: torch.Tensor, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    af = a.float()
    return (af.T @ af).to(out_dtype)


def fused_grad_ref(a: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                   weights: torch.Tensor, *, loss: str, param: float = 1.0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f, g, z) for a dense or BlockELL operand (densified): z = A x, then
    the loss and its derivative, then g = Aᵀ r as a separate product."""
    if hasattr(a, "to_dense"):
        a = a.to_dense()
    af = a.float()
    z = af @ x.float()
    t = target.float()
    w = weights.float()
    if loss == "quad":
        d = z - t
        f = 0.5 * torch.sum(w * d * d)
        r = w * d
    elif loss == "logistic":
        mz = -t * z
        f = torch.sum(w * torch.logaddexp(torch.zeros_like(mz), mz))
        r = w * (-t) * torch.sigmoid(mz)
    elif loss == "huber":
        d = z - t
        ad = torch.abs(d)
        f = torch.sum(w * torch.where(ad <= param, 0.5 * d * d,
                                      param * (ad - 0.5 * param)))
        r = w * torch.clamp(d, -param, param)
    elif loss == "poisson":
        ez = torch.exp(z)
        f = torch.sum(w * (ez - t * z))
        r = w * (ez - t)
    else:
        raise ValueError(loss)
    return f, af.T @ r, z


def bsr_matmul_ref(a, x: torch.Tensor) -> torch.Tensor:
    """Y = A X oracle via densification of the BlockELL operand."""
    return (a.to_dense().float() @ x.float()).to(x.dtype)


def bsr_matvec_ref(a, x: torch.Tensor) -> torch.Tensor:
    """y = A x oracle via densification of the BlockELL operand."""
    return (a.to_dense().float() @ x.float()).to(x.dtype)


def bsr_rmatmul_ref(a, x: torch.Tensor) -> torch.Tensor:
    """Y = AᵀX oracle via densification of the BlockELL operand."""
    return (a.to_dense().float().T @ x.float()).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float | None = None, causal: bool = True,
                        q_heads_per_kv: int = 1) -> torch.Tensor:
    """Naive attention with explicit (Sq × Sk) scores, f32 softmax, the
    causal mask top-left (``tril`` of (Sq, Sk)).  q: (B·Hq, Sq, D);
    k, v: (B·Hkv, Sk, D), q-head-major per batch element."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q_heads_per_kv > 1:
        k = k.repeat_interleave(q_heads_per_kv, dim=0)
        v = v.repeat_interleave(q_heads_per_kv, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def selective_scan_ref(x, dt, A, B, C, D, h0=None):
    """Sequential oracle for the Mamba1 recurrence (f32): returns y in
    x.dtype and the final state (Bt, d, N) in f32.  h0 (default 0) is the
    state before the first step."""
    Bt, S, d = x.shape
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B.float(), C.float()
    h = (torch.zeros(Bt, d, A.shape[1], device=x.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(S):
        h = torch.exp(dtf[:, t, :, None] * A) * h + \
            (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]) + D * xf[:, t])
    y = torch.stack(ys, 1) if ys else xf.new_zeros(Bt, 0, d)
    return y.to(x.dtype), h
