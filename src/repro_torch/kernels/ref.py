"""Plain torch oracles for the ported kernels (the allclose ground truth).

Counterpart of src/repro/kernels/ref.py: independent two-pass math in f32,
whatever the storage type.
"""
from __future__ import annotations

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
