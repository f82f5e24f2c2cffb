"""Single-pass fused composite gradient: the optimizer's hot-path kernel.

For a row-separable loss f(z) = Σᵢ wᵢ ℓ(zᵢ, tᵢ) one streaming read of A
gives f(Ax), Aᵀ∇f(Ax) and Ax: per row block, z = A_blk x, then the row
residual r = w∘ℓ'(z, t), then g += r A_blk, while the block is still close
to the cores.

Replaces the TPU kernel ``src/repro/kernels/fusedgrad.py:fused_grad``
(``_fused_grad_kernel``).  On the H100 it is bound by the bytes of A (4mn
flops against m·n·sizeof(storage) bytes).  ``csrc/fused_grad.cu`` stages
each row block in shared memory so A leaves HBM once, gives every block of a
persistent grid its own partial g and f, and sums the partials in block
order in a second kernel, so repeated runs agree bit for bit.

``fused_grad_plain`` is the same function in plain torch: the CPU path, and
what the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

LOSSES = ("quad", "logistic", "huber", "poisson")


def row_loss_elem(z: torch.Tensor, t: torch.Tensor, w: torch.Tensor,
                  loss: str, param: float = 1.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Elementwise (w∘ℓ(z, t), w∘ℓ'(z, t)) in float32.

      quad:     ℓ(z, b) = ½ (z − b)²,            ℓ' = z − b
      logistic: ℓ(z, y) = log(1 + e^(−y z)),     ℓ' = −y σ(−y z)
      huber:    ℓ(z, b) = ½d² if |d| ≤ δ else δ(|d| − ½δ),  d = z − b,
                ℓ' = clip(d, ±δ)                (δ = `param`)
      poisson:  ℓ(z, y) = e^z − y z (log-link NLL, + const), ℓ' = e^z − y
    """
    z, t, w = z.float(), t.float(), w.float()
    if loss == "quad":
        d = z - t
        return 0.5 * w * d * d, w * d
    if loss == "logistic":
        mz = -t * z
        return (w * torch.logaddexp(torch.zeros_like(mz), mz),
                w * (-t) * torch.sigmoid(mz))
    if loss == "huber":
        d = z - t
        a = torch.abs(d)
        le = w * torch.where(a <= param, 0.5 * d * d, param * (a - 0.5 * param))
        return le, w * torch.clamp(d, -param, param)
    if loss == "poisson":
        ez = torch.exp(z)
        return w * (ez - t * z), w * (ez - t)
    raise ValueError(f"loss must be one of {LOSSES}, got {loss!r}")


def row_loss_grad(z: torch.Tensor, t: torch.Tensor, w: torch.Tensor,
                  loss: str, param: float = 1.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σ wᵢ ℓ(zᵢ, tᵢ), w∘ℓ'(z, t)) in float32."""
    le, r = row_loss_elem(z, t, w, loss, param)
    return torch.sum(le), r


def fused_grad_plain(a: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                     w: torch.Tensor, *, loss: str, param: float = 1.0
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f, g, z) in plain torch, with the kernel's arithmetic: f32 math on
    the upcast operand, g as the row-vector product r·A."""
    af = a.float()
    z = af @ x.float()
    f, r = row_loss_grad(z, t, w, loss, param)
    return f, r @ af, z


def fused_grad(a: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
               w: torch.Tensor, *, loss: str, param: float = 1.0
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/fused_grad.cu on a CUDA operand: a (m × n) f32 or bf16,
    row-major; x (n,); t, w (m,).  Returns f32 f (scalar), g (n,), z (m,)."""
    dev = _build.check_device(a, x, t, w)
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError("a must be a contiguous (m, n) matrix")
    if loss not in LOSSES:
        raise ValueError(f"loss must be one of {LOSSES}, got {loss!r}")
    m, n = a.shape
    if x.shape != (n,) or t.shape != (m,) or w.shape != (m,):
        raise ValueError(f"shapes a {tuple(a.shape)}, x {tuple(x.shape)}, "
                         f"t {tuple(t.shape)}, w {tuple(w.shape)}")
    code = _build.dtype_code(a, "a")
    x, t, w = (v.float().contiguous() for v in (x, t, w))
    lib = _build.lib()
    bm, staged, grid = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check(lib.repro_fused_grad_plan(
        dev.index, m, n, code, ctypes.byref(bm), ctypes.byref(staged),
        ctypes.byref(grid)), "fused_grad plan")
    f32 = dict(dtype=torch.float32, device=dev)
    z = torch.empty(m, **f32)
    g_part = torch.empty((grid.value, n), **f32)
    f_part = torch.empty(grid.value, **f32)
    g = torch.empty(n, **f32)
    f = torch.empty((), **f32)
    _build.check(lib.repro_fused_grad(
        dev.index, a.data_ptr(), code, x.data_ptr(), t.data_ptr(),
        w.data_ptr(), m, n, bm.value, staged.value, grid.value,
        LOSSES.index(loss), float(param), z.data_ptr(), g_part.data_ptr(),
        f_part.data_ptr(), g.data_ptr(), f.data_ptr(), _build.stream(dev)),
        "fused_grad launch")
    fused_grad.launches += 1
    return f, g, z


fused_grad.launches = 0
