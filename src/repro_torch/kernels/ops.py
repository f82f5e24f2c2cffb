"""Public kernel entry points: validation and device dispatch.

Counterpart of src/repro/kernels/ops.py.  A tensor on the CPU goes to the
kernel's plain torch version; a CUDA tensor goes to the hand-written kernel,
which raises unless the card is sm_90.  There is no other route: no
fallback from the kernel to the plain version.  The kernels mask ragged
edges themselves, so nothing is padded here (the TPU wrappers padded only
for the (8, 128) tiling).
"""
from __future__ import annotations

import torch

from . import bsr as _bsr
from . import fusedgrad as _fg
from . import gemm as _gemm
from . import randsketch as _randsketch
from . import tsgram as _tsgram

KERNELS = {"fused_grad": _fg.fused_grad, "tsgram": _tsgram.tsgram,
           "gemm": _gemm.gemm, "fused_grad_multi": _fg.fused_grad_multi,
           "randsketch": _randsketch.randsketch,
           "bsr_matvec": _bsr.bsr_matvec, "bsr_matmul": _bsr.bsr_matmul,
           "bsr_rmatmul": _bsr.bsr_rmatmul,
           "fused_grad_bsr": _fg.fused_grad_bsr}


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devs))}")
    return devs.pop().type == "cpu"


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def gemm(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """C = A @ B in f32 accumulation, cast to `out_dtype` (default a.dtype)."""
    if _on_cpu(a, b):
        return _gemm.gemm_plain(a, b, out_dtype)
    return _gemm.gemm(a, b, out_dtype=out_dtype)


def tsgram(a: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """G = AᵀA for tall-skinny A, f32 accumulation, in `out_dtype`."""
    if _on_cpu(a):
        return _tsgram.tsgram_plain(a, out_dtype)
    return _tsgram.tsgram(a, out_dtype=out_dtype)


def randsketch(a: torch.Tensor, q: torch.Tensor, *,
               out_dtype=None) -> torch.Tensor:
    """B = AᵀQ for conforming tall-skinny A (m × n), Q (m × r), f32
    accumulation, in `out_dtype` (default a.dtype): the randomized SVD's
    projection."""
    if _on_cpu(a, q):
        return _randsketch.randsketch_plain(a, q, out_dtype)
    return _randsketch.randsketch(a, q, out_dtype=out_dtype)


def fused_grad(a: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
               weights: torch.Tensor, *, loss: str, param: float = 1.0
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f, g, z) = (Σᵢ wᵢ ℓ((Ax)ᵢ, tᵢ), Aᵀ(w∘ℓ'(Ax, t)), Ax), reading A
    once.  Returns f32 f (scalar), g (n,) in x.dtype, f32 z (m,)."""
    if loss not in _fg.LOSSES:
        raise ValueError(f"loss must be one of {_fg.LOSSES}, got {loss!r}")
    if _on_cpu(a, x, target, weights):
        f, g, z = _fg.fused_grad_plain(a, x, target, weights, loss=loss,
                                       param=param)
    else:
        f, g, z = _fg.fused_grad(a, x, target, weights, loss=loss,
                                 param=param)
    return f, g.to(x.dtype), z


def fused_grad_multi(a: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                     weights: torch.Tensor, *, loss: str, param: float = 1.0
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Request-batched fused gradients: k right-hand sides answered in ONE
    streaming pass over A.  x (k, n), target/weights (k, m) → f (k,) f32,
    g (k, n) in x.dtype, z (k, m) f32.  Slots with zero weights contribute
    nothing to their own f and g."""
    if loss not in _fg.LOSSES:
        raise ValueError(f"loss must be one of {_fg.LOSSES}, got {loss!r}")
    if _on_cpu(a, x, target, weights):
        f, g, z = _fg.fused_grad_multi_plain(a, x, target, weights,
                                             loss=loss, param=param)
    else:
        f, g, z = _fg.fused_grad_multi(a, x, target, weights, loss=loss,
                                       param=param)
    return f, g.to(x.dtype), z


def bsr_matvec(a: "_bsr.BlockELL", x: torch.Tensor) -> torch.Tensor:
    """y = A x for a BlockELL A and x (n,), f32 sums, in x.dtype."""
    if _on_cpu(a.data, x):
        return _bsr.bsr_matvec_plain(a, x)
    return _bsr.bsr_matvec(a, x).to(x.dtype)


def bsr_matmul(a: "_bsr.BlockELL", x: torch.Tensor) -> torch.Tensor:
    """Y = A X for a BlockELL A and X (n, nx), f32 sums, in x.dtype."""
    if _on_cpu(a.data, x):
        return _bsr.bsr_matmul_plain(a, x)
    return _bsr.bsr_matmul(a, x).to(x.dtype)


def bsr_rmatmul(a: "_bsr.BlockELL", x: torch.Tensor) -> torch.Tensor:
    """Y = AᵀX for a BlockELL A and X (m, nx), f32 sums, in x.dtype."""
    if _on_cpu(a.data, x):
        return _bsr.bsr_rmatmul_plain(a, x)
    return _bsr.bsr_rmatmul(a, x).to(x.dtype)


def fused_grad_bsr(a: "_bsr.BlockELL", x: torch.Tensor, target: torch.Tensor,
                   weights: torch.Tensor, *, loss: str, param: float = 1.0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused (f, g, z) for a BlockELL shard, every stored block read once;
    x, target and weights conform to its padded dims.  int8 shards compose
    bsr_matvec, the row residual and bsr_rmatmul (two reads of the int8
    blocks, still half the bytes of one f32 read), as the reference does;
    exact shards take the fused kernel.  The kernel takes any n, so the
    reference's VMEM-budget fallback has no counterpart.  Returns f32 f,
    g (n,) in x.dtype, f32 z (m,)."""
    if loss not in _fg.LOSSES:
        raise ValueError(f"loss must be one of {_fg.LOSSES}, got {loss!r}")
    if _on_cpu(a.data, x, target, weights):
        f, g, z = _fg.fused_grad_bsr_plain(a, x, target, weights, loss=loss,
                                           param=param)
    elif a.scales is not None:
        z = _bsr.bsr_matvec(a, x)
        f, r = _fg.row_loss_grad(z, target, weights, loss, param)
        g = _bsr.bsr_rmatmul(a, r.to(x.dtype)[:, None])[:, 0]
    else:
        f, g, z = _fg.fused_grad_bsr(a, x, target, weights, loss=loss,
                                     param=param)
    return f, g.to(x.dtype), z
