"""Single-pass fused composite gradient: the optimizer's hot-path kernel.

For a row-separable loss f(z) = Σᵢ wᵢ ℓ(zᵢ, tᵢ) one streaming read of A
gives f(Ax), Aᵀ∇f(Ax) and Ax: per row block, z = A_blk x, then the row
residual r = w∘ℓ'(z, t), then g += r A_blk, while the block is still close
to the cores.

One kernel, ``csrc/fused_grad_multi.cu``, serves both wrappers and replaces
both TPU kernels of ``src/repro/kernels/fusedgrad.py``: ``fused_grad``
(``_fused_grad_kernel``) is its one-slot case, and ``fused_grad_multi``
(``_fused_grad_multi_kernel``) the request-batched form for k right-hand
sides sharing A (the serving path, ``core/optim/batched``).  On the H100 a
few slots are bound by the bytes of A (4mnk flops against m·n·sizeof(storage)
bytes).  The kernel stages each row block in shared memory so A leaves HBM
once, gives every block of a persistent grid its own partials, and sums them
in block order in a second kernel, so repeated runs agree bit for bit.  Its
row blocking and grid follow from A's shape alone, so a request gets the
same bits from ``fused_grad`` as from any slot of ``fused_grad_multi``.

``fused_grad_bsr`` (``csrc/fused_grad_bsr.cu``) is the same function on a
BlockELL operand (kernels/bsr.py), replacing ``_fused_grad_bsr_kernel``:
each stored block is read once, z and the residual come from a block-row's
staged blocks, and rᵀAᵢⱼ is added into the block's partial g at block
column cols[i, s] by one owner thread per element, so no float atomics.

``fused_grad_plain``, ``fused_grad_multi_plain`` and
``fused_grad_bsr_plain`` are the same functions in plain torch: the CPU
path, and what the kernels are held against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import bsr as _bsr

LOSSES = ("quad", "logistic", "huber", "poisson")
MAX_SLOTS = 32            # right-hand sides one launch takes


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


def fused_grad_multi_plain(a: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                           w: torch.Tensor, *, loss: str, param: float = 1.0
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f (k,), g (k × n), z (k × m)) for k right-hand sides in plain torch,
    with the kernel's arithmetic: z = X Aᵀ on the upcast operand, the row
    residual in f32 (for bf16 storage too), then g = R·A."""
    af = a.float()
    z = x.float() @ af.T
    le, r = row_loss_elem(z, t, w, loss, param)
    return le.sum(dim=1), r @ af, z


def fused_grad_bsr_plain(a: "_bsr.BlockELL", x: torch.Tensor,
                         t: torch.Tensor, w: torch.Tensor, *, loss: str,
                         param: float = 1.0
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f, g, z) on a BlockELL in plain torch (the reference's
    fused_grad_bsr_jnp): z from the gathered x blocks, the residual through
    row_loss_grad, then the scatter-add of rᵀAᵢⱼ over block columns.  The
    residual stays f32 for every storage, as in the kernel."""
    z = _bsr.bsr_matvec_plain(a, x.float())
    f, r = row_loss_grad(z, t, w, loss, param)
    return f, _bsr.bsr_rmatmul_plain(a, r[:, None])[:, 0], z


def fused_grad_bsr(a: "_bsr.BlockELL", x: torch.Tensor, t: torch.Tensor,
                   w: torch.Tensor, *, loss: str, param: float = 1.0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/fused_grad_bsr.cu on a CUDA BlockELL with f32 or bf16
    blocks: x (n,), t, w (m,) over its dims, read as f32.  Returns f32
    f (scalar), g (n,), z (m,).  Replaces the TPU kernel
    ``src/repro/kernels/fusedgrad.py:fused_grad_bsr``."""
    dev, code = _bsr.check_operands(a, x, t, w)
    if a.scales is not None:
        raise ValueError("fused_grad_bsr takes exact (f32 or bf16) blocks; "
                         "int8 shards compose bsr_matvec and bsr_rmatmul")
    if loss not in LOSSES:
        raise ValueError(f"loss must be one of {LOSSES}, got {loss!r}")
    (m, n), (nbr, ell) = a.shape, a.cols.shape
    if x.shape != (n,) or t.shape != (m,) or w.shape != (m,):
        raise ValueError(f"shapes x {tuple(x.shape)}, t {tuple(t.shape)}, "
                         f"w {tuple(w.shape)} against A {a.shape}")
    x, t, w = (v.float().contiguous() for v in (x, t, w))
    lib = _build.lib()
    staged, g_smem, grid = (ctypes.c_int() for _ in range(3))
    _build.check(lib.repro_fused_grad_bsr_plan(
        dev.index, nbr, ell, a.bs, n, code, ctypes.byref(staged),
        ctypes.byref(g_smem), ctypes.byref(grid)), "fused_grad_bsr plan")
    f32 = dict(dtype=torch.float32, device=dev)
    z = torch.empty(m, **f32)
    g_part = torch.empty((grid.value, n), **f32)
    f_part = torch.empty(grid.value, **f32)
    g = torch.empty(n, **f32)
    f = torch.empty((), **f32)
    _build.check(lib.repro_fused_grad_bsr(
        dev.index, a.data.data_ptr(), code, a.cols.data_ptr(), x.data_ptr(),
        t.data_ptr(), w.data_ptr(), nbr, ell, a.bs, n, staged.value,
        g_smem.value, grid.value, LOSSES.index(loss), float(param),
        z.data_ptr(), g_part.data_ptr(), f_part.data_ptr(), g.data_ptr(),
        f.data_ptr(), _build.stream(dev)), "fused_grad_bsr launch")
    fused_grad_bsr.launches += 1
    return f, g, z


fused_grad_bsr.launches = 0


def _launch(a, x, t, w, loss, param):
    """Run csrc/fused_grad_multi.cu: a (m × n) f32 or bf16, row-major;
    x (k × n); t, w (k × m), 1 ≤ k ≤ MAX_SLOTS.  Returns f32 f (k,),
    g (k × n), z (k × m)."""
    dev = _build.check_device(a, x, t, w)
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError("a must be a contiguous (m, n) matrix")
    if loss not in LOSSES:
        raise ValueError(f"loss must be one of {LOSSES}, got {loss!r}")
    (m, n), k = a.shape, x.shape[0]
    if x.shape != (k, n) or t.shape != (k, m) or w.shape != (k, m):
        raise ValueError(f"shapes a {tuple(a.shape)}, x {tuple(x.shape)}, "
                         f"t {tuple(t.shape)}, w {tuple(w.shape)}")
    if not 1 <= k <= MAX_SLOTS or m < 1 or n < 1:
        raise ValueError(f"the kernel takes 1..{MAX_SLOTS} slots and a "
                         f"non-empty a; got k={k}, a {tuple(a.shape)}")
    code = _build.dtype_code(a, "a")
    x, t, w = (v.float().contiguous() for v in (x, t, w))
    lib = _build.lib()
    bm, staged, g_smem, grid = (ctypes.c_int() for _ in range(4))
    _build.check(lib.repro_fused_grad_multi_plan(
        dev.index, m, n, k, code, ctypes.byref(bm), ctypes.byref(staged),
        ctypes.byref(g_smem), ctypes.byref(grid)), "fused_grad_multi plan")
    f32 = dict(dtype=torch.float32, device=dev)
    z = torch.empty((k, m), **f32)
    g_part = torch.empty((grid.value, k, n), **f32)
    f_part = torch.empty((grid.value, k), **f32)
    g = torch.empty((k, n), **f32)
    f = torch.empty(k, **f32)
    _build.check(lib.repro_fused_grad_multi(
        dev.index, a.data_ptr(), code, x.data_ptr(), t.data_ptr(),
        w.data_ptr(), m, n, k, bm.value, staged.value, g_smem.value,
        grid.value, LOSSES.index(loss), float(param), z.data_ptr(),
        g_part.data_ptr(),
        f_part.data_ptr(), g.data_ptr(), f.data_ptr(), _build.stream(dev)),
        "fused_grad_multi launch")
    return f, g, z


def fused_grad(a: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
               w: torch.Tensor, *, loss: str, param: float = 1.0
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/fused_grad_multi.cu with one slot on a CUDA operand:
    a (m × n) f32 or bf16, row-major; x (n,); t, w (m,).  Returns f32
    f (scalar), g (n,), z (m,)."""
    if x.dim() != 1 or t.dim() != 1 or w.dim() != 1:
        raise ValueError(f"shapes x {tuple(x.shape)}, t {tuple(t.shape)}, "
                         f"w {tuple(w.shape)}: one slot takes vectors")
    f, g, z = _launch(a, x[None], t[None], w[None], loss, param)
    fused_grad.launches += 1
    return f[0], g[0], z[0]


fused_grad.launches = 0


def fused_grad_multi(a: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                     w: torch.Tensor, *, loss: str, param: float = 1.0
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/fused_grad_multi.cu on a CUDA operand: a (m × n) f32 or
    bf16, row-major; x (k × n); t, w (k × m), 1 ≤ k ≤ MAX_SLOTS.  Returns
    f32 f (k,), g (k × n), z (k × m).  Replaces the TPU kernel
    ``src/repro/kernels/fusedgrad.py:fused_grad_multi``: one read of A
    serves every slot, and each slot's outputs are sums in an order fixed
    by A's shape alone, so a slot gets the same bits whatever the other
    slots hold and however many there are (``csrc/fused_grad_multi.cu``)."""
    f, g, z = _launch(a, x, t, w, loss, param)
    fused_grad_multi.launches += 1
    return f, g, z


fused_grad_multi.launches = 0
