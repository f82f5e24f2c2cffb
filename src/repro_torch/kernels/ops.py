"""Public kernel entry points: validation and device dispatch.

Counterpart of src/repro/kernels/ops.py.  A tensor on the CPU goes to the
kernel's plain torch version; a CUDA tensor goes to the hand-written kernel,
which raises unless the card is sm_90.  There is no other route: no
fallback from the kernel to the plain version.  The kernels mask ragged
edges themselves, so nothing is padded here (the TPU wrappers padded only
for the (8, 128) tiling).

fp8 storage (float8_e4m3fn and float8_e5m2) takes fused_grad,
fused_grad_multi, tsgram, gemm and randsketch (A), the kernels the
reference's fp8 paths reach (the CPU's plain versions upcast); the
block-sparse kernels raise TypeError on it on either device: the
reference's BlockELL stores f32, bf16 or int8.

gemm is the one kernel with a launch choice the autotuner tunes, its
output tile width: ``tune="auto"`` resolves it per (backend, dtype,
shape) through kernels/autotune.py, from a swept winner where one was
recorded, else from the machine model's ranking, whose ties go to the
width gemm.tile_width picks (``tune="off"``).  ``bn`` overrides it, and a
width the kernel cannot take raises ValueError.  Every other kernel has
one launch, its own rule; a reference tile argument with no counterpart
raises NotImplementedError and says why.
"""
from __future__ import annotations

import math

import torch

from . import autotune as _tune
from . import bsr as _bsr
from . import dtypes
from . import flash_attention as _fa
from . import fusedgrad as _fg
from . import gemm as _gemm
from . import randsketch as _randsketch
from . import selective_scan as _ss
from . import tsgram as _tsgram

KERNELS = {"fused_grad": _fg.fused_grad, "tsgram": _tsgram.tsgram,
           "gemm": _gemm.gemm, "fused_grad_multi": _fg.fused_grad_multi,
           "randsketch": _randsketch.randsketch,
           "bsr_matvec": _bsr.bsr_matvec, "bsr_matmul": _bsr.bsr_matmul,
           "bsr_rmatmul": _bsr.bsr_rmatmul,
           "fused_grad_bsr": _fg.fused_grad_bsr,
           "fused_grad_bsr_multi": _fg.fused_grad_bsr_multi,
           "flash_attention": _fa.flash_attention,
           "selective_scan": _ss.selective_scan}


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devs))}")
    return devs.pop().type == "cpu"


def _no_fp8(kernel: str, t: torch.Tensor) -> None:
    if t.dtype in dtypes.FP8:
        raise TypeError(f"{kernel} takes no float8_e4m3fn or float8_e5m2 "
                        "operand: the reference's block-sparse storage is "
                        "float32, bfloat16 or int8")


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Zero every kernel's launch count, and its counts by variant and by
    mask where it keeps them (flash_attention)."""
    for fn in KERNELS.values():
        fn.launches = 0
        for counts in (getattr(fn, "variant_launches", {}),
                       getattr(fn, "mask_launches", {})):
            for key in counts:
                counts[key] = 0


def gemm(a: torch.Tensor, b: torch.Tensor, *, bn: int | None = None,
         tune: str = "auto", out_dtype=None) -> torch.Tensor:
    """C = A @ B in f32 accumulation, cast to `out_dtype` (default a.dtype).
    `bn` is the output tile's width (8, 16 or 32 columns); `tune` resolves
    it when it is not given.  The CPU path resolves it too (it checks `bn`)
    and runs the plain version."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    cfg = _tune.resolve("gemm", {"m": m, "k": k, "n": n,
                                 "b_itemsize": b.element_size()}, a.dtype,
                        {"bn": bn}, tune=tune, backend=a.device.type)
    if _on_cpu(a, b):
        return _gemm.gemm_plain(a, b, out_dtype)
    return _gemm.gemm(a, b, out_dtype=out_dtype, bn=cfg["bn"])


def tsgram(a: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """G = AᵀA for tall-skinny A, f32 accumulation, in `out_dtype`."""
    if _on_cpu(a):
        return _tsgram.tsgram_plain(a, out_dtype)
    return _tsgram.tsgram(a, out_dtype=out_dtype)


def randsketch(a: torch.Tensor, q: torch.Tensor, *,
               out_dtype=None) -> torch.Tensor:
    """B = AᵀQ for conforming tall-skinny A (m × n), Q (m × r), f32
    accumulation, in `out_dtype` (default a.dtype): the randomized SVD's
    projection, the chunked Gram's segments and the chunked gradient's.
    A may be a column segment of a wider matrix (its rows strided)."""
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
    _no_fp8("bsr_matvec", a.data)
    if _on_cpu(a.data, x):
        return _bsr.bsr_matvec_plain(a, x)
    return _bsr.bsr_matvec(a, x).to(x.dtype)


def bsr_matmul(a: "_bsr.BlockELL", x: torch.Tensor) -> torch.Tensor:
    """Y = A X for a BlockELL A and X (n, nx), f32 sums, in x.dtype."""
    _no_fp8("bsr_matmul", a.data)
    if _on_cpu(a.data, x):
        return _bsr.bsr_matmul_plain(a, x)
    return _bsr.bsr_matmul(a, x).to(x.dtype)


def bsr_rmatmul(a: "_bsr.BlockELL", x: torch.Tensor) -> torch.Tensor:
    """Y = AᵀX for a BlockELL A and X (m, nx), f32 sums, in x.dtype."""
    _no_fp8("bsr_rmatmul", a.data)
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
    _no_fp8("fused_grad_bsr", a.data)
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


def fused_grad_bsr_multi(a: "_bsr.BlockELL", x: torch.Tensor,
                         target: torch.Tensor, weights: torch.Tensor, *,
                         loss: str, param: float = 1.0
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Request-batched fused (f, g, z) for a BlockELL shard: k right-hand
    sides answered with ONE read of each stored block.  x (k, n),
    target/weights (k, m) over its padded dims → f (k,) f32, g (k, n) in
    x.dtype, z (k, m) f32.  int8 shards compose bsr_matmul at nx = k, the
    row residual and bsr_rmatmul, as the reference does; exact shards take
    the fused kernel (any k in one launch), which takes any n, so
    the reference's VMEM-budget fallback has no counterpart."""
    if loss not in _fg.LOSSES:
        raise ValueError(f"loss must be one of {_fg.LOSSES}, got {loss!r}")
    _no_fp8("fused_grad_bsr_multi", a.data)
    if _on_cpu(a.data, x, target, weights):
        f, g, z = _fg.fused_grad_bsr_multi_plain(a, x, target, weights,
                                                 loss=loss, param=param)
    elif a.scales is not None:
        z = _bsr.bsr_matmul(a, x.T).T
        le, r = _fg.row_loss_elem(z, target, weights, loss, param)
        # One sum a slot: torch's row sums of a (k, m) tensor take another
        # order at another k, and a request must get the same f alone.
        f = torch.stack([row.sum() for row in le])
        g = _bsr.bsr_rmatmul(a, r.to(x.dtype).T).T
    else:
        f, g, z = _fg.fused_grad_bsr_multi(a, x, target, weights, loss=loss,
                                           param=param)
    return f, g.to(x.dtype), z


def bsr_block_size(m: int, n: int, nnz: int, *, nx: int = 128,
                   dtype=torch.float32, tune: str = "auto") -> int:
    """The BlockELL block size for an (m × n) matrix with `nnz` nonzeros
    scattered uniformly: plan("bsr_bs") over BS_CANDIDATES, each priced
    at the ELL width the scatter gives it (P(block stored) = 1 − (1 −
    nnz/mn)^(bs²)).  tune="off" gives the reference's legacy 8."""
    if tune == "off":
        return 8
    if tune != "auto":
        raise ValueError(f"tune must be 'auto' or 'off', got {tune!r}")
    from repro_torch.launch import planner as _planner
    density = min(1.0, float(nnz) / max(m * n, 1))
    ell_by_bs = {}
    for bs in _planner.BS_CANDIDATES:
        nbc = max(-(-n // bs), 1)
        p_block = 1.0 - (1.0 - density) ** (bs * bs)
        ell_by_bs[bs] = max(1, math.ceil(nbc * p_block))
    return int(_planner.plan("bsr_bs", {"m": m, "n": n, "nx": nx}, dtype,
                             context={"ell_by_bs": ell_by_bs}).blocks["bs"])


def _no_tiles(kernel: str, why: str, **tiles) -> None:
    """Raise for a reference tile argument: the kernel's design fixes its
    tiles (`why`), so the autotuner has nothing to choose there."""
    given = sorted(k for k, v in tiles.items() if v is not None)
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: {kernel}'s CUDA kernel fixes its tiles "
            f"({why}); kernels/autotune.py tunes gemm's alone")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    bq: int | None = None, bk: int | None = None
                    ) -> torch.Tensor:
    """q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D) with Hq a multiple of Hkv.
    Returns (B, Hq, Sq, D): softmax(QKᵀ·scale)V with f32 softmax, KV head
    = q head // (Hq / Hkv).  The causal mask is top-left, as the
    reference's default dispatch defines it (``tril`` of (Sq, Sk)): query
    row i sees keys 0..i, so rows ≥ Sk see every key."""
    _no_tiles("flash_attention", "bf16: 128 queries by 128 keys (64 keys at "
              "head dim 192), what two consumer warpgroups' registers and "
              "the block's shared memory hold; f32: 64 by 64", bq=bq, bk=bk)
    B, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "conform")
    args = (q.reshape(B * hq, sq, d), k.reshape(B * hkv, sk, d),
            v.reshape(B * hkv, sk, d))
    fn = _fa.flash_attention_plain if _on_cpu(q, k, v) else _fa.flash_attention
    out = fn(*(a.contiguous() for a in args), scale=scale, causal=causal,
             q_heads_per_kv=hq // hkv)
    return out.reshape(B, hq, sq, d)


def selective_scan(x, dt, A, B, C, D, *, h0=None, q: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Mamba1 scan.  x, dt: (Bt, S, d); A: (d, N); B, C: (Bt, S, N);
    D: (d,); h0: (Bt, d, N) or None (zeros).  Returns (y (Bt, S, d), f32
    final state (Bt, d, N)); the reference returns y alone, and prefill
    into a cache needs the state."""
    _no_tiles("selective_scan", "16 time steps a stage of its 3-stage "
              "ring", q=q)
    tensors = (x, dt, A, B, C, D) + (() if h0 is None else (h0,))
    if _on_cpu(*tensors):
        return _ss.selective_scan_plain(x, dt, A, B, C, D, h0=h0)
    return _ss.selective_scan(x, dt, A, B, C, D, h0=h0)
