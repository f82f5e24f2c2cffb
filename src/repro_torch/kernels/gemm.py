"""Dense GEMM: C = A @ B (RowMatrix.multiply_local for the SVD's U, and
TSQR's Q).

Replaces the TPU kernel ``src/repro/kernels/gemm.py:gemm``
(``_gemm_kernel``).  On the main path it runs skinny, (m × n)@(n × k) with
k ≤ 64, where it is bound by the bytes of A.  ``csrc/gemm.cu`` is a
shared-memory tiled SGEMM with a 4 × 4 register tile per thread and a block
tile that follows N (256 × 16, 128 × 32 or 64 × 64), so that a narrow B
wastes no 64-wide tile; bf16 operands are upcast on load, sums are f32.

``gemm_plain`` is the same function in plain torch.
"""
from __future__ import annotations

import torch

from . import _build


def gemm_plain(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return (a.float() @ b.float()).to(out_dtype)


def gemm(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Launch csrc/gemm.cu on CUDA operands a (m × K), b (K × N), f32 or
    bf16; returns (m × N) in `out_dtype` (default a.dtype)."""
    dev = _build.check_device(a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    b = b.contiguous()
    out_dtype = out_dtype or a.dtype
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.lib()
    _build.check(lib.repro_gemm(
        dev.index, a.data_ptr(), _build.dtype_code(a, "a"), b.data_ptr(),
        _build.dtype_code(b, "b"), out.data_ptr(),
        _build.dtype_code(out, "out"), m, k, n, _build.stream(dev)),
        "gemm launch")
    gemm.launches += 1
    return out


gemm.launches = 0
