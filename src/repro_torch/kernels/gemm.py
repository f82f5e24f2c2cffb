"""Dense GEMM: C = A @ B (RowMatrix.multiply_local for the SVD's U and the
randomized SVD's Y = AZ, and TSQR's Q).

Replaces the TPU kernel ``src/repro/kernels/gemm.py:gemm``
(``_gemm_kernel``).  On the paths it runs skinny, (m × K) @ (K × N) with
N ≤ 32, where it is bound by the bytes of A.  ``csrc/gemm.cu`` is one
kernel for every operand the wrapper takes (A f32, bf16, float8_e4m3fn
or float8_e5m2, B f32 or bf16, any K, A starting anywhere): products on
the tensor cores (TF32 ``wgmma`` in exact splits: 3xTF32 for f32 × f32,
two products where one operand is bf16 or fp8 and the other f32, one for
bf16 or fp8 A × bf16 B; A
from registers, B's k-slice split by each block once a
stage into the K-major layout the wgmmas read), output tiles of 256 rows by
``tile_width(N)`` columns owned by one block across all of K (a persistent
grid, one block an SM), A's rows streamed through a ring of 16-byte
``cp.async`` copies of each row's 16-byte-aligned window, read back at the
row's shift.  Two runs give the same bits, and a row's bits do not depend
on m or on where A starts.

``gemm_plain`` is the same function in plain torch.  An fp8 C (the
reference's multiply_local and sketch keep A's type) is the f32 C cast by
dtypes.cast, on both routes.
"""
from __future__ import annotations

import torch

from . import _build, dtypes


def gemm_plain(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return dtypes.cast(a.float() @ b.float(), out_dtype)


def tile_width(n: int) -> int:
    """Columns of C an output tile holds for B of n columns: 8, 16 or 32
    (n8 mma tiles 1, 2 or 4), so that a narrow B spends no products on
    zero columns; n > 32 takes several tiles."""
    return 8 if n <= 8 else 16 if n <= 16 else 32


def gemm(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
         bn: int | None = None) -> torch.Tensor:
    """Launch csrc/gemm.cu on CUDA operands a (m × K), f32, bf16,
    float8_e4m3fn or float8_e5m2, contiguous and starting anywhere, and b
    (K × N), f32 or bf16; returns (m × N) in `out_dtype` (default
    a.dtype): the kernel writes f32 or bf16, and an fp8 C is its f32 C
    through dtypes.cast.  `bn`
    is the output tile's width (8, 16 or 32; default ``tile_width(N)``),
    the autotuner's choice (kernels/autotune.py)."""
    dev = _build.check_device(a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    b = b.contiguous()
    code = _build.dense_code(a, "a")
    out_dtype = out_dtype or a.dtype
    if out_dtype in dtypes.FP8:
        return dtypes.cast(gemm(a, b, out_dtype=torch.float32, bn=bn),
                        out_dtype)
    (m, k), n = a.shape, b.shape[1]
    bn = tile_width(n) if bn is None else bn
    if bn not in (8, 16, 32):
        raise ValueError(f"gemm's output tile takes 8, 16 or 32 columns, "
                         f"got {bn}")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    _build.check(_build.lib().repro_gemm(
        dev.index, a.data_ptr(), code, b.data_ptr(),
        _build.dtype_code(b, "b"), out.data_ptr(),
        _build.dtype_code(out, "out"), m, k, n, bn // 8,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        _build.stream(dev)), "gemm launch")
    gemm.launches += 1
    return out


gemm.launches = 0
