"""Tall-skinny Gram kernel: G = AᵀA for m ≫ n (RowMatrix.gram, the
Gram-mode SVD and PCA).

Replaces the TPU kernel ``src/repro/kernels/tsgram.py:tsgram``
(``_tsgram_kernel``).  On the H100 it is bound by operations: m·n·(n+1)
multiply-adds for the distinct entries against one read of A.
``csrc/tsgram.cu`` computes only the upper triangle of 64 × 64 output
tiles, splits the rows into slices so that tiles × slices fills the card,
keeps a 4 × 4 register tile per thread in f32 FMA, and sums the slices'
partial tiles in slice order in a second kernel that also mirrors the lower
triangle (the same bits on every run).

``tsgram_plain`` is the same function in plain torch.
"""
from __future__ import annotations

import torch

from . import _build

TILE = 64
CHUNK = 16
BLOCKS_PER_SM = 4
PARTIALS_BYTES = 256 << 20
# Rows one block sums into its f32 registers before it writes a partial:
# shorter sums round less (the error of a long f32 sum grows with its
# length), and the slice-order reduce adds the partials back.
SLICE_ROWS = 1 << 16


def tsgram_plain(a: torch.Tensor, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    af = a.float()
    return (af.T @ af).to(out_dtype)


def slicing(m: int, n: int, sms: int) -> tuple[int, int]:
    """(slices, rows_per_slice): enough row slices that tiles × slices
    reaches BLOCKS_PER_SM blocks per SM and no slice sums more than
    SLICE_ROWS rows, with the f32 partials under PARTIALS_BYTES and every
    slice non-empty."""
    tiles = -(-n // TILE)
    pairs = max(tiles * (tiles + 1) // 2, 1)
    chunks = max(-(-m // CHUNK), 1)
    want = max(-(-BLOCKS_PER_SM * sms // pairs), -(-m // SLICE_ROWS))
    cap = max(PARTIALS_BYTES // max(4 * n * n, 1), 1)
    slices = max(min(want, cap, chunks), 1)
    rows = -(-chunks // slices) * CHUNK
    return max(-(-m // rows), 1), rows


def tsgram(a: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Launch csrc/tsgram.cu on a contiguous CUDA (m × n) f32 or bf16
    operand; returns (n × n) in `out_dtype` (default a.dtype)."""
    dev = _build.check_device(a)
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError("a must be a contiguous (m, n) matrix")
    out_dtype = out_dtype or a.dtype
    m, n = a.shape
    out = torch.empty((n, n), dtype=out_dtype, device=dev)
    if n == 0:
        return out
    slices, rows = slicing(
        m, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty((slices, n, n), dtype=torch.float32, device=dev)
    lib = _build.lib()
    _build.check(lib.repro_tsgram(
        dev.index, a.data_ptr(), _build.dtype_code(a, "a"), m, n, slices,
        rows, part.data_ptr(), out.data_ptr(), _build.dtype_code(out, "out"),
        _build.stream(dev)), "tsgram launch")
    tsgram.launches += 1
    return out


tsgram.launches = 0
