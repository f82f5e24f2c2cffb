"""Streaming cross-Gram kernel: B = AᵀQ for m ≫ r (RowMatrix.project, the
randomized SVD's projection).

Replaces the TPU kernel ``src/repro/kernels/randsketch.py:randsketch``
(``_randsketch_kernel``).  On the H100 it is bound by the bytes of A at the
main path's r = k + p ≤ 32 (2mnr flops against one read of A).
``csrc/randsketch.cu`` cuts the (n × r) output into 128 × 32 tiles, so A
is read once while r ≤ 32; splits the rows into slices of at most
SLICE_ROWS rows, enough that tiles × slices fills the card; keeps a 4 × 4
register tile per thread in f32 FMA; and sums the slices' partial tiles in
slice order in a second kernel (the same bits on every run).

``randsketch_plain`` is the same function in plain torch.
"""
from __future__ import annotations

import torch

from . import _build

TILE_N, TILE_R, CHUNK = 128, 32, 16
BLOCKS_PER_SM = 4
PARTIALS_BYTES = 256 << 20
# Rows one block sums into its f32 registers before it writes a partial
# (the error of a long f32 sum grows with its length).
SLICE_ROWS = 1 << 16


def randsketch_plain(a: torch.Tensor, q: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return (a.float().T @ q.float()).to(out_dtype)


def slicing(m: int, n: int, r: int, sms: int) -> tuple[int, int]:
    """(slices, rows_per_slice): enough row slices that tiles × slices
    reaches BLOCKS_PER_SM blocks per SM and no slice sums more than
    SLICE_ROWS rows, with the f32 partials under PARTIALS_BYTES and every
    slice non-empty."""
    tiles = max(-(-n // TILE_N) * -(-r // TILE_R), 1)
    chunks = max(-(-m // CHUNK), 1)
    want = max(-(-BLOCKS_PER_SM * sms // tiles), -(-m // SLICE_ROWS))
    cap = max(PARTIALS_BYTES // max(4 * n * r, 1), 1)
    slices = max(min(want, cap, chunks), 1)
    rows = -(-chunks // slices) * CHUNK
    return max(-(-m // rows), 1), rows


def randsketch(a: torch.Tensor, q: torch.Tensor, *,
               out_dtype=None) -> torch.Tensor:
    """Launch csrc/randsketch.cu on a contiguous CUDA a (m × n), f32 or
    bf16, and q (m × r); q is read as f32.  Returns (n × r) in `out_dtype`
    (default a.dtype)."""
    dev = _build.check_device(a, q)
    if a.dim() != 2 or q.dim() != 2 or a.shape[0] != q.shape[0]:
        raise ValueError(f"shapes a {tuple(a.shape)}, q {tuple(q.shape)}")
    if not a.is_contiguous():
        raise ValueError("a must be a contiguous (m, n) matrix")
    code = _build.dtype_code(a, "a")
    q = q.float().contiguous()
    out_dtype = out_dtype or a.dtype
    (m, n), r = a.shape, q.shape[1]
    out = torch.empty((n, r), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    slices, rows = slicing(
        m, n, r, torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty((slices, n, r), dtype=torch.float32, device=dev)
    lib = _build.lib()
    _build.check(lib.repro_randsketch(
        dev.index, a.data_ptr(), code, q.data_ptr(), m, n, r, slices, rows,
        part.data_ptr(), out.data_ptr(), _build.dtype_code(out, "out"),
        _build.stream(dev)), "randsketch launch")
    randsketch.launches += 1
    return out


randsketch.launches = 0
