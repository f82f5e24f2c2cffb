"""Tall-skinny Gram kernel: G = AᵀA for m ≫ n (RowMatrix.gram, the
Gram-mode SVD and PCA, exact DIMSUM).

Replaces the TPU kernel ``src/repro/kernels/tsgram.py:tsgram``
(``_tsgram_kernel``).  On the H100 it is bound by operations: m·n·(n+1)
flops for the distinct entries against one read of A.  ``csrc/tsgram.cu``
takes every A the wrapper takes (f32, bf16, float8_e4m3fn or float8_e5m2,
any width, any start): products on the tensor cores (f32 as 3xTF32 on
``wgmma``, B's TF32 split written K-major into shared memory by a register
pass; bf16 in one bf16 ``mma.sync`` product; fp8 on the bf16 route's
staging, each
fragment pair converted to f16 as it is packed, one f16 ``mma.sync``
product), only the upper triangle of 128 × 128 output tiles,
A's rows streamed through a ring of 16-byte ``cp.async`` copies of each
row's 16-byte-aligned window and read back at the row's shift
(``window``), in the K order ``kstep_rows`` gives, from the staging slots
``slot`` gives.  The rows are cut into slices (``slicing``) whose partial
tiles a last pass sums in slice order, mirroring the lower triangle (the
same bits on every run, and for an offset view the same bits as for its
aligned copy).

``tsgram_plain`` is the same function in plain torch.  An fp8 G (the
reference's default out_dtype for fp8 A) is the f32 G cast by
dtypes.cast, on both routes.
"""
from __future__ import annotations

import math

import torch

from . import _build, dtypes

TILE = 128                     # output tile: columns of A by columns
STAGE_ROWS = 32                # rows of A a staged chunk
PARTIALS_BYTES = 256 << 20
# Rows one block sums into its f32 registers before it writes a partial
# (the error of a long f32 sum grows with its length); the partials cap
# wins over it at wide n.
SLICE_ROWS = 1 << 16
# Rows a slice holds at least, where m allows (a slice's ring of stages
# needs rows to overlap its copies with its products).
MIN_SLICE_ROWS = 512


def tsgram_plain(a: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """AᵀA in f32, one library product a slice of SLICE_ROWS rows and the
    slices' Grams added in order, as the kernel sums its slices: one f32
    product over all of A's rows drops the small terms once the running
    diagonal is large (1e-3 of the diagonal at 2²¹ e4m3 rows, where the
    kernel is within 1e-7 of float64; e5m2 alike)."""
    out_dtype = out_dtype or a.dtype
    g = None
    for i in range(0, max(a.shape[0], 1), SLICE_ROWS):
        af = a[i:i + SLICE_ROWS].float()
        g = af.T @ af if g is None else g.add_(af.T @ af)
    return dtypes.cast(g, out_dtype)


def window(p: int, n: int, vec: int, row: int, c0: int
           ) -> tuple[int, int, int, int]:
    """The kernel's staging of row `row`'s segment A[row, c0 : c0 + TILE]
    for an A whose element 0 lies `p` elements past a 16-byte boundary,
    with `vec` elements a 16-byte piece: (first piece, pieces, shift, end).
    The stage copies pieces first .. first + pieces - 1, counted from that
    boundary, as many as the tile's width spans; it reads their elements
    before `end` (all of them, unless the tile reaches past A's last column)
    and writes zeros from there on; element (row, c0 + c) is element
    shift + c of the copy.  c0 is a multiple of TILE, so the shift is the
    row's alone."""
    first = p + row * n + c0
    shift = first % vec
    pieces = -(-(shift + TILE) // vec)
    end = pieces * vec if c0 + TILE <= n else shift + n - c0
    return first // vec, pieces, shift, end


def kstep_rows(vec: int) -> list[list[int]]:
    """The stage rows each k-step of the kernel multiplies, in K order: f32
    (vec 4, mma m16n8k8) k-step j takes row j + 4 kk at K index kk; bf16
    (vec 8, m16n8k16) k-step j takes row 8t + b + 2h + 4j at K index
    2t + b + 8h.  The rows one shared load of a warp reads (one a lane
    group t) are 4 (f32) or 8 (bf16) apart, so they share a shift."""
    if vec == 4:
        return [[j + 4 * kk for kk in range(8)]
                for j in range(STAGE_ROWS // 8)]
    order = [0] * 16
    for t in range(4):
        for b in range(2):
            for h in range(2):
                order[2 * t + b + 8 * h] = 8 * t + b + 2 * h
    return [[r + 4 * j for r in order] for j in range(STAGE_ROWS // 16)]


def slot(k: int, vec: int) -> int:
    """The staging slot of stage row k (tsgram.cu:slot): the rows one
    shared load reads sit in adjacent slots, 8 banks apart."""
    if vec == 4:
        return (k & 3) * (STAGE_ROWS // 4) + (k >> 2)
    return (k & 7) * (STAGE_ROWS // 8) + (k >> 3)


def slicing(m: int, n: int, blocks: int) -> tuple[int, int]:
    """(slices, rows_per_slice) for `blocks` resident blocks on the card
    (its SMs, one block each): slices of whole stages, with the f32
    partials under PARTIALS_BYTES, none shorter than MIN_SLICE_ROWS where m
    allows and, where the partials allow, none longer than SLICE_ROWS,
    every slice non-empty; among those, the fewest slices whose
    pairs × slices blocks fill whole waves of `blocks`, else the best
    filled last wave."""
    tiles = -(-n // TILE)
    pairs = max(tiles * (tiles + 1) // 2, 1)
    chunks = max(-(-m // STAGE_ROWS), 1)
    cap = max(min(PARTIALS_BYTES // max(4 * n * n, 1), chunks,
                  -(-m // MIN_SLICE_ROWS)), 1)
    lo = min(max(-(-m // SLICE_ROWS), 1), cap)
    whole = blocks // math.gcd(pairs, blocks)   # slices a whole wave takes
    first = -(-lo // whole) * whole
    if first <= cap:
        want = first
    else:   # cap - lo < whole <= blocks: few candidates
        want = max(range(lo, cap + 1), key=lambda s: (
            pairs * s / (-(-pairs * s // blocks) * blocks), -s))
    rows = -(-chunks // want) * STAGE_ROWS
    return max(-(-m // rows), 1), rows


def tsgram(a: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Launch csrc/tsgram.cu on a contiguous CUDA (m × n) f32, bf16,
    float8_e4m3fn or float8_e5m2 operand starting anywhere; returns
    (n × n) in `out_dtype` (default a.dtype; the kernel writes f32 or
    bf16, and an fp8 G is its f32 G through dtypes.cast)."""
    dev = _build.check_device(a)
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError("a must be a contiguous (m, n) matrix")
    code = _build.dense_code(a, "a")
    out_dtype = out_dtype or a.dtype
    if out_dtype in dtypes.FP8:
        return dtypes.cast(tsgram(a, out_dtype=torch.float32), out_dtype)
    m, n = a.shape
    out = torch.empty((n, n), dtype=out_dtype, device=dev)
    if n == 0:
        return out
    # One block an SM: a block's registers hold a 128 x 128 tile's running
    # f32 totals and its tensor-core accumulators.
    slices, rows = slicing(
        m, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty((slices, n, n), dtype=torch.float32, device=dev)
    lib = _build.lib()
    _build.check(lib.repro_tsgram(
        dev.index, a.data_ptr(), code, m, n, slices,
        rows, part.data_ptr(), out.data_ptr(), _build.dtype_code(out, "out"),
        _build.stream(dev)), "tsgram launch")
    tsgram.launches += 1
    return out


tsgram.launches = 0
