"""Streaming cross-Gram kernel: B = AᵀQ for m ≫ r (RowMatrix.project, the
randomized SVD's projection).

Replaces the TPU kernel ``src/repro/kernels/randsketch.py:randsketch``
(``_randsketch_kernel``).  On the H100 it is bound by the bytes of A at the
main path's r = k + p ≤ 32 (2mnr flops against one read of A).
``csrc/randsketch.cu`` is one kernel for every A the wrapper takes (f32,
bf16, float8_e4m3fn or float8_e5m2, any width, any start, any row stride
with unit column stride): 3xTF32 products on the tensor cores
(``mma.sync``; Q split once into TF32 high and low parts by a first pass,
in the order the kernel stages it, ``split_q_plain``; bf16 and fp8 A are
exact in TF32 and take two products, one where Q was stored in bf16 or
fp8), 512 × 32 output tiles (A is read once while r ≤ 32),
A's rows streamed through a ring of 16-byte ``cp.async`` copies of each
row's 16-byte-aligned window, read back with the row's shift
(``window``); the rows cut into slices of at most SLICE_ROWS rows
(``slicing``), whose partial tiles a last pass sums in slice order (the
same bits on every run, and for an offset or strided view the same bits
as for its contiguous copy).  The chunked fused gradient passes its
column segments A[:, s0:s1] as they are: the kernel reads each row at its
stride.

``randsketch_plain`` is the same function in plain torch, which widens
bf16 and fp8 exactly.  An fp8 B is the f32 B cast by dtypes.cast, on both
routes.
"""
from __future__ import annotations

import math

import torch

from . import _build, dtypes

TILE_N, TILE_R = 512, 32       # columns of A and of Q a tile (randsketch.cu)
STAGE_ROWS = 32                # rows of A a staged chunk
PIECE_BYTES = 16               # the kernel copies A in 16-byte pieces
PARTIALS_BYTES = 256 << 20
# Rows one block sums into its f32 registers before it writes a partial
# (the error of a long f32 sum grows with its length).
SLICE_ROWS = 1 << 16
# Rows a slice holds at least, where m allows (a slice's ring of stages
# needs rows to overlap its copies with its products).
MIN_SLICE_ROWS = 512


# Q types exact in TF32: the kernel skips the products with Q's low parts.
Q_EXACT = (torch.bfloat16, torch.float16, *dtypes.FP8)


def randsketch_plain(a: torch.Tensor, q: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return dtypes.cast(a.float().T @ q.float(), out_dtype)


def window(p: int, n: int, vec: int, row: int, j0: int,
           lda: int | None = None) -> tuple[int, int, int]:
    """The kernel's staging of row `row`'s segment A[row, j0 : j0 + TILE_N]
    (cut at n) for an A whose element 0 lies `p` elements past a 16-byte
    boundary and whose rows lie `lda` elements apart (default n), with
    `vec` elements a 16-byte piece: (first piece, pieces, shift).  The
    stage copies pieces first .. first + pieces - 1, counted from that
    boundary, and element (row, j0 + j) is element shift + j of the
    copy."""
    first = p + row * (n if lda is None else lda) + j0
    shift = first % vec
    return first // vec, -(-(shift + min(TILE_N, n - j0)) // vec), shift


def _tf32_high(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: a TF32 value, and x minus it
    is exact in f32 (the kernel's split of each operand)."""
    return (x.contiguous().view(torch.int32) & ~((1 << 13) - 1)).view(
        torch.float32)


def split_q_plain(q: torch.Tensor) -> torch.Tensor:
    """Q as the kernel's first pass (randsketch_split_q) writes it, in plain
    torch: (blocks of STAGE_ROWS rows, Q tiles of TILE_R columns, k-steps,
    columns, lane rows t, 4) f32, zero past q's rows and columns.  Piece
    [b, ct, j, c, t] holds the high parts of Q[ra, col] and Q[rb, col], then
    their low parts, for ra = STAGE_ROWS b + j + 4 t, rb = ra + 16 and
    col = TILE_R ct + c: the rows one lane of a k-step multiplies, so each
    lane's B fragments are one 16-byte load."""
    q = q.float()
    m, r = q.shape
    blocks, tiles = max(-(-m // STAGE_ROWS), 1), max(-(-r // TILE_R), 1)
    full = q.new_zeros((blocks * STAGE_ROWS, tiles * TILE_R))
    full[:m, :r] = q
    hi = _tf32_high(full)
    parts = torch.stack([hi, full - hi])           # (hl, rows, cols)
    # rows = (b, h', t, j) with the row in the block 16 h' + 4 t + j;
    # cols = (ct, c).
    parts = parts.view(2, blocks, 2, 4, STAGE_ROWS // 8, tiles, TILE_R)
    return parts.permute(1, 5, 4, 6, 3, 0, 2).reshape(
        blocks, tiles, STAGE_ROWS // 8, TILE_R, 4, 4).contiguous()


def slicing(m: int, n: int, r: int, blocks: int) -> tuple[int, int]:
    """(slices, rows_per_slice) for `blocks` resident blocks on the card
    (its SMs, one block each): slices of whole stages, none longer than
    SLICE_ROWS rows or (where m allows) shorter than MIN_SLICE_ROWS, with
    the f32 partials under PARTIALS_BYTES and every slice non-empty; among
    those, the fewest slices whose tiles × slices blocks fill whole waves
    of `blocks`, else the best filled last wave."""
    tiles = max(-(-n // TILE_N) * -(-r // TILE_R), 1)
    chunks = max(-(-m // STAGE_ROWS), 1)
    lo = max(-(-m // SLICE_ROWS), 1)
    hi = max(min(-(-m // MIN_SLICE_ROWS),
                 PARTIALS_BYTES // max(4 * n * r, 1), chunks), lo)
    whole = blocks // math.gcd(tiles, blocks)   # slices a whole wave takes
    first = -(-lo // whole) * whole
    if first <= hi:
        want = first
    else:   # hi - lo < whole <= blocks: few candidates
        want = max(range(lo, hi + 1), key=lambda s: (
            tiles * s / (-(-tiles * s // blocks) * blocks), -s))
    rows = -(-chunks // want) * STAGE_ROWS
    return max(-(-m // rows), 1), rows


def randsketch(a: torch.Tensor, q: torch.Tensor, *,
               out_dtype=None) -> torch.Tensor:
    """Launch csrc/randsketch.cu on a CUDA a (m × n), f32, bf16,
    float8_e4m3fn or float8_e5m2, starting anywhere, its rows any stride
    apart and its columns adjacent (a column segment of a wider matrix as
    it is), and q (m × r); q is read as f32 (a copy, m·r·4 bytes, unless
    it is f32 and contiguous).  Returns (n × r) in `out_dtype` (default
    a.dtype): the kernel writes f32 or bf16, and an fp8 B is its f32 B
    through dtypes.cast."""
    dev = _build.check_device(a, q)
    if a.dim() != 2 or q.dim() != 2 or a.shape[0] != q.shape[0]:
        raise ValueError(f"shapes a {tuple(a.shape)}, q {tuple(q.shape)}")
    (m, n), r = a.shape, q.shape[1]
    if n > 1 and a.stride(1) != 1:
        raise ValueError("a's columns must be adjacent (unit column stride)")
    lda = a.stride(0) if m > 1 else n
    if not n <= lda < 1 << 31:
        raise ValueError(f"a's row stride {lda} for {n} columns: the "
                         "kernel takes n <= stride < 2^31")
    code = _build.dense_code(a, "a")
    out_dtype = out_dtype or a.dtype
    if out_dtype in dtypes.FP8:
        return dtypes.cast(randsketch(a, q, out_dtype=torch.float32),
                           out_dtype)
    out = torch.empty((n, r), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    q_exact = q.dtype in Q_EXACT
    q = q.float().contiguous()
    qs = torch.empty((max(-(-m // STAGE_ROWS), 1), -(-r // TILE_R),
                      STAGE_ROWS // 8, TILE_R, 4, 4), dtype=torch.float32,
                     device=dev)
    # One block an SM: a block's ring of stages takes most of its shared
    # memory.
    slices, rows = slicing(
        m, n, r, torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty((slices, n, r), dtype=torch.float32, device=dev)
    _build.check(_build.lib().repro_randsketch(
        dev.index, a.data_ptr(), code, lda, q.data_ptr(), int(q_exact), m, n,
        r, qs.data_ptr(), slices, rows, part.data_ptr(), out.data_ptr(),
        _build.dtype_code(out, "out"), _build.stream(dev)),
        "randsketch launch")
    randsketch.launches += 1
    return out


randsketch.launches = 0
