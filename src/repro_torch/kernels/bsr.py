"""Block-sparse (BlockELL) × dense products: the layout and three kernels.

Counterpart of src/repro/kernels/bsr.py.  A BlockELL matrix stores every
block-row as a fixed number `ell` of (bs × bs) blocks with their block
columns in `cols`; padding slots are zero blocks at column 0, so they add
nothing.  int8 storage carries a per-block f32 scale (the stored block is
``data[i, s] * scales[i, s]``); f32 and bf16 storage carry none.

Three kernels share the layout, each a hand-written CUDA kernel for sm_90a
in ``csrc/`` with its plain torch version beside it:

  * ``bsr_matvec``  — y = A x   (``csrc/bsr_spmv.cu``);
  * ``bsr_matmul``  — Y = A X   (``csrc/bsr_spmm.cu``), X rows gathered
    by block column into a ring of shared-memory stages beside the stored
    blocks (``matmul_plan``), each output one thread's sum in an order
    fixed by A's shape, so a column's bits do not depend on nx;
  * ``bsr_rmatmul`` — Y = AᵀX   (``csrc/bsr_rmatmul.cu``).  The TPU kernel
    scatter-adds into a resident accumulator on a sequential grid; here
    the scatter becomes a gather over a column-major index of the block
    pattern (``ColumnIndex``: chunks of one column), built once on the
    device and cached on the BlockELL, so every output sum runs in an
    order fixed by the pattern; the products run on the tensor cores
    (3xTF32, ``rmatmul_plan``), and a column's bits do not depend on nx.

All three upcast what they load, apply the int8 scale and sum in f32, and
each launch adds one to its wrapper's ``launches``.  ``*_plain`` are the
same functions in plain torch (the counterparts of the reference's
``*_jnp`` forms, flops ∝ stored blocks): the CPU path, and what the kernels
are held against on the card.  The densifying oracles are in ``ref.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from . import _build

BS_CANDIDATES = (8, 16, 32, 64, 128)
# Slots of one block column that the rmatmul kernel sums before writing a
# partial (a unit of its work): bounds the work of a hot column's unit.
# csrc/bsr_rmatmul.cu stages a unit's index lists for at most this many
# (kMaxChunk).
RMATMUL_CHUNK = 32
# bsr_rmatmul's launch plan (csrc/bsr_rmatmul.cu): warps a block, 16 x 8
# output tiles a warp at most, stages of the ring at most, and the shared
# memory its ring may take: a quarter of an SM's for tiles up to 32
# columns (four blocks an SM), half for wider ones (two: their registers
# allow no more).
RMATMUL_WARPS = 4
RMATMUL_TILES_PER_WARP = 8
RMATMUL_MAX_STAGES = 8
RMATMUL_RING_BUDGET = {False: 57344, True: 114688}
# bsr_matmul's launch plan (csrc/bsr_spmm.cu): at most MATMUL_THREADS a
# block, MATMUL_MAX_TILE output columns a tile, MATMUL_MAX_STAGES stages;
# shared memory a block may use, and an SM's.
MATMUL_THREADS = 256
MATMUL_MAX_TILE = 32
MATMUL_MAX_STAGES = 4
SMEM_BLOCK_MAX = 232448
SMEM_SM = 233472


def auto_quantize(m: int, n: int, ell: int, bs: int, tol: float,
                  backend: str | None = None) -> str:
    """quantize="auto"'s answer for an (m × n) BlockELL of `ell` stored
    bs × bs blocks a block-row: "int8" iff plan("sparse_matmul", ...,
    context={"tol": tol}) picks the int8 precision, else "none"."""
    from repro_torch.launch import planner
    p = planner.plan("sparse_matmul",
                     {"m": m, "n": n, "nx": 1, "ell": ell, "bs": bs},
                     backend=backend, context={"tol": float(tol)})
    return "int8" if p.precision == "int8" else "none"


@dataclass(frozen=True)
class MatmulPlan:
    """How csrc/bsr_spmm.cu runs Y = A X: output tiles of `nt` columns
    (`ntiles` of them across nx), units of `br` block-rows, one thread per
    4 × 4 outputs (`threads` a block), a ring of `stages` stages of
    `stage_bytes` each (`smem` in all), and a persistent grid of `grid`
    blocks."""
    nt: int
    ntiles: int
    br: int
    threads: int
    stages: int
    stage_bytes: int
    smem: int
    grid: int


def _matmul_stage_bytes(bs: int, itemsize: int, br: int, nt: int) -> int:
    """One stage of bsr_spmm.cu (its Layout and stage_bytes): br stored
    blocks, each row (or 16-byte chunk of rows) followed by 16 bytes and
    each block by 16 more; the gathered X rows, br × bs × nt f32; br f32
    scales, in whole 16-byte pieces."""
    row = bs * itemsize
    chunk = max(row, 16)
    block = (bs * row // chunk) * (chunk + 16) + 16
    return br * block + br * bs * nt * 4 + -(-4 * br // 16) * 16


def matmul_plan(nbr: int, bs: int, nx: int, itemsize: int,
                sms: int) -> MatmulPlan:
    """bsr_matmul's launch plan for `nbr` block-rows of bs × bs blocks of
    `itemsize` bytes, nx columns of X and `sms` SMs.  The tile is the
    power of two >= nx, at least 4 and at most MATMUL_MAX_TILE, so one tile
    (one read of the stored blocks) serves every nx <= 32.  A unit takes as
    many block-rows as MATMUL_THREADS threads hold, fewer where two stages
    would not fit; the ring has as many stages as fit, up to
    MATMUL_MAX_STAGES.  The plan decides where each output is computed,
    never the order of its sum."""
    nt = 4
    while nt < min(nx, MATMUL_MAX_TILE):
        nt *= 2
    per_row = (bs // 4) * (nt // 4)     # threads a block-row
    br = MATMUL_THREADS // per_row
    while br > 1 and 2 * _matmul_stage_bytes(bs, itemsize, br, nt) \
            > SMEM_BLOCK_MAX:
        br //= 2
    stage = _matmul_stage_bytes(bs, itemsize, br, nt)
    stages = min(MATMUL_MAX_STAGES, SMEM_BLOCK_MAX // stage)
    threads = br * per_row
    ntiles = -(-nx // nt)
    per_sm = max(1, min(SMEM_SM // (stages * stage + 1024), 2048 // threads))
    units = -(-nbr // br) * ntiles
    return MatmulPlan(nt, ntiles, br, threads, stages, stage, stages * stage,
                      max(1, min(units, per_sm * sms)))


@dataclass(frozen=True)
class RmatmulPlan:
    """How csrc/bsr_rmatmul.cu runs Y = AᵀX: output tiles of `nt` columns
    (`ntiles` of them across nx); a ring of `stages` stages of
    `stage_bytes` each (`smem` in all), a stage holding one stored block
    at `row_stride` bytes a row, nt columns of its X slab at `x_stride`
    floats a row and 16 bytes for its int8 scale."""
    nt: int
    ntiles: int
    row_stride: int
    x_stride: int
    stages: int
    stage_bytes: int
    smem: int


def rmatmul_row_stride(row_bytes: int, elem: int) -> int:
    """The staged row stride (bytes) of bsr_rmatmul.cu (its row_stride): the
    row itself below 16 bytes, else the least whole number of 16-byte
    pieces, at least the row, at which the 4 rows and 8 consecutive
    elements (of `elem` bytes) one fragment load reads fall on distinct
    shared-memory banks (32 of 4 bytes)."""
    if row_bytes < 16:
        return row_bytes
    foot = 8 * elem
    s = row_bytes
    while True:
        gaps = [((b - a) * s) % 128 for a in range(4) for b in range(a + 1, 4)]
        if all(foot <= d <= 128 - foot for d in gaps):
            return s
        s += 16


def rmatmul_plan(bs: int, nx: int, itemsize: int) -> RmatmulPlan:
    """bsr_rmatmul's launch plan for bs × bs blocks of `itemsize` bytes and
    nx columns of X.  The tile is the power of two >= nx, at least 8 (one
    n8 mma tile) and at most as wide as RMATMUL_WARPS warps of
    RMATMUL_TILES_PER_WARP 16 × 8 tiles hold (256 columns at bs <= 16, 128
    at 32, 64 at 64, 32 at 128); the ring has as many stages as fit its
    budget (RMATMUL_RING_BUDGET), two to RMATMUL_MAX_STAGES.  The plan
    decides which warp computes an output, never the order of its sum."""
    mt = max(1, bs // 16)
    nt_max = 8 * RMATMUL_WARPS * (RMATMUL_TILES_PER_WARP // mt)
    nt = 8
    while nt < min(nx, nt_max):
        nt *= 2
    row = rmatmul_row_stride(bs * itemsize, itemsize)
    x_stride = rmatmul_row_stride(4 * nt, 4) // 4
    stage = bs * row + 4 * bs * x_stride + 16
    stages = max(2, min(RMATMUL_MAX_STAGES,
                        RMATMUL_RING_BUDGET[nt > 32] // stage))
    return RmatmulPlan(nt, -(-nx // nt), row, x_stride, stages, stage,
                       stages * stage)


@dataclass(frozen=True)
class ColumnIndex:
    """The block pattern by column, for AᵀX as a gather: `order` lists the
    flat slots i*ell + s sorted by column (stable, so ascending i within a
    column), cut into chunks (`chunk_start`, `chunk_len`) of at most
    `chunk` slots of one column, in `order`'s order, which is the order the
    kernel runs them; block column j owns chunks col_chunks[j] ..
    col_chunks[j+1] − 1, in ascending rows; `rows` is the block-row of each
    slot of `order`.  It follows from the pattern alone.  All int32 on the
    BlockELL's device."""
    order: torch.Tensor
    chunk_start: torch.Tensor
    chunk_len: torch.Tensor
    col_chunks: torch.Tensor
    rows: torch.Tensor

    @property
    def nchunks(self) -> int:
        return self.chunk_start.shape[0]

    @staticmethod
    def build(cols: torch.Tensor, nbc: int,
              chunk: int = RMATMUL_CHUNK) -> "ColumnIndex":
        """The index of `cols` (nbr, ell) over `nbc` block columns."""
        flat = cols.reshape(-1).long()
        if flat.numel() and (int(flat.min()) < 0 or int(flat.max()) >= nbc):
            raise ValueError(f"block columns must lie in [0, {nbc})")
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=nbc)
        per_col = (counts + chunk - 1) // chunk
        col_chunks = torch.zeros(nbc + 1, dtype=torch.long, device=cols.device)
        col_chunks[1:] = torch.cumsum(per_col, 0)
        col_start = torch.cumsum(counts, 0) - counts
        nchunks = int(col_chunks[-1])
        owner = torch.repeat_interleave(
            torch.arange(nbc, device=cols.device), per_col,
            output_size=nchunks)
        rank = torch.arange(nchunks, device=cols.device) - col_chunks[owner]
        start = col_start[owner] + rank * chunk
        length = torch.clamp(counts[owner] - rank * chunk, max=chunk)
        i32 = torch.int32
        return ColumnIndex(order.to(i32), start.to(i32), length.to(i32),
                           col_chunks.to(i32),
                           (order // cols.shape[1]).to(i32))


@dataclass(frozen=True)
class BlockELL:
    """Fixed-width block-sparse rows: data[i, s] is the s-th stored block of
    block-row i, at block column cols[i, s] (padding blocks are zero with
    column 0).  ``scales`` (per stored block, f32) is set iff the data is
    int8; the stored block is then ``data[i, s] * scales[i, s]``."""
    data: torch.Tensor              # (n_block_rows, ell, bs, bs)
    cols: torch.Tensor              # (n_block_rows, ell) int32
    shape: tuple[int, int]
    scales: torch.Tensor | None = None    # (n_block_rows, ell) f32
    _cache: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    @property
    def bs(self) -> int:
        return self.data.shape[-1]

    @property
    def ell(self) -> int:
        return self.data.shape[1]

    @staticmethod
    def from_dense(a, bs: int, quantize: str = "none",
                   tol: float = 1e-3) -> "BlockELL":
        """Pack a dense (m × n) tensor into BlockELL, on its device, with the
        reference's layout: a stable sort packs each block-row's nonzero
        block columns into the leading slots in ascending order.

        ``quantize``: "none" keeps a.dtype; "int8" stores int8 blocks with
        per-block f32 scales; "auto" asks the planner: int8 iff
        plan("sparse_matmul", ..., context={"tol": tol}) picks the int8
        precision (the tolerance clears int8's guard and the modeled byte
        savings clear the floor)."""
        if quantize not in ("none", "int8", "auto"):
            raise ValueError(f"quantize must be 'none'|'int8'|'auto', "
                             f"got {quantize!r}")
        a = torch.as_tensor(a)
        m, n = a.shape
        if m % bs or n % bs:
            raise ValueError(f"shape {tuple(a.shape)} is not a multiple of "
                             f"bs={bs}")
        nbr, nbc = m // bs, n // bs
        blocks = a.reshape(nbr, bs, nbc, bs).permute(0, 2, 1, 3)
        nz = blocks.float().abs().sum(dim=(2, 3)) > 0          # (nbr, nbc)
        ell = max(int(nz.sum(1).max()), 1) if nbr else 1
        order = torch.argsort((~nz).to(torch.uint8), dim=1,
                              stable=True)[:, :ell]
        valid = torch.take_along_dim(nz, order, dim=1)         # (nbr, ell)
        cols = torch.where(valid, order, 0).to(torch.int32)
        rows = torch.arange(nbr, device=a.device)[:, None]
        data = blocks[rows, order] * valid[..., None, None].to(a.dtype)
        out = BlockELL(data.contiguous(), cols.contiguous(), (m, n))
        if quantize == "auto":
            quantize = auto_quantize(m, n, ell, bs, tol, a.device.type)
        return out.quantize_int8() if quantize == "int8" else out

    def quantize_int8(self) -> "BlockELL":
        """Int8 + per-block-scale form: scale = absmax/127 per stored block,
        data = round(block/scale).  Zero (padding) blocks get scale 1 so
        they stay exactly zero."""
        if self.scales is not None:
            return self
        q, scales = quantize_blocks(self.data)
        return BlockELL(q, self.cols, self.shape, scales)

    def dequantize(self) -> "BlockELL":
        """Exact-mode (f32 data, no scales) copy of this matrix."""
        if self.scales is None:
            return self
        return BlockELL(effective_data(self), self.cols, self.shape)

    def to_dense(self) -> torch.Tensor:
        m, n = self.shape
        data = effective_data(self)
        bs, nbr, ell = self.bs, data.shape[0], self.ell
        nbc = n // bs
        out = torch.zeros((nbr * nbc, bs, bs), dtype=data.dtype,
                          device=data.device)
        rows = torch.arange(nbr, device=data.device).repeat_interleave(ell)
        out.index_add_(0, rows * nbc + self.cols.reshape(-1).long(),
                       data.reshape(-1, bs, bs))
        return out.reshape(nbr, nbc, bs, bs).permute(0, 2, 1, 3).reshape(m, n)

    def density(self) -> float:
        return self.ell / (self.shape[1] // self.bs)

    def column_index(self) -> ColumnIndex:
        """The block pattern by column (ColumnIndex), built at first use on
        this matrix's device and cached."""
        if "column_index" not in self._cache:
            self._cache["column_index"] = ColumnIndex.build(
                self.cols, self.shape[1] // self.bs)
        return self._cache["column_index"]


def quantize_blocks(data: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 blocks, f32 scales) of (..., bs, bs) blocks: absmax/127 a block,
    round half to even, scale 1 for zero blocks."""
    d = data.float()
    absmax = d.abs().amax(dim=(-2, -1))
    scales = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.round(d / scales[..., None, None]).to(torch.int8)
    return q, scales.float()


def effective_data(a: BlockELL) -> torch.Tensor:
    """The stored blocks as the values they represent: int8 × per-block
    scale in f32, or the stored data as it is."""
    if a.scales is not None:
        return a.data.float() * a.scales[..., None, None]
    return a.data


def _slot_blocks(a: BlockELL, s: int) -> torch.Tensor:
    """Slot s of every block-row as f32 (nbr, bs, bs), scaled for int8."""
    d = a.data[:, s].float()
    return d * a.scales[:, s, None, None] if a.scales is not None else d


# -- plain torch versions (the CPU path and the kernels' yardstick) -----------

def bsr_matmul_plain(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """Y = A X, one batched product per slot over the gathered X blocks (the
    reference's bsr_matmul_jnp contraction, slot by slot); f32 sums, in
    x.dtype."""
    bs = a.bs
    nbr = a.data.shape[0]
    xb = x.float().reshape(a.shape[1] // bs, bs, -1)        # (nbc, bs, nx)
    y = torch.zeros((nbr, bs, xb.shape[-1]), dtype=torch.float32,
                    device=x.device)
    for s in range(a.ell):
        y += _slot_blocks(a, s) @ xb[a.cols[:, s].long()]
    return y.reshape(a.shape[0], -1).to(x.dtype)


def bsr_matvec_plain(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """y = A x (the reference's bsr_matvec_jnp), in x.dtype."""
    return bsr_matmul_plain(a, x[:, None])[:, 0]


def bsr_rmatmul_plain(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """Y = AᵀX: per-slot block partials Aᵢⱼᵀ Xᵢ, scatter-added over block
    columns (the reference's bsr_rmatmul_jnp); f32 sums, in x.dtype."""
    bs = a.bs
    nbr = a.data.shape[0]
    xr = x.float().reshape(nbr, bs, -1)                      # (nbr, bs, nx)
    out = torch.zeros((a.shape[1] // bs, bs, xr.shape[-1]),
                      dtype=torch.float32, device=x.device)
    for s in range(a.ell):
        out.index_add_(0, a.cols[:, s].long(),
                       _slot_blocks(a, s).transpose(1, 2) @ xr)
    return out.reshape(a.shape[1], -1).to(x.dtype)


# -- the kernels ---------------------------------------------------------------

def check_operands(a: BlockELL, *vectors: torch.Tensor
                   ) -> tuple[torch.device, int, torch.Tensor]:
    """Device, storage code and layout of a kernel's operands; returns the
    device, the storage code and the blocks to launch on: ``a.data``, or a
    fresh copy of it where it starts off a 16-byte boundary (the kernels
    load blocks in 16-byte pieces)."""
    dev = _build.check_device(a.data, a.cols, *vectors)
    code = _build.storage_code(a.data, "BlockELL data")
    nbr, ell, bs, bs2 = a.data.shape
    if bs != bs2 or bs not in BS_CANDIDATES:
        raise ValueError(f"blocks must be square with bs in {BS_CANDIDATES},"
                         f" got {tuple(a.data.shape[2:])}")
    if a.shape != (nbr * bs, a.shape[1]) or a.shape[1] % bs:
        raise ValueError(f"shape {a.shape} does not match data "
                         f"{tuple(a.data.shape)}")
    if a.cols.shape != (nbr, ell) or a.cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32 {(nbr, ell)}, got "
                         f"{a.cols.dtype} {tuple(a.cols.shape)}")
    if (a.scales is not None) != (a.data.dtype == torch.int8):
        raise ValueError("scales come with int8 data and only with it")
    if a.scales is not None and (a.scales.shape != (nbr, ell)
                                 or a.scales.dtype != torch.float32):
        raise ValueError("scales must be f32 (n_block_rows, ell)")
    for t in (a.data, a.cols) + (() if a.scales is None else (a.scales,)):
        if not t.is_contiguous():
            raise ValueError("BlockELL arrays must be contiguous")
    return dev, code, _build.aligned(a.data)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def bsr_matvec(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/bsr_spmv.cu: y = A x for a CUDA BlockELL A and x (n,),
    read as f32.  Returns f32 (m,).  Replaces the TPU kernel
    ``src/repro/kernels/bsr.py:bsr_matvec``."""
    dev, code, data = check_operands(a, x)
    if x.shape != (a.shape[1],):
        raise ValueError(f"x {tuple(x.shape)} against A {a.shape}")
    x = x.float().contiguous()
    y = torch.empty(a.shape[0], dtype=torch.float32, device=dev)
    nbr, ell = a.cols.shape
    _build.check(_build.lib().repro_bsr_spmv(
        dev.index, data.data_ptr(), code, _ptr(a.scales), a.cols.data_ptr(),
        nbr, ell, a.bs, x.data_ptr(), y.data_ptr(), _build.stream(dev)),
        "bsr_matvec launch")
    bsr_matvec.launches += 1
    return y


bsr_matvec.launches = 0


def padded_columns(x: torch.Tensor) -> torch.Tensor:
    """X as bsr_spmm.cu stages it in 16-byte pieces: `x` itself where its
    rows are whole pieces (nx a multiple of 4) and it starts on a 16-byte
    boundary, else a fresh copy with its columns padded by zeros to the next
    multiple of 4 (the kernel reads the padding, never writes it to Y)."""
    nx = x.shape[1]
    if nx % 4 == 0 and x.data_ptr() % 16 == 0:
        return x
    xp = x.new_zeros((x.shape[0], -(-nx // 4) * 4))
    xp[:, :nx] = x
    return xp


def bsr_matmul(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/bsr_spmm.cu: Y = A X for a CUDA BlockELL A and X (n, nx),
    read as f32.  Returns f32 (m, nx); column j has the same bits at any
    nx.  Replaces the TPU kernel ``src/repro/kernels/bsr.py:bsr_matmul``."""
    dev, code, data = check_operands(a, x)
    if x.dim() != 2 or x.shape[0] != a.shape[1] or x.shape[1] < 1:
        raise ValueError(f"X {tuple(x.shape)} against A {a.shape}")
    nx = x.shape[1]
    xp = padded_columns(x.float().contiguous())
    y = torch.empty((a.shape[0], nx), dtype=torch.float32, device=dev)
    nbr, ell = a.cols.shape
    plan = matmul_plan(
        nbr, a.bs, nx, data.element_size(),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    _build.check(_build.lib().repro_bsr_spmm(
        dev.index, data.data_ptr(), code, _ptr(a.scales), a.cols.data_ptr(),
        nbr, ell, a.bs, xp.data_ptr(), nx, xp.shape[1], plan.nt, plan.br,
        plan.stages, plan.smem, plan.grid, y.data_ptr(), _build.stream(dev)),
        "bsr_matmul launch")
    bsr_matmul.launches += 1
    return y


bsr_matmul.launches = 0


def bsr_rmatmul(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/bsr_rmatmul.cu: Y = AᵀX for a CUDA BlockELL A and
    X (m, nx), read as f32.  Returns f32 (n, nx); column j has the same bits
    at any nx.  Replaces both forms of the TPU kernel
    ``src/repro/kernels/bsr.py:bsr_rmatmul`` (the fused scatter and the
    partials + segment_sum), with no float atomics."""
    dev, code, data = check_operands(a, x)
    if x.dim() != 2 or x.shape[0] != a.shape[0] or x.shape[1] < 1:
        raise ValueError(f"X {tuple(x.shape)} against A {a.shape}")
    x = x.float().contiguous()
    nx = x.shape[1]
    idx = a.column_index()
    nbc = a.shape[1] // a.bs
    plan = rmatmul_plan(a.bs, nx, data.element_size())
    # X goes in 16-byte pieces where its rows are whole pieces on a 16-byte
    # boundary, else element by element (the same arithmetic).
    xvec = int(nx % 4 == 0 and x.data_ptr() % 16 == 0)
    part = torch.empty((max(idx.nchunks, 1), a.bs, nx), dtype=torch.float32,
                       device=dev)
    y = torch.empty((a.shape[1], nx), dtype=torch.float32, device=dev)
    _build.check(_build.lib().repro_bsr_rmatmul(
        dev.index, data.data_ptr(), code, _ptr(a.scales),
        idx.order.data_ptr(), idx.rows.data_ptr(), idx.chunk_start.data_ptr(),
        idx.chunk_len.data_ptr(), idx.col_chunks.data_ptr(), idx.nchunks, a.bs,
        nbc, x.data_ptr(), nx, xvec, plan.nt, plan.stages, plan.smem,
        part.data_ptr(), y.data_ptr(), _build.stream(dev)),
        "bsr_rmatmul launch")
    bsr_rmatmul.launches += 1
    return y


bsr_rmatmul.launches = 0

