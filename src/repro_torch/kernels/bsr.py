"""Block-sparse (BlockELL) × dense products: the layout and three kernels.

Counterpart of src/repro/kernels/bsr.py.  A BlockELL matrix stores every
block-row as a fixed number `ell` of (bs × bs) blocks with their block
columns in `cols`; padding slots are zero blocks at column 0, so they add
nothing.  int8 storage carries a per-block f32 scale (the stored block is
``data[i, s] * scales[i, s]``); f32 and bf16 storage carry none.

Three kernels share the layout, each a hand-written CUDA kernel for sm_90a
in ``csrc/`` with its plain torch version beside it:

  * ``bsr_matvec``  — y = A x   (``csrc/bsr_spmv.cu``);
  * ``bsr_matmul``  — Y = A X   (``csrc/bsr_spmm.cu``), X blocks gathered
    by column;
  * ``bsr_rmatmul`` — Y = AᵀX   (``csrc/bsr_rmatmul.cu``).  The TPU kernel
    scatter-adds into a resident accumulator on a sequential grid; here
    the scatter becomes a gather over a column-major index of the block
    pattern (``ColumnIndex``), built once on the device and cached on the
    BlockELL, so every output sum runs in an order fixed by the pattern.

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
PLANNER_ITEM = "ROADMAP queue 1 item 11 (planner)"
# Slots of one block column that one block of the rmatmul kernel sums
# before writing a partial: bounds the work of a hot column's block.
RMATMUL_CHUNK = 32


@dataclass(frozen=True)
class ColumnIndex:
    """The block pattern by column, for AᵀX as a gather: `order` lists the
    flat slots i*ell + s sorted by column (stable, so ascending i within a
    column), cut into chunks of at most RMATMUL_CHUNK slots (`chunk_start`,
    `chunk_len`); block column j owns chunks col_chunks[j] ..
    col_chunks[j+1] − 1.  All int32 on the BlockELL's device."""
    order: torch.Tensor
    chunk_start: torch.Tensor
    chunk_len: torch.Tensor
    col_chunks: torch.Tensor

    @property
    def nchunks(self) -> int:
        return self.chunk_start.shape[0]

    @staticmethod
    def build(cols: torch.Tensor, nbc: int,
              chunk: int = RMATMUL_CHUNK) -> "ColumnIndex":
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
                           col_chunks.to(i32))


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
    def from_dense(a, bs: int, quantize: str = "none") -> "BlockELL":
        """Pack a dense (m × n) tensor into BlockELL, on its device, with the
        reference's layout: a stable sort packs each block-row's nonzero
        block columns into the leading slots in ascending order.

        ``quantize``: "none" keeps a.dtype; "int8" stores int8 blocks with
        per-block f32 scales; "auto" (the planner's choice) raises until
        the planner is ported."""
        if quantize == "auto":
            raise NotImplementedError(f"quantize='auto' waits for "
                                      f"{PLANNER_ITEM}")
        if quantize not in ("none", "int8"):
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

def check_operands(a: BlockELL, *vectors: torch.Tensor) -> tuple[torch.device, int]:
    """Device, storage code and layout of a kernel's operands."""
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
    if a.data.data_ptr() % 16:
        raise ValueError("BlockELL data must be 16-byte aligned")
    return dev, code


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def bsr_matvec(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/bsr_spmv.cu: y = A x for a CUDA BlockELL A and x (n,),
    read as f32.  Returns f32 (m,).  Replaces the TPU kernel
    ``src/repro/kernels/bsr.py:bsr_matvec``."""
    dev, code = check_operands(a, x)
    if x.shape != (a.shape[1],):
        raise ValueError(f"x {tuple(x.shape)} against A {a.shape}")
    x = x.float().contiguous()
    y = torch.empty(a.shape[0], dtype=torch.float32, device=dev)
    nbr, ell = a.cols.shape
    _build.check(_build.lib().repro_bsr_spmv(
        dev.index, a.data.data_ptr(), code, _ptr(a.scales), a.cols.data_ptr(),
        nbr, ell, a.bs, x.data_ptr(), y.data_ptr(), _build.stream(dev)),
        "bsr_matvec launch")
    bsr_matvec.launches += 1
    return y


bsr_matvec.launches = 0


def bsr_matmul(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/bsr_spmm.cu: Y = A X for a CUDA BlockELL A and X (n, nx),
    read as f32.  Returns f32 (m, nx).  Replaces the TPU kernel
    ``src/repro/kernels/bsr.py:bsr_matmul``."""
    dev, code = check_operands(a, x)
    if x.dim() != 2 or x.shape[0] != a.shape[1] or x.shape[1] < 1:
        raise ValueError(f"X {tuple(x.shape)} against A {a.shape}")
    x = x.float().contiguous()
    nx = x.shape[1]
    y = torch.empty((a.shape[0], nx), dtype=torch.float32, device=dev)
    nbr, ell = a.cols.shape
    _build.check(_build.lib().repro_bsr_spmm(
        dev.index, a.data.data_ptr(), code, _ptr(a.scales), a.cols.data_ptr(),
        nbr, ell, a.bs, x.data_ptr(), nx, y.data_ptr(), _build.stream(dev)),
        "bsr_matmul launch")
    bsr_matmul.launches += 1
    return y


bsr_matmul.launches = 0


def bsr_rmatmul(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/bsr_rmatmul.cu: Y = AᵀX for a CUDA BlockELL A and
    X (m, nx), read as f32.  Returns f32 (n, nx).  Replaces both forms of
    the TPU kernel ``src/repro/kernels/bsr.py:bsr_rmatmul`` (the fused
    scatter and the partials + segment_sum), with no float atomics."""
    dev, code = check_operands(a, x)
    if x.dim() != 2 or x.shape[0] != a.shape[0] or x.shape[1] < 1:
        raise ValueError(f"X {tuple(x.shape)} against A {a.shape}")
    x = x.float().contiguous()
    nx = x.shape[1]
    idx = a.column_index()
    nbc = a.shape[1] // a.bs
    part = torch.empty((max(idx.nchunks, 1), a.bs, nx), dtype=torch.float32,
                       device=dev)
    y = torch.empty((a.shape[1], nx), dtype=torch.float32, device=dev)
    _build.check(_build.lib().repro_bsr_rmatmul(
        dev.index, a.data.data_ptr(), code, _ptr(a.scales),
        idx.order.data_ptr(), idx.chunk_start.data_ptr(),
        idx.chunk_len.data_ptr(), idx.col_chunks.data_ptr(), idx.nchunks,
        a.ell, a.bs, nbc, x.data_ptr(), nx, part.data_ptr(), y.data_ptr(),
        _build.stream(dev)), "bsr_rmatmul launch")
    bsr_rmatmul.launches += 1
    return y


bsr_rmatmul.launches = 0

