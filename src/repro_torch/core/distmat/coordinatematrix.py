"""CoordinateMatrix: a COO matrix on one device (paper §2.2).

Counterpart of src/repro/core/distmat/coordinatematrix.py.  "Should be used
only when both dimensions of the matrix are huge and the matrix is very
sparse."  The RDD[MatrixEntry] is three 1-D tensors (row, col, value); the
reference shards them over the entries and sums a psum, here there is one
shard.  matvec and rmatvec, what Lanczos needs, are a gather and a segment
sum, the reference's `segment_sum`: `create` sorts the entries by row once
and keeps a second copy of them sorted by column, so each product sums
every output's entries with `torch.segment_reduce` over contiguous runs, in
the same order every call.  (A scatter with `index_add_` sums with atomics
on the card: its bits vary between calls and a hot column's long chain of
f32 adds loses digits, enough that Lanczos stopped short of its tolerance;
see tools/diagnose_coo.py.)  The transpose swaps the index tensors and the
two sorted copies.  `to_sparse_row_matrix` bins the entries into the
block-sparse type (SparseRowMatrix.from_entries) on the same device, whose
products run the bsr_* kernels.

Differences from the reference: `create` takes `device=` (the card unless
the caller asks for the CPU) in the place of `mesh=`, and stores the
entries sorted by row.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from . import types as T


def _offsets(key: torch.Tensor, n: int) -> torch.Tensor:
    """Where each of the n runs of the entries sorted by `key` starts."""
    counts = torch.bincount(key.long(), minlength=n)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


@dataclass(frozen=True)
class _Segments:
    """The entries sorted by one index: output i sums the entries
    offsets[i]:offsets[i + 1], each a value times the input at `other`."""
    offsets: torch.Tensor           # (outputs + 1,) int64
    other: torch.Tensor             # (nnz,) int32, the other index
    values: torch.Tensor            # (nnz,)

    @staticmethod
    def build(key, other, values, n: int) -> "_Segments":
        """Entries with `key` in [0, n), sorted by it (stable)."""
        order = torch.sort(key, stable=True).indices
        return _Segments(_offsets(key, n), other[order], values[order])

    def product(self, v: torch.Tensor) -> torch.Tensor:
        va = self.values.to(torch.promote_types(self.values.dtype, v.dtype))
        return torch.segment_reduce(va * v.index_select(0, self.other),
                                    "sum", offsets=self.offsets)


@dataclass(frozen=True)
class CoordinateMatrix(T.DistMatrix):
    row_idx: torch.Tensor           # (nnz,) int32, sorted
    col_idx: torch.Tensor           # (nnz,) int32
    values: torch.Tensor            # (nnz,) float32 or bfloat16
    dims: tuple[int, int]
    nnz: int
    by_row: _Segments = field(repr=False)   # shares col_idx and values
    by_col: _Segments = field(repr=False)

    @staticmethod
    def create(row_idx, col_idx, values, shape: tuple[int, int], *,
               device="cuda", mesh=None) -> "CoordinateMatrix":
        """The entries on `device`; a `mesh` of more than one rank raises
        (ROADMAP queue 1 item 13)."""
        dev = T.resolve_device(T.one_device(mesh, device,
                                            "CoordinateMatrix"))
        va = T.as_float_tensor(values, dev)
        ri = torch.as_tensor(row_idx, device=dev).to(torch.int32)
        ci = torch.as_tensor(col_idx, device=dev).to(torch.int32)
        m, n = int(shape[0]), int(shape[1])
        order = torch.sort(ri, stable=True).indices
        ri, ci, va = ri[order], ci[order], va[order]
        return CoordinateMatrix(ri, ci, va, dims=(m, n), nnz=int(va.shape[0]),
                                by_row=_Segments(_offsets(ri, m), ci, va),
                                by_col=_Segments.build(ci, ri, va, n))

    @property
    def shape(self) -> tuple[int, int]:
        return self.dims

    @property
    def device(self) -> torch.device:
        return self.values.device

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """A v: gather v at the column indices, sum each row's run."""
        return self.by_row.product(v)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        """Aᵀ u: the same over the entries sorted by column."""
        return self.by_col.product(u)

    def frobenius_norm(self) -> torch.Tensor:
        va = self.values.float()
        return torch.sqrt((va * va).sum())

    def transpose(self) -> "CoordinateMatrix":
        """Aᵀ by swapping the index tensors and the two sorted copies: no
        copy.  The SVD's route for wide inputs rides on this."""
        return CoordinateMatrix(self.col_idx, self.row_idx, self.values,
                                dims=(self.dims[1], self.dims[0]),
                                nnz=self.nnz, by_row=self.by_col,
                                by_col=self.by_row)

    # -- conversions (paper: toIndexedRowMatrix) ----------------------------
    def to_indexed_row_matrix(self):
        """The rows that hold an entry, densified (a small-scale conversion,
        as in the reference)."""
        from .rowmatrix import IndexedRowMatrix
        uniq, inv = torch.unique(self.row_idx.long(), return_inverse=True)
        dense = self.values.new_zeros((uniq.shape[0], self.dims[1]))
        dense.index_put_((inv, self.col_idx.long()), self.values,
                         accumulate=True)
        return IndexedRowMatrix.create(uniq, dense, device=self.device)

    def to_sparse_row_matrix(self, bs: int | str = "auto"):
        """Block-compress into the block-sparse row type: the entries are
        binned into (block-row, block-column) blocks on this device."""
        from .sparserow import SparseRowMatrix
        return SparseRowMatrix.from_entries(self.row_idx, self.col_idx,
                                            self.values, self.dims, bs=bs,
                                            device=self.device)

    def to_block_matrix(self, block_rows: int, block_cols: int):
        from .blockmatrix import BlockMatrix
        return BlockMatrix.create(self.to_local(), device=self.device,
                                  block_rows=block_rows,
                                  block_cols=block_cols)

    def to_local(self) -> torch.Tensor:
        out = self.values.new_zeros(self.dims)
        return out.index_put_((self.row_idx.long(), self.col_idx.long()),
                              self.values, accumulate=True)
