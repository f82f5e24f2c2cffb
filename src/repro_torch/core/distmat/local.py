"""Local vectors and matrices (paper §2.4 and §4.2).

Counterpart of src/repro/core/distmat/local.py: MLlib's sparse local vector
and its Compressed Column Storage matrix, whose SpMV and SpMM are a gather
and an `index_add_` (the reference's `segment_sum`).  The block-sparse
kernels take BlockELL (kernels/bsr.py), not this layout.  Tensors live on
`device` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import types as T


def _segment_sum(values: torch.Tensor, segments: torch.Tensor,
                 n: int) -> torch.Tensor:
    out = values.new_zeros((n, *values.shape[1:]))
    return out.index_add_(0, segments, values)


@dataclass(frozen=True)
class SparseVector:
    size: int
    indices: torch.Tensor   # (nnz,) int32, sorted
    values: torch.Tensor    # (nnz,)

    @staticmethod
    def from_dense(v, *, device="cuda") -> "SparseVector":
        v = T.as_float_tensor(v, T.resolve_device(device))
        (idx,) = torch.nonzero(v, as_tuple=True)
        return SparseVector(int(v.shape[0]), idx.to(torch.int32), v[idx])

    def to_dense(self) -> torch.Tensor:
        out = self.values.new_zeros((self.size,))
        out[self.indices.long()] = self.values
        return out

    def dot(self, other: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.values * other.index_select(0, self.indices))


@dataclass(frozen=True)
class SparseMatrixCSC:
    """Compressed Column Storage as paper §4.2 describes it: row indices
    and values a nonzero, column extents in `col_ptr`."""
    shape: tuple[int, int]
    col_ptr: torch.Tensor    # (n+1,) int32
    row_idx: torch.Tensor    # (nnz,) int32
    values: torch.Tensor     # (nnz,)

    @staticmethod
    def from_dense(a, *, device="cuda") -> "SparseMatrixCSC":
        a = T.as_float_tensor(a, T.resolve_device(device))
        m, n = a.shape
        # Nonzeros of Aᵀ in row-major order: column by column, rows rising.
        cols, rows = torch.nonzero(a.T, as_tuple=True)
        counts = torch.bincount(cols, minlength=n)
        col_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        return SparseMatrixCSC((m, n), col_ptr.to(torch.int32),
                               rows.to(torch.int32), a[rows, cols])

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def device(self) -> torch.device:
        return self.values.device

    def _col_of_nnz(self) -> torch.Tensor:
        """Column index of each stored nonzero (from the col_ptr
        extents)."""
        pos = torch.arange(self.nnz, dtype=self.col_ptr.dtype,
                           device=self.device)
        return torch.searchsorted(self.col_ptr[1:], pos, right=True)

    def matvec(self, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        """SpMV (Aᵀx with transpose=True), as MLlib's kernels compute it."""
        col = self._col_of_nnz()
        if transpose:
            return _segment_sum(self.values * x.index_select(0, self.row_idx),
                                col, self.shape[1])
        return _segment_sum(self.values * x.index_select(0, col),
                            self.row_idx, self.shape[0])

    def matmat(self, B: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        """SpMM: sparse × dense (AᵀB with transpose=True)."""
        col = self._col_of_nnz()
        if transpose:
            return _segment_sum(
                self.values[:, None] * B.index_select(0, self.row_idx), col,
                self.shape[1])
        return _segment_sum(self.values[:, None] * B.index_select(0, col),
                            self.row_idx, self.shape[0])

    def to_dense(self) -> torch.Tensor:
        out = self.values.new_zeros(self.shape)
        return out.index_put_((self.row_idx.long(), self._col_of_nnz().long()),
                              self.values, accumulate=True)
