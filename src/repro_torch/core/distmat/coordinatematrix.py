"""CoordinateMatrix: a COO matrix sharded by entry over a mesh (paper §2.2).

Counterpart of src/repro/core/distmat/coordinatematrix.py.  "Should be used
only when both dimensions of the matrix are huge and the matrix is very
sparse."  The RDD[MatrixEntry] is three 1-D tensors (row, col, value),
sharded by position as the reference shards them: the entries padded to a
multiple of the shard count (the ranks along the row axes) with zero
entries at (0, 0), each rank keeping its contiguous part.  Vectors (length
m or n) are replicated, the paper's operating assumption for this type.
matvec and rmatvec, what Lanczos needs, are each rank's gather and segment
sum over its entries (the reference's `segment_sum`), then one all_reduce
of the m- or n-vector over the row axes, as the reference's psum; no
kernel runs here, as none runs in the reference's jnp body.  `create`
sorts each rank's entries by row once and keeps a second copy of them
sorted by column, so each product sums every output's entries with
`torch.segment_reduce` over contiguous runs, in the same order every call.
(A scatter with `index_add_` sums with atomics on the card: its bits vary
between calls and a hot column's long chain of f32 adds loses digits,
enough that Lanczos stopped short of its tolerance; see
tools/diagnose_coo.py.)  The transpose swaps the index tensors and the two
sorted copies.  The conversions gather the entries (the padding dropped)
on every rank: `to_sparse_row_matrix` bins them into the block-sparse type
(SparseRowMatrix.from_entries) on the same mesh or device, whose products
run the bsr_* kernels.

Difference from the reference: each rank stores its entries sorted by
row.  Made without a mesh (or on a one-rank mesh) the matrix lives on one
device, the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch

from repro_torch import compat
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
    row_idx: torch.Tensor           # (nnz_local,) int32, sorted
    col_idx: torch.Tensor           # (nnz_local,) int32
    values: torch.Tensor            # (nnz_local,) float32 or bfloat16
    dims: tuple[int, int]
    nnz: int                        # true global entry count
    by_row: _Segments = field(repr=False)   # shares col_idx and values
    by_col: _Segments = field(repr=False)
    mesh: T.Mesh | None = field(default=None, repr=False, compare=False)
    row_axes: tuple[str, ...] = T.ROW_AXES
    # Where this rank's padding entries sit in its stored (row-sorted)
    # order: [pad_at, pad_at + pad); a transpose keeps the storage.
    pad_at: int = 0
    pad: int = 0

    @staticmethod
    def create(row_idx, col_idx, values, shape: tuple[int, int], *,
               device="cuda", mesh=None,
               row_axes: Sequence[str] | None = None) -> "CoordinateMatrix":
        """The entries on `device`, or with `mesh` each rank's contiguous
        part of them (padded, as the reference pads, with zero entries at
        (0, 0)) on the mesh's device; only the part moves.  The mesh may be
        a survivor mesh (``train/elastic.survivor_mesh``); a rank outside
        it keeps every entry on its device."""
        row_axes = tuple(row_axes) if row_axes else T.row_axes_for(mesh)
        if T.single_rank(mesh):
            device, mesh = mesh.device, None
        ri, ci = torch.as_tensor(row_idx), torch.as_tensor(col_idx)
        va = T.tensor_from_array(values)
        nnz = int(va.shape[0])
        pad = 0
        if mesh is None:
            dev = T.resolve_device(device)
        else:
            dev = mesh.device
            r0, per = T.shard_range(nnz, mesh.axes_size(row_axes),
                                    mesh.index(row_axes))
            ri, ci, va = ri[r0:r0 + per], ci[r0:r0 + per], va[r0:r0 + per]
            pad = per - int(va.shape[0])
        va = T.as_float_tensor(va, dev)
        ri = ri.to(device=dev, dtype=torch.int32)
        ci = ci.to(device=dev, dtype=torch.int32)
        if pad:
            ri = torch.cat([ri, ri.new_zeros(pad)])
            ci = torch.cat([ci, ci.new_zeros(pad)])
            va = torch.cat([va, va.new_zeros(pad)])
        m, n = int(shape[0]), int(shape[1])
        order = torch.sort(ri, stable=True).indices
        ri, ci, va = ri[order], ci[order], va[order]
        by_row = _Segments(_offsets(ri, m), ci, va)
        # The stable sort leaves the padding (row 0, appended last) at the
        # end of row 0's run.
        pad_at = int(by_row.offsets[1]) - pad if pad else 0
        return CoordinateMatrix(ri, ci, va, dims=(m, n), nnz=nnz,
                                by_row=by_row,
                                by_col=_Segments.build(ci, ri, va, n),
                                mesh=mesh, row_axes=row_axes, pad_at=pad_at,
                                pad=pad)

    @property
    def shape(self) -> tuple[int, int]:
        return self.dims

    @property
    def device(self) -> torch.device:
        return self.values.device

    def _psum(self, t: torch.Tensor) -> torch.Tensor:
        return compat.psum(t, self.mesh, self.row_axes)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """A v for a replicated (n,) v → the replicated (m,) vector: gather
        v at the column indices, sum each row's run, all_reduce."""
        return self._psum(self.by_row.product(v))

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        """Aᵀ u for a replicated (m,) u → the replicated (n,) vector: the
        same over the entries sorted by column."""
        return self._psum(self.by_col.product(u))

    def frobenius_norm(self) -> torch.Tensor:
        va = self.values.float()
        return torch.sqrt(self._psum((va * va).sum()))

    def transpose(self) -> "CoordinateMatrix":
        """Aᵀ by swapping the index tensors and the two sorted copies: no
        copy and no collective.  The SVD's route for wide inputs rides on
        this."""
        return CoordinateMatrix(self.col_idx, self.row_idx, self.values,
                                dims=(self.dims[1], self.dims[0]),
                                nnz=self.nnz, by_row=self.by_col,
                                by_col=self.by_row, mesh=self.mesh,
                                row_axes=self.row_axes, pad_at=self.pad_at,
                                pad=self.pad)

    def _entries(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Every true entry (rows, cols, values) on every rank: each rank's
        part gathered over the row axes, the padding dropped (small
        scale, as the reference's conversions are)."""
        ri, ci, va = self.row_idx, self.col_idx, self.values
        if self.mesh is None:
            return ri, ci, va
        keep = torch.ones_like(ri)
        keep[self.pad_at:self.pad_at + self.pad] = 0
        mesh, axes = self.mesh, self.row_axes
        idx = compat.all_gather(torch.stack([ri, ci, keep]), mesh, axes)
        idx = idx.permute(1, 0, 2).reshape(3, -1)
        keep = idx[2] > 0
        va = compat.all_gather(va, mesh, axes).reshape(-1)[keep]
        return idx[0, keep], idx[1, keep], va

    # -- conversions (paper: toIndexedRowMatrix) ----------------------------
    def to_indexed_row_matrix(self):
        """The rows that hold an entry, densified (a small-scale conversion,
        as in the reference), on this matrix's mesh or device."""
        from .rowmatrix import IndexedRowMatrix
        ri, ci, va = self._entries()
        uniq, inv = torch.unique(ri.long(), return_inverse=True)
        dense = va.new_zeros((uniq.shape[0], self.dims[1]))
        dense.index_put_((inv, ci.long()), va, accumulate=True)
        return IndexedRowMatrix.create(uniq, dense, device=self.device,
                                       mesh=self.mesh,
                                       row_axes=self.row_axes)

    def to_sparse_row_matrix(self, bs: int | str = "auto"):
        """Block-compress into the block-sparse row type: the entries are
        binned into (block-row, block-column) blocks on this device, and on
        a mesh each rank keeps its strip of block-rows."""
        from .sparserow import SparseRowMatrix
        ri, ci, va = self._entries()
        return SparseRowMatrix.from_entries(ri, ci, va, self.dims, bs=bs,
                                            device=self.device,
                                            mesh=self.mesh,
                                            row_axes=self.row_axes)

    def to_block_matrix(self, block_rows: int, block_cols: int):
        from .blockmatrix import BlockMatrix
        return BlockMatrix.create(self.to_local(), device=self.device,
                                  block_rows=block_rows,
                                  block_cols=block_cols, mesh=self.mesh)

    def to_local(self) -> torch.Tensor:
        """The dense (m, n) matrix on every rank."""
        ri, ci, va = self._entries()
        out = va.new_zeros(self.dims)
        return out.index_put_((ri.long(), ci.long()), va, accumulate=True)
