"""BlockMatrix: a 2-D block matrix over a mesh (paper §2.3).

Counterpart of src/repro/core/distmat/blockmatrix.py.  The reference lays
the RDD of ((bi, bj), Matrix) tiles out as one array sharded over both mesh
axes and multiplies by SUMMA: all-gather the row and column panels, one
local GEMM.  Here each rank of a `Mesh` holds its tile as a plain local
tensor: the grid is R × C, R the ranks along the row axes (every axis but
"model") and C along "model", the matrix zero-padded to a multiple of R
rows and C columns, and the rank at (`mesh.index(row_axes)`,
`mesh.index("model")`) keeps that (m_pad/R × n_pad/C) tile.  `multiply` is
SUMMA: A's tile all-gathered along "model" into its (m/R × k) row panel,
B's along the row axes into its (k × n/C) column panel, then one gemm
launch (f32 accumulation, cast back to A's type), whose result is already
this rank's tile of the product.

Vectors follow RowMatrix's convention: a data-space vector (length m) is
the rank's row strip (m_pad/R,), the same on the ranks of one row panel;
an x-space vector (length n) is replicated; a model-sharded vector (the
paper's "vector as RDD", §1.2) is the rank's "model" strip (n_pad/C,).
Each product all_reduces as the reference's shard bodies psum: over
"model" for A v, over the row axes for Aᵀ u, over both for the norm.

Made without a mesh (or on a one-rank mesh) the matrix is one tile on one
device, the card unless the caller asks for the CPU, and every collective
is the identity.  `block_rows` and `block_cols` stay advisory, as they are
in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.kernels import ops as _ops
from . import types as T


def _panel(tile: torch.Tensor, mesh, col_axis: str) -> torch.Tensor:
    """The row panel of `tile`: the tiles along `col_axis` side by side
    (the tile itself where that axis has one rank)."""
    parts = compat.all_gather(tile, mesh, col_axis)
    return tile if parts.shape[0] == 1 else torch.cat(list(parts), dim=1)


@dataclass(frozen=True)
class BlockMatrix(T.DistMatrix):
    data: torch.Tensor              # this rank's (m_pad/R, n_pad/C) tile
    dims: tuple[int, int]           # true (m, n)
    mesh: T.Mesh | None = field(default=None, repr=False, compare=False)
    row_axes: tuple[str, ...] = T.ROW_AXES
    col_axis: str = T.COL_AXIS

    @staticmethod
    def create(x, *, device="cuda", block_rows: int | None = None,
               block_cols: int | None = None, mesh=None,
               row_axes: Sequence[str] | None = None,
               col_axis: str = T.COL_AXIS) -> "BlockMatrix":
        """`x` (global: numpy or a tensor) on `device`, or with `mesh` each
        rank's tile of it on the mesh's device (only the tile moves).
        `block_rows`/`block_cols` are advisory (Spark's rowsPerBlock): the
        tile is the shard, as in the reference.  The mesh may be a
        survivor mesh (``train/elastic.survivor_mesh``); a rank outside it
        keeps the whole matrix on its device, as ``RowMatrix.remesh``
        leaves a dropped rank."""
        row_axes = tuple(row_axes) if row_axes else T.row_axes_for(mesh)
        if T.single_rank(mesh):
            device, mesh = mesh.device, None
        x = T.tensor_from_array(x)
        if x.dim() != 2:
            raise ValueError(f"BlockMatrix needs a 2-D matrix, got shape "
                             f"{tuple(x.shape)}")
        m, n = int(x.shape[0]), int(x.shape[1])
        if mesh is None:
            tile = T.as_float_tensor(x, T.resolve_device(device))
            return BlockMatrix(tile.contiguous(), (m, n), row_axes=row_axes,
                               col_axis=col_axis)
        r0, mr = T.shard_range(m, mesh.axes_size(row_axes),
                               mesh.index(row_axes))
        c0, nc = T.shard_range(n, mesh.shape[col_axis], mesh.index(col_axis))
        tile = T.as_float_tensor(x[r0:r0 + mr, c0:c0 + nc], mesh.device)
        tile = F.pad(tile, (0, nc - tile.shape[1], 0, mr - tile.shape[0]))
        return BlockMatrix(tile.contiguous(), (m, n), mesh, row_axes,
                           col_axis)

    # -- bookkeeping ---------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return self.dims

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def grid(self) -> tuple[int, int]:
        """(R, C): ranks along the row axes and along the column axis."""
        return (T.axes_size(self.mesh, self.row_axes),
                T.axes_size(self.mesh, (self.col_axis,)))

    @property
    def block_shape(self) -> tuple[int, int]:
        return tuple(self.data.shape)

    def validate(self) -> None:
        """The paper's `validate`: the stored tile is 2-D and contiguous,
        and on a mesh it is the (⌈m/R⌉ × ⌈n/C⌉) tile of the R × C grid;
        the padded storage holds the logical dims."""
        if self.data.dim() != 2 or not self.data.is_contiguous():
            raise ValueError("the tile must be a contiguous 2-D tensor")
        R, C = self.grid
        mr, nc = self.data.shape
        if self.mesh is not None and (mr, nc) != (
                T.shard_range(self.dims[0], R, 0)[1],
                T.shard_range(self.dims[1], C, 0)[1]):
            raise ValueError(f"tile {tuple(self.data.shape)} is not the "
                             f"{self.dims} matrix's on the grid ({R}, {C})")
        if mr * R < self.dims[0] or nc * C < self.dims[1]:
            raise ValueError("padded storage smaller than the logical dims")

    def _like(self, data: torch.Tensor, dims) -> "BlockMatrix":
        return BlockMatrix(data, tuple(dims), self.mesh, self.row_axes,
                           self.col_axis)

    def _index(self, axes) -> int:
        return compat.axis_index(self.mesh, axes)

    # -- paper API: add / multiply -------------------------------------------
    def add(self, other: "BlockMatrix") -> "BlockMatrix":
        if self.dims != other.dims:
            raise ValueError(f"dim mismatch {self.dims} vs {other.dims}")
        return self._like(self.data + other.data, self.dims)

    def multiply(self, other: "BlockMatrix") -> "BlockMatrix":
        """A @ B by SUMMA: A's row panel (all_gather along "model") times
        B's column panel (all_gather along the row axes) in one gemm
        launch, f32 accumulation, A's type out; the result is this rank's
        tile of the product, no reduction.  B on another mesh (or on one
        device) is first laid out on A's grid.  The two panels' k padding
        (to C columns and to R rows) may differ: past k both hold zeros,
        so the shorter one bounds the product."""
        if self.dims[1] != other.dims[0]:
            raise ValueError(f"inner dim mismatch {self.dims} @ {other.dims}")
        dims = (self.dims[0], other.dims[1])
        if other.mesh is not self.mesh:
            other = BlockMatrix.create(other.to_local(), device=self.device,
                                       mesh=self.mesh,
                                       row_axes=self.row_axes,
                                       col_axis=self.col_axis)
        if self.mesh is None:
            out = _ops.gemm(self.data, other.data, out_dtype=torch.float32)
            return self._like(out.to(self.data.dtype), dims)
        mesh = self.mesh
        a_row = _panel(self.data, mesh, self.col_axis)
        b_col = compat.all_gather(other.data, mesh, self.row_axes)
        b_col = b_col.reshape(-1, b_col.shape[-1])
        k = min(a_row.shape[1], b_col.shape[0])
        if a_row.shape[1] > k:
            a_row = a_row[:, :k].contiguous()
        out = _ops.gemm(a_row, b_col[:k], out_dtype=torch.float32)
        return self._like(out.to(self.data.dtype), dims)

    def transpose(self) -> "BlockMatrix":
        """Aᵀ on the same grid: the tiles gathered, the whole transposed
        and re-padded (rows to R, columns to C, as the reference's reshard
        recuts them), each rank keeping its tile.  On a square grid that
        tile is the transpose of the (c, r) rank's."""
        if self.mesh is None:
            return self._like(self.data.T.contiguous(),
                              (self.dims[1], self.dims[0]))
        return BlockMatrix.create(self.to_local().T, mesh=self.mesh,
                                  row_axes=self.row_axes,
                                  col_axis=self.col_axis)

    # -- matvec family ---------------------------------------------------------
    def _promoted(self, v: torch.Tensor) -> torch.Tensor:
        return self.data.to(torch.promote_types(self.data.dtype, v.dtype))

    def _model_strip(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's "model" strip of an x-space vector: a replicated
        (n,) or (n_pad,) vector cut to it, a strip-long one passed."""
        v = torch.as_tensor(v)
        nc = self.data.shape[1]
        return T.local_data(v, nc, self.grid[1], self._index(self.col_axis))

    def _row_strip(self, u: torch.Tensor) -> torch.Tensor:
        """This rank's row strip of a data-space vector: a global (m,) or
        (m_pad,) vector cut to it, a strip-long one passed."""
        u = torch.as_tensor(u)
        return T.local_data(u, self.data.shape[0], self.grid[0],
                            self._index(self.row_axes))

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """A v for a replicated (n,) v → this rank's row strip
        (m_pad/R,) ((m,) on one device): the tile times v's "model"
        strip, all_reduced over "model"."""
        part = self._promoted(v) @ self._model_strip(v)
        return compat.psum(part, self.mesh, self.col_axis)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        """Aᵀ u for a data-space u (the rank's row strip, or a global
        vector cut to it) → the replicated (n,) vector: the "model" strip
        all_reduced over the row axes, then gathered along "model"."""
        strip = self.rmatvec_model_sharded(u)
        if self.grid[1] == 1:
            return strip[: self.dims[1]]
        parts = compat.all_gather(strip, self.mesh, self.col_axis)
        return parts.reshape(-1)[: self.dims[1]]

    # -- "vector as RDD": large linear model parallelism (refs [4, 9]) -------
    def matvec_model_sharded(self, w: torch.Tensor) -> torch.Tensor:
        """A w where w is itself sharded over "model" (the rank's
        (n_pad/C,) strip) → this rank's row strip: `matvec`, which takes
        the strip as it is (and cuts a replicated vector to it)."""
        return self.matvec(w)

    def rmatvec_model_sharded(self, u: torch.Tensor) -> torch.Tensor:
        """Aᵀ u for a data-space u (the rank's row strip, or a global
        vector cut to it) → the gradient kept sharded over "model": this
        rank's (n_pad/C,) strip ((n,) on one device), all_reduced over
        the row axes."""
        u = self._row_strip(u)
        return compat.psum(self._promoted(u).T @ u, self.mesh,
                           self.row_axes)

    def frobenius_norm(self) -> torch.Tensor:
        """‖A‖_F on every rank: the tiles' sums of squares all_reduced
        over both axes."""
        a = self.data.float()
        return torch.sqrt(compat.psum((a * a).sum(), self.mesh,
                                      (*self.row_axes, self.col_axis)))

    def to_local(self) -> torch.Tensor:
        """The whole (m, n) matrix on every rank: the tiles gathered along
        "model" into row panels, the panels along the row axes, the
        padding cut."""
        if self.mesh is None:
            return self.data[: self.dims[0], : self.dims[1]]
        panel = _panel(self.data, self.mesh, self.col_axis)
        whole = compat.all_gather(panel, self.mesh, self.row_axes)
        whole = whole.reshape(-1, whole.shape[-1])
        return whole[: self.dims[0], : self.dims[1]]
