"""BlockMatrix: a 2-D block matrix on one device (paper §2.3).

Counterpart of src/repro/core/distmat/blockmatrix.py.  The reference lays
the RDD of ((bi, bj), Matrix) tiles out as one array sharded over both mesh
axes and multiplies by SUMMA: all-gather the row and column panels, one
local GEMM.  On one device there is one tile, so `multiply` is that local
GEMM alone, the gemm kernel (f32 accumulation, cast back to A's type), and
`add`, the products with a vector and the "vector as RDD" products with a
model-sharded vector (paper §1.2) are plain tensor ops, as the reference's
shard bodies are.

Difference from the reference: `create` takes `device=` (the card unless
the caller asks for the CPU) in the place of `mesh=`; `block_rows` and
`block_cols` stay advisory, as they are there.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import ops as _ops
from . import types as T


@dataclass(frozen=True)
class BlockMatrix(T.DistMatrix):
    data: torch.Tensor              # (m, n), one tile
    dims: tuple[int, int]           # true (m, n)

    @staticmethod
    def create(x, *, device="cuda", block_rows: int | None = None,
               block_cols: int | None = None, mesh=None) -> "BlockMatrix":
        """`block_rows`/`block_cols` are advisory (Spark's rowsPerBlock):
        the tile is the whole matrix on one device.  A `mesh` of more
        than one rank raises (ROADMAP queue 1 item 13)."""
        device = T.one_device(mesh, device, "BlockMatrix")
        x = T.as_float_tensor(x, T.resolve_device(device))
        if x.dim() != 2:
            raise ValueError(f"BlockMatrix needs a 2-D matrix, got shape "
                             f"{tuple(x.shape)}")
        return BlockMatrix(data=x.contiguous(),
                           dims=(int(x.shape[0]), int(x.shape[1])))

    # -- bookkeeping ---------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return self.dims

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def block_shape(self) -> tuple[int, int]:
        return tuple(self.data.shape)

    def validate(self) -> None:
        """The paper's `validate`: the stored tile is 2-D, contiguous and
        holds the logical dims."""
        if self.data.dim() != 2 or not self.data.is_contiguous():
            raise ValueError("the tile must be a contiguous 2-D tensor")
        mp, np_ = self.data.shape
        if mp < self.dims[0] or np_ < self.dims[1]:
            raise ValueError("stored tile smaller than the logical dims")

    # -- paper API: add / multiply -------------------------------------------
    def add(self, other: "BlockMatrix") -> "BlockMatrix":
        if self.dims != other.dims:
            raise ValueError(f"dim mismatch {self.dims} vs {other.dims}")
        return BlockMatrix(self.data + other.data, self.dims)

    def multiply(self, other: "BlockMatrix") -> "BlockMatrix":
        """A @ B: one gemm launch, f32 accumulation, A's type out."""
        if self.dims[1] != other.dims[0]:
            raise ValueError(f"inner dim mismatch {self.dims} @ {other.dims}")
        out = _ops.gemm(self.data, other.data, out_dtype=torch.float32)
        return BlockMatrix(out.to(self.data.dtype),
                           (self.dims[0], other.dims[1]))

    def transpose(self) -> "BlockMatrix":
        return BlockMatrix(self.data.T.contiguous(),
                           (self.dims[1], self.dims[0]))

    # -- matvec family ---------------------------------------------------------
    def _promoted(self, v: torch.Tensor) -> torch.Tensor:
        return self.data.to(torch.promote_types(self.data.dtype, v.dtype))

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """A v → (m,)."""
        return self._promoted(v) @ v

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        """Aᵀ u → (n,)."""
        return self._promoted(u).T @ u

    # -- "vector as RDD": large linear model parallelism (refs [4, 9]) -------
    def matvec_model_sharded(self, w: torch.Tensor) -> torch.Tensor:
        """A w where the reference shards w over the model axis; one tile
        here."""
        return self.matvec(w)

    def rmatvec_model_sharded(self, u: torch.Tensor) -> torch.Tensor:
        """Aᵀ u, which the reference keeps sharded over the model axis."""
        return self.rmatvec(u)

    def frobenius_norm(self) -> torch.Tensor:
        a = self.data.float()
        return torch.sqrt((a * a).sum())

    def to_local(self) -> torch.Tensor:
        return self.data[: self.dims[0], : self.dims[1]]
