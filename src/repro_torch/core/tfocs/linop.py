"""Linear operators for composite objectives (paper §3.2.2 `LinopMatrix`).

Counterpart of src/repro/core/tfocs/linop.py.  `apply` maps the solver's
variable into data space, `adjoint` maps back, `fused_grad` does a
row-separable smooth's value, gradient and image in one pass over A, and
`fused_grad_multi` does the same for a group of k right-hand sides in one
pass.  `LinopAdjoint` swaps another operator's apply and adjoint (the
smoothed-LP dual).

The reference's solver math "sees global arrays".  In the port an
operator over a row-sharded matrix hands each rank its shard of the data
space: `apply` returns the shard's rows of Ax, `pad_data` cuts a global
data-space vector to the shard, and `data_sum` all_reduces a partial sum
over data space (a smooth's value, a data-space dot) across the row
group, so the engines' scalars have the same bits on every rank.  The
variable x and `adjoint`'s output stay whole on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.core.distmat import types as T
from repro_torch.core.distmat.rowmatrix import RowMatrix
from repro_torch.core.distmat.sparserow import SparseRowMatrix
from repro_torch.kernels import ops as _ops

_DIST = (RowMatrix, SparseRowMatrix)


@dataclass(frozen=True)
class LinopMatrix:
    """y = A x for a RowMatrix, a SparseRowMatrix or a plain local
    matrix."""
    A: RowMatrix | SparseRowMatrix | torch.Tensor

    @property
    def in_shape(self) -> tuple[int, ...]:
        return (self.A.shape[1],)

    @property
    def out_shape(self) -> tuple[int, ...]:
        # Padded global row count, as the reference's; each rank's
        # data-space vectors hold out_shape[0] // row_shards() of it
        # (pad_data).
        if isinstance(self.A, _DIST):
            return (self.A.m_pad,)
        return (self.A.shape[0],)

    @property
    def device(self) -> torch.device:
        return self.A.device

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.A, _DIST):
            return self.A.matvec(x)
        return self.A @ x

    def adjoint(self, y: torch.Tensor) -> torch.Tensor:
        if isinstance(self.A, _DIST):
            return self.A.rmatvec(y)
        return self.A.T @ y

    def fused_grad(self, x: torch.Tensor, sep, residual=None):
        """(f(Ax), Aᵀ∇f(Ax), Ax) in one streaming pass over A for a
        row-separable smooth; `sep` is its RowSeparable form.  `residual`
        (a distributed operand's init_psum_residual) sends the gradient
        over the compressed int8 wire and returns (f, g, z,
        new_residual)."""
        if isinstance(self.A, _DIST):
            if residual is not None:
                return self.A.fused_grad(x, sep, residual=residual)
            return self.A.fused_grad(x, sep)
        kind, t, w, prm = T.row_separable_inputs(
            sep, self.out_shape[0], self.row_weights)
        return _ops.fused_grad(self.A, x, t, w, loss=kind, param=prm)

    def fused_grad_multi(self, x: torch.Tensor, seps):
        """(f (k,), g (k × n), z (k × m)) for a group of k right-hand sides
        in one streaming pass over A; `x` is (k × n), `seps` a sequence of
        k RowSeparable smooths sharing one loss kind/param, or one smooth
        with stacked targets."""
        if isinstance(self.A, _DIST):
            return self.A.fused_grad_multi(x, seps)
        kind, t, w, prm = T.row_separable_batch_inputs(
            seps, self.out_shape[0], self.row_weights)
        return _ops.fused_grad_multi(self.A, torch.atleast_2d(x), t, w,
                                     loss=kind, param=prm)

    def astype_store(self, dtype) -> "LinopMatrix":
        """Recast the operand's storage (the solver's bf16 precision lands
        here); compute still upcasts what it reads and sums in f32.  The
        recast is a second copy of A beside the caller's (A in bf16 is half
        its f32 size: 4.3 GB beside 8.6 GB at 2^21 x 1024); the caller's
        matrix is never freed or changed."""
        if isinstance(self.A, _DIST):
            return LinopMatrix(self.A.astype_store(dtype))
        return LinopMatrix(self.A.to(dtype))

    def operand_dtype(self) -> torch.dtype:
        """dtype of the matrix operand as stored."""
        if isinstance(self.A, RowMatrix):
            return self.A.rows.dtype
        if isinstance(self.A, SparseRowMatrix):
            return self.A.data.dtype
        return self.A.dtype

    def init_psum_residual(self):
        """Zeroed error-feedback residual of the compressed gradient
        all_reduce; None for a local operand (no wire to compress)."""
        if isinstance(self.A, _DIST):
            return self.A.init_psum_residual()
        return None

    def row_shards(self) -> int:
        """Row shards the operand is split into (the fused-vs-unfused
        roofline is priced per shard)."""
        return self.A.nshards if isinstance(self.A, _DIST) else 1

    def axis_sizes(self) -> tuple[int, ...]:
        """The row axes' sizes the planner prices collectives over; ()
        on one shard."""
        if not isinstance(self.A, _DIST) or self.A.nshards == 1:
            return ()
        from repro_torch.launch import mesh as _mesh
        return _mesh.axis_sizes(self.A.mesh, self.A.row_axes)

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the row shards of a partial data-space sum (the
        identity on one shard)."""
        if isinstance(self.A, _DIST):
            return compat.psum(t, self.A.mesh, self.A.row_axes)
        return t

    def pad_data(self, b: torch.Tensor) -> torch.Tensor:
        """A data-space vector on this rank: padded to the padded row
        count, or, on a row-sharded operand, cut to this shard's rows."""
        if isinstance(self.A, _DIST):
            return self.A._local_data(b)
        m = self.out_shape[0]
        return F.pad(b, (0, m - b.shape[0])) if b.shape[0] < m else b

    def row_weights(self) -> torch.Tensor:
        """{0,1} mask of (this shard's) true rows: weights that keep
        padding rows out of the smooth."""
        if isinstance(self.A, _DIST):
            return self.A._row_mask()
        return torch.ones(self.out_shape, dtype=torch.float32,
                          device=self.device)


@dataclass(frozen=True)
class LinopIdentity:
    n: int
    device: str | torch.device = "cuda"

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n,)

    def apply(self, x):
        return x

    def adjoint(self, y):
        return y

    def pad_data(self, b):
        return b

    def row_weights(self):
        return torch.ones((self.n,), dtype=torch.float32,
                          device=T.resolve_device(self.device))


@dataclass
class CountingLinop:
    """Wraps an operator and counts its A-passes (apply / adjoint /
    fused_grad / fused_grad_multi, each one streaming pass over A, whatever
    the group width).

    The reference counts at trace time, so its counts are the structural
    per-iteration ones.  The port runs eagerly, so these count every call
    at run time: the total equals the solver's info["a_passes"]."""
    base: object
    counts: dict = field(default_factory=lambda: {
        "apply": 0, "adjoint": 0, "fused_grad": 0, "fused_grad_multi": 0})

    @property
    def in_shape(self):
        return self.base.in_shape

    @property
    def out_shape(self):
        return self.base.out_shape

    @property
    def device(self):
        return self.base.device

    def total(self) -> int:
        return sum(self.counts.values())

    def apply(self, x):
        self.counts["apply"] += 1
        return self.base.apply(x)

    def adjoint(self, y):
        self.counts["adjoint"] += 1
        return self.base.adjoint(y)

    def fused_grad(self, x, sep, residual=None):
        self.counts["fused_grad"] += 1
        if residual is not None:
            return self.base.fused_grad(x, sep, residual=residual)
        return self.base.fused_grad(x, sep)

    def fused_grad_multi(self, x, seps):
        self.counts["fused_grad_multi"] += 1
        return self.base.fused_grad_multi(x, seps)

    @property
    def A(self):
        """The wrapped operator's matrix (the planner reads its layout)."""
        return getattr(self.base, "A", None)

    def astype_store(self, dtype) -> "CountingLinop":
        """The wrapped operator recast, counting into the same counts."""
        return CountingLinop(self.base.astype_store(dtype), self.counts)

    def operand_dtype(self):
        return self.base.operand_dtype()

    def init_psum_residual(self):
        return self.base.init_psum_residual()

    def row_shards(self) -> int:
        return self.base.row_shards()

    def axis_sizes(self) -> tuple[int, ...]:
        return self.base.axis_sizes()

    def data_sum(self, t):
        return self.base.data_sum(t)

    def pad_data(self, b):
        return self.base.pad_data(b)

    def row_weights(self):
        return self.base.row_weights()


@dataclass(frozen=True)
class LinopAdjoint:
    """The formal adjoint of another operator (the SCD dual solver's, whose
    variable lives in the base operator's data space)."""
    base: object

    @property
    def in_shape(self):
        return self.base.out_shape

    @property
    def out_shape(self):
        return self.base.in_shape

    @property
    def device(self):
        return self.base.device

    def apply(self, x):
        return self.base.adjoint(x)

    def adjoint(self, y):
        return self.base.apply(y)

    def pad_data(self, b):
        return b

    def row_weights(self):
        return torch.ones(self.out_shape, dtype=torch.float32,
                          device=T.resolve_device(self.device))
