"""Linear operators for composite objectives (paper §3.2.2 `LinopMatrix`).

Counterpart of src/repro/core/tfocs/linop.py.  `apply` maps the solver's
variable into data space, `adjoint` maps back, `fused_grad` does a
row-separable smooth's value, gradient and image in one pass over A, and
`fused_grad_multi` does the same for a group of k right-hand sides in one
pass.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

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
        # Padded row count: data-space vectors are padded to it (pad_data).
        if isinstance(self.A, RowMatrix):
            return (self.A.rows.shape[0],)
        if isinstance(self.A, SparseRowMatrix):
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

    def fused_grad(self, x: torch.Tensor, sep):
        """(f(Ax), Aᵀ∇f(Ax), Ax) in one streaming pass over A for a
        row-separable smooth; `sep` is its RowSeparable form."""
        if isinstance(self.A, _DIST):
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

    def operand_dtype(self) -> torch.dtype:
        """dtype of the matrix operand as stored."""
        if isinstance(self.A, RowMatrix):
            return self.A.rows.dtype
        if isinstance(self.A, SparseRowMatrix):
            return self.A.data.dtype
        return self.A.dtype

    def pad_data(self, b: torch.Tensor) -> torch.Tensor:
        """Pad a data-space vector to the padded row count."""
        m = self.out_shape[0]
        return F.pad(b, (0, m - b.shape[0])) if b.shape[0] < m else b

    def row_weights(self) -> torch.Tensor:
        """{0,1} mask of true rows: weights that keep padding rows out of
        the smooth."""
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

    def fused_grad(self, x, sep):
        self.counts["fused_grad"] += 1
        return self.base.fused_grad(x, sep)

    def fused_grad_multi(self, x, seps):
        self.counts["fused_grad_multi"] += 1
        return self.base.fused_grad_multi(x, seps)

    def pad_data(self, b):
        return self.base.pad_data(b)

    def row_weights(self):
        return self.base.row_weights()
