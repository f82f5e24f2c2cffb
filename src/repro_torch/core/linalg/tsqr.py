"""Tall-and-skinny QR (paper §3.4, Benson–Gleich–Demmel indirect TSQR).

Counterpart of src/repro/core/linalg/tsqr.py: the map step is each
shard's local QR keeping R, the reduce step gathers the shards' Rs on
every rank (one all_gather) and re-factors the stack there, the same on
every rank, and Q = A R⁻¹ comes back through the gemm kernel on each
shard, the same "broadcast the small factor" pattern as U recovery in the
SVD.  On one shard the stack is that shard's R.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch import compat
from repro_torch.core.distmat import types as T
from repro_torch.core.distmat.rowmatrix import RowMatrix
from repro_torch.kernels import ops as _ops


def _nonneg_diag(R: torch.Tensor) -> torch.Tensor:
    """Fix the sign convention (R diagonal ≥ 0) for determinism."""
    d = torch.sign(torch.diagonal(R))
    d = torch.where(d == 0, 1.0, d)
    return R * d[:, None]


def tsqr(A: RowMatrix) -> tuple[RowMatrix, torch.Tensor]:
    """Returns (Q as RowMatrix, sharded like A; R (n, n) on every rank)
    with A = Q R.  fp8 storage (float8_e4m3fn, float8_e5m2) raises
    TypeError, as the reference's QR has no fp8 type."""
    T.refuse_fp8(A.rows.dtype, "TSQR")
    a = A.rows
    n = a.shape[1]
    # Map: local QR, keep R (padding rows are zero and change nothing).
    local = _nonneg_diag(torch.linalg.qr(a.float(), mode="r")[1])
    # Reduce: QR of the shards' R factors stacked in shard order.
    stacked = compat.all_gather(local, A.mesh, A.row_axes)
    R = _nonneg_diag(torch.linalg.qr(stacked.reshape(-1, n),
                                     mode="r")[1])
    r_inv = torch.linalg.solve_triangular(
        R, torch.eye(n, dtype=R.dtype, device=R.device), upper=True)
    return replace(A, rows=_ops.gemm(a, r_inv, out_dtype=a.dtype)), R
