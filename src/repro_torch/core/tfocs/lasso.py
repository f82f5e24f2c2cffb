"""solveLASSO (paper §3.2.2):  ½‖Ax − b‖² + λ‖x‖₁.

Counterpart of src/repro/core/tfocs/lasso.py.  The three composite parts,
as the paper lists them: the linear component LinopMatrix (the matrix's
products), the smooth component SmoothQuad and the nonsmooth component
ProxL1 (soft threshold).  The default options are acc_rb, so on a
RowMatrix the solve runs `_tfocs_fused_accel`: one fused_grad pass an
attempt.
"""
from __future__ import annotations

import torch

from repro_torch.core.distmat import types as T
from .linop import LinopMatrix
from .prox import ProxL1
from .smooth import SmoothQuad
from .solver import TfocsOptions, tfocs


def solve_lasso(A, b, lam: float, *, x0: torch.Tensor | None = None,
                opts: TfocsOptions | None = None):
    """Solve the lasso on A (a RowMatrix, SparseRowMatrix or local matrix)
    on A's device; returns (x, info)."""
    linop = LinopMatrix(A)
    dev = T.resolve_device(linop.device)
    smooth = SmoothQuad(b=linop.pad_data(T.as_float_tensor(b, dev)),
                        weights=linop.row_weights())
    x0 = torch.zeros(linop.in_shape, dtype=torch.float32, device=dev) \
        if x0 is None else T.as_float_tensor(x0, dev)
    opts = opts or TfocsOptions(max_iters=500, backtracking=True,
                                restart=True)
    return tfocs(smooth, linop, ProxL1(lam), x0, opts)
