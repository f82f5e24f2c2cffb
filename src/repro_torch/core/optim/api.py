"""minimize(): the one entry point of the paper's optimizer suite.

Counterpart of src/repro/core/optim/api.py.
"""
from __future__ import annotations

import torch

from repro_torch.core.tfocs.solver import TfocsOptions, fused_gradient_enabled
from .first_order import METHODS, minimize_first_order
from .lbfgs import lbfgs
from .problems import Problem, lbfgs_value_and_grad


def minimize(problem: Problem, method: str, *, max_iters: int = 200,
             step_size: float | None = None, tol: float = 1e-10,
             fused: bool | str = "auto"):
    """Run one of the paper's methods on a Figure-1 problem; returns
    (x, info).

    `step_size` mirrors the paper's "all methods were given the same
    initial step size": fixed-step methods use it exactly, backtracking
    ones seed their Lipschitz estimate with it (L0 = 1/step); without it
    L0 is the problem's L.  `fused` gates the single-pass fused gradient
    (gra, lbfgs and the quadratic acc*); False opts out."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}")
    L0 = (1.0 / step_size) if step_size else problem.L
    if method == "lbfgs":
        ppe = 1 if fused_gradient_enabled(problem.smooth, problem.linop,
                                          fused) else 2
        x0 = torch.zeros(problem.linop.in_shape, dtype=torch.float32,
                         device=problem.linop.device)
        return lbfgs(lbfgs_value_and_grad(problem, fused=fused), x0,
                     max_iters=max_iters, tol=tol, passes_per_eval=ppe)
    opts = TfocsOptions(max_iters=max_iters, tol=tol, L0=L0, fused=fused)
    return minimize_first_order(method, problem.smooth, problem.linop,
                                problem.prox, x0=None, opts=opts)
