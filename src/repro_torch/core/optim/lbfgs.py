"""L-BFGS (paper §3.3, ref [13]): the two-loop recursion over a bounded
history on the host side, gradients from passes over A.

Counterpart of src/repro/core/optim/lbfgs.py.  The reference runs the
outer loop and the Armijo line search as `lax.while_loop`s; here they are
Python loops over device tensors, so each line-search test and each stop
test is a host sync.  The history (2·mem n-vectors), the step and the
objective stay float32, as in the reference.

Line search: backtracking Armijo (sufficient decrease) with a curvature
skip-guard on the history update.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.tfocs.prox import ProxZero
from repro_torch.core.tfocs.smooth import row_separable
from repro_torch.core.tfocs.solver import (TfocsOptions,
                                           fused_gradient_enabled,
                                           resolve_precision,
                                           store_precision)


def _two_loop(g: torch.Tensor, S: torch.Tensor, Y: torch.Tensor,
              rho: torch.Tensor, idx: int, filled: int) -> torch.Tensor:
    """H·g via the two-loop recursion over a circular history of `filled`
    valid pairs, the newest at slot idx − 1."""
    mem = S.shape[0]
    q = g
    alphas = torch.zeros(mem, dtype=g.dtype, device=g.device)
    for i in range(filled):
        slot = (idx - 1 - i) % mem
        a = rho[slot] * torch.dot(S[slot], q)
        q = q - a * Y[slot]
        alphas[slot] = a
    if filled > 0:
        newest = (idx - 1) % mem
        sy = torch.dot(S[newest], Y[newest])
        yy = torch.dot(Y[newest], Y[newest])
        gamma = torch.where(yy > 0, sy / torch.clamp(yy, min=1e-30),
                            torch.ones_like(yy))
    else:
        gamma = torch.ones((), dtype=g.dtype, device=g.device)
    r = gamma * q
    for i in range(filled):
        slot = (idx - filled + i) % mem
        beta = rho[slot] * torch.dot(Y[slot], r)
        r = r + (alphas[slot] - beta) * S[slot]
    return r


def lbfgs(value_and_grad: Callable[[torch.Tensor],
                                   tuple[torch.Tensor, torch.Tensor]],
          x0: torch.Tensor, *, mem: int = 10, max_iters: int = 500,
          tol: float = 1e-8, c1: float = 1e-4, max_ls: int = 25,
          init_step: float = 1.0,
          passes_per_eval: int = 2) -> tuple[torch.Tensor, dict]:
    """Minimize a smooth function given its (value, gradient).
    `passes_per_eval` is how many A-passes one `value_and_grad` call costs
    (1 for the fused single-pass gradient, 2 for apply + adjoint); it only
    feeds info["a_passes"], which counts evaluations at run time."""
    n = x0.shape[0]
    dev, dt = x0.device, x0.dtype
    S = torch.zeros((mem, n), dtype=dt, device=dev)
    Y = torch.zeros((mem, n), dtype=dt, device=dev)
    rho = torch.zeros(mem, dtype=dt, device=dev)
    idx = filled = k = 0
    hist = torch.full((max_iters,), torch.nan, dtype=torch.float32,
                      device=dev)
    x = x0
    f, g = value_and_grad(x0)
    n_evals = 1
    done = False
    while not done and k < max_iters:
        d = -_two_loop(g, S, Y, rho, idx, filled)
        gd = torch.dot(g, d)
        if bool(gd >= 0):          # not a descent direction: steepest
            d = -g
            gd = -torch.dot(g, g)
        t = 1.0 if filled > 0 else \
            init_step / max(float(torch.linalg.vector_norm(g)), 1e-12)
        f_new, g_new = value_and_grad(x + t * d)
        tries = 1
        while bool(f_new > f + c1 * t * gd) and tries < max_ls:
            t = 0.5 * t
            f_new, g_new = value_and_grad(x + t * d)
            tries += 1
        x_new = x + t * d
        s = x_new - x
        y = g_new - g
        sy = torch.dot(s, y)
        if bool(sy > 1e-10 * torch.linalg.vector_norm(s)
                * torch.linalg.vector_norm(y)):
            S[idx], Y[idx] = s, y
            rho[idx] = 1.0 / torch.clamp(sy, min=1e-30)
            idx, filled = (idx + 1) % mem, min(filled + 1, mem)
        hist[k] = f_new
        done = bool(torch.linalg.vector_norm(g_new)
                    < tol * torch.clamp(torch.abs(f_new), min=1.0))
        x, f, g = x_new, f_new, g_new
        k += 1
        n_evals += tries
    return x, {"iterations": k, "a_passes": n_evals * passes_per_eval,
               "converged": done,
               "plan": "fused" if passes_per_eval == 1 else "two-pass",
               "history": hist, "n_evals": n_evals, "objective": f}


def lbfgs_composite(smooth, linop, prox=None, x0: torch.Tensor | None = None,
                    opts: TfocsOptions | None = None):
    """Adapter so `minimize_first_order('lbfgs', ...)` takes the same
    composite as the TFOCS-engine methods.  The objective must be smooth:
    only ProxZero is accepted.  A row-separable smooth takes the single-pass
    fused gradient (one read of A per evaluation instead of apply +
    adjoint's two); `opts.fused=False` opts out.  `opts.precision` runs
    the planner's precision sweep as the TFOCS engines do: a "bf16" pick
    works on a bf16 copy of the operand's storage.  The compressed "psum8"
    wire is not taken here (line-search probes are not accepted gradient
    points, which its error feedback assumes), so it reports f32, as in the
    reference."""
    prox = prox or ProxZero()
    if not isinstance(prox, ProxZero):
        raise ValueError("lbfgs needs a smooth objective; fold the "
                         "regularizer into the smooth part (e.g. "
                         "SmoothHuberL1) or use acc_rb.")
    opts = opts or TfocsOptions()
    linop, prec, _ = store_precision(linop, resolve_precision(linop, opts),
                                     wire=False)
    if x0 is None:
        x0 = torch.zeros(linop.in_shape, dtype=torch.float32,
                         device=linop.device)

    if fused_gradient_enabled(smooth, linop, opts.fused):
        sep = row_separable(smooth)

        def value_and_grad(x):
            f, g, _ = linop.fused_grad(x, sep)       # ← ONE A-pass
            return f, g

        passes_per_eval = 1
    else:
        dsum = getattr(linop, "data_sum", None) or (lambda t: t)

        def value_and_grad(x):
            z = linop.apply(x)
            return dsum(smooth.value(z)), linop.adjoint(smooth.grad(z))

        passes_per_eval = 2

    x, info = lbfgs(value_and_grad, x0, max_iters=opts.max_iters,
                    tol=opts.tol, passes_per_eval=passes_per_eval)
    info["precision"] = prec
    return x, info
