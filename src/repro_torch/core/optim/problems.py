"""The four Figure-1 benchmark problems (paper §3.3):

  linear      — scaled-up TFOCS `test_LASSO.m` data: 10000 × 1024, 512 of the
                features truly correlated; unregularized least squares.
  linear_l1   — same data, + λ‖x‖₁.
  logistic    — 10000 × 250; each feature = class-mean gaussian + noise
                gaussian; unregularized logistic regression.
  logistic_l2 — same, + (λ/2)‖x‖₂².

Counterpart of src/repro/core/optim/problems.py.  The data are the
reference's numpy draws, call for call, so A, b and y are bit for bit the
reference's; the composite lives on a RowMatrix on `device` (the card
unless the caller asks for the CPU).

`mesh=` shards A's rows over a mesh (core/distmat/types); every rank
draws the same numpy data and keeps its strip, and b and y are cut to the
strip by the operator's `pad_data`.  Differences from the reference:
`device=` places a one-device problem, and L's power iteration runs on
A's device (the same numpy start vector and 50 iterations of Aᵀ(A v) in
float64, A read a float32 chunk of rows at a time, each step's Aᵀ(A v)
all_reduced over the row shards), where the reference runs it in numpy
on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.distmat import types as T
from repro_torch.core.distmat.rowmatrix import RowMatrix
from repro_torch.core.tfocs import (LinopMatrix, ProxL1, ProxL2Sq, ProxZero,
                                    SmoothHuberL1, SmoothLogLoss, SmoothQuad)
from repro_torch.core.tfocs.smooth import row_separable
from repro_torch.core.tfocs.solver import fused_gradient_enabled

# Elements of A (as float64) the power iteration holds at a time: 256 MiB.
_CHUNK_ELEMS = 1 << 25


@dataclass(frozen=True)
class Problem:
    name: str
    linop: LinopMatrix
    smooth: object
    prox: object
    smooth_for_lbfgs: object     # L1 folded in smoothly where needed
    L: float                     # Lipschitz bound (‖A‖² · curvature)


def _lipschitz_sq_norm(A) -> float:
    """‖A‖₂² by 50 power iterations in float64 on A's device, from the
    reference's numpy start vector; each iteration reads A (a tensor or a
    RowMatrix) once, a chunk of rows at a time (a RowMatrix's shard, the
    sums all_reduced over its row group)."""
    if isinstance(A, RowMatrix):
        rows, mesh, axes = A.rows, A.mesh, A.row_axes
    else:
        rows, mesh, axes = A, None, ()
    n = rows.shape[1]

    def psum(t):
        return compat.psum(t, mesh, axes)
    step = max(1, _CHUNK_ELEMS // max(n, 1))
    v = torch.from_numpy(np.random.default_rng(0).normal(size=n)).to(
        rows.device)

    def chunks():
        for i in range(0, rows.shape[0], step):
            yield rows[i:i + step].double()

    for _ in range(50):
        w = torch.zeros_like(v)
        for c in chunks():
            w += c.T @ (c @ v)
        w = psum(w)
        v = w / torch.linalg.vector_norm(w)
    return float(psum(sum(torch.sum((c @ v) ** 2) for c in chunks())))


def make_problem(name: str, *, m: int = 10000, n: int = 1024,
                 device="cuda", mesh=None, seed: int = 0,
                 lam: float | None = None, dtype=np.float32) -> Problem:
    dev = mesh.device if mesh is not None else T.resolve_device(device)
    rng = np.random.default_rng(seed)
    if name.startswith("linear"):
        n_eff = n
        k_true = n_eff // 2                    # 512 of 1024 truly correlated
        A = rng.normal(size=(m, n_eff)).astype(dtype)
        xtrue = np.zeros(n_eff, dtype)
        xtrue[:k_true] = rng.normal(size=k_true).astype(dtype)
        b = (A @ xtrue + 0.1 * rng.normal(size=m)).astype(dtype)
        lam = 1.0 if lam is None else lam
        linop = LinopMatrix(RowMatrix.create(A, device=dev, mesh=mesh))
        del A
        quad = SmoothQuad(b=linop.pad_data(torch.from_numpy(b).to(dev)),
                          weights=linop.row_weights())
        L = _lipschitz_sq_norm(linop.A)
        if name == "linear":
            return Problem(name, linop, quad, ProxZero(), quad, L)
        if name == "linear_l1":
            return Problem(name, linop, quad, ProxL1(lam),
                           _WithSmoothReg(quad, SmoothHuberL1(lam)), L)
    if name.startswith("logistic"):
        n_eff = 250 if n == 1024 else n
        y = (rng.random(m) < 0.5).astype(dtype) * 2 - 1
        mu = rng.normal(size=n_eff).astype(dtype)
        A = (y[:, None] * mu[None, :]
             + rng.normal(size=(m, n_eff))).astype(dtype)
        lam = 1e-2 if lam is None else lam
        linop = LinopMatrix(RowMatrix.create(A, device=dev, mesh=mesh))
        del A
        ll = SmoothLogLoss(y=linop.pad_data(torch.from_numpy(y).to(dev)),
                           weights=linop.row_weights())
        L = 0.25 * _lipschitz_sq_norm(linop.A)    # σ'' ≤ 1/4
        if name == "logistic":
            return Problem(name, linop, ll, ProxZero(), ll, L)
        if name == "logistic_l2":
            return Problem(name, linop, ll, ProxL2Sq(lam),
                           _WithL2(ll, lam), L + lam)
    raise ValueError(f"unknown problem {name!r}")


@dataclass(frozen=True)
class _WithSmoothReg:
    """smooth(Ax) + reg(x) presented as an x-space objective for L-BFGS."""
    inner: object
    reg: object

    def data_value(self, z):
        return self.inner.value(z)


@dataclass(frozen=True)
class _WithL2:
    inner: object
    lam: float

    def data_value(self, z):
        return self.inner.value(z)


def composite_value(problem: Problem, x: torch.Tensor) -> torch.Tensor:
    z = problem.linop.apply(x)
    return (problem.linop.data_sum(problem.smooth.value(z))
            + problem.prox.value(x))


def lbfgs_value_and_grad(problem: Problem, fused: bool | str = "auto"):
    """x-space (value, grad) for L-BFGS, with regularizers smoothed.  The
    data-fit term takes the single-pass fused gradient (the fused_grad
    kernel) when the smooth is row-separable, as every Figure-1 smooth is;
    fused=False opts out to apply + adjoint."""
    linop, prox = problem.linop, problem.prox
    use_fused = fused_gradient_enabled(problem.smooth, linop, fused)
    sep = row_separable(problem.smooth) if use_fused else None

    def vg(x):
        if use_fused:
            f, g, _ = linop.fused_grad(x, sep)       # ← ONE A-pass
        else:
            z = linop.apply(x)
            f = linop.data_sum(problem.smooth.value(z))
            g = linop.adjoint(problem.smooth.grad(z))
        if isinstance(prox, ProxL1):
            reg = SmoothHuberL1(prox.lam)
            f = f + reg.value(x)
            g = g + reg.grad(x)
        elif isinstance(prox, ProxL2Sq):
            f = f + 0.5 * prox.lam * torch.dot(x, x)
            g = g + prox.lam * x
        return f, g

    return vg
