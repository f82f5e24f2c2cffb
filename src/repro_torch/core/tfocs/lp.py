"""Smoothed linear programming via the Smoothed Conic Dual (paper §3.2.3).

    minimize   cᵀx + μ/2 ‖x − x₀‖²
    subject to A x = b,  x ≥ 0

Counterpart of src/repro/core/tfocs/lp.py.  The smoothed dual
g(λ) = min_{x≥0} cᵀx + μ/2‖x−x₀‖² + λᵀ(b − Ax) has the minimizer
x*(λ) = max(0, x₀ + (Aᵀλ − c)/μ) and the gradient ∇g(λ) = b − A x*(λ): one
adjoint and one apply an evaluation, so the dual ascent is a TFOCS
composite on λ, which lives in the constraint space.  Continuation
re-centres x₀ ← x*(λ*) and solves again.

On a row-sharded constraint matrix λ lives in the constraint space,
which the reference holds row-sharded.  The port keeps λ whole on every
rank instead: A x is all_gathered from the shards (m floats an apply), Aᵀλ
cuts λ to each shard and all_reduces, and so the dual ascent's scalars,
and its decisions, are the same bits on every rank.

Differences from the reference: λ, x₀ and the vectors built from c and b
live on the operator's device (`linop.device`; an operator without one
is refused), where the reference makes them with `jnp.zeros` on the default
device; info["kkt"] holds Python floats where the reference holds 0-d
arrays.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

import torch.nn.functional as F

from repro_torch import compat
from repro_torch.core.distmat import types as T
from .linop import LinopAdjoint, LinopIdentity
from .prox import ProxZero
from .solver import TfocsOptions, tfocs


@dataclass(frozen=True)
class _DualSmooth:
    """−g(λ) as a smooth function of the operator's output u = Aᵀλ; the
    affine −bᵀλ is added by _AffineWrap."""
    c: torch.Tensor
    x0: torch.Tensor
    mu: float

    def xstar(self, u):
        return torch.clamp(self.x0 + (u - self.c) / self.mu, min=0.0)

    def value(self, u):
        x = self.xstar(u)
        d = x - self.x0
        return -(torch.dot(self.c, x) + 0.5 * self.mu * torch.dot(d, d)
                 - torch.dot(u, x))

    def grad(self, u):
        return self.xstar(u)


@dataclass(frozen=True)
class _AffineWrap:
    """smooth(λ) = inner.value(Aᵀλ) − bᵀλ, its gradient by the chain rule,
    presented to the engine over the identity operator on λ."""
    inner: _DualSmooth
    linop: object        # λ ↦ Aᵀλ
    b: torch.Tensor

    def value(self, lam):
        return self.inner.value(self.linop.apply(lam)) - torch.dot(self.b, lam)

    def grad(self, lam):
        # ∇ = A x*(Aᵀλ) − b
        u = self.linop.apply(lam)
        return self.linop.adjoint(self.inner.grad(u)) - self.b


@dataclass(frozen=True)
class _GatheredRows:
    """A row-sharded operator with its data space made whole on every
    rank: apply all_gathers the shards' rows of A x; adjoint takes a
    whole λ (the operator cuts it to each shard) and all_reduces."""
    base: object

    @property
    def in_shape(self):
        return self.base.in_shape

    @property
    def out_shape(self):
        return self.base.out_shape

    @property
    def device(self):
        return self.base.device

    def apply(self, x):
        A = self.base.A
        return compat.all_gather(self.base.apply(x), A.mesh,
                                 A.row_axes).reshape(-1)

    def adjoint(self, y):
        return self.base.adjoint(y)


def solve_smoothed_lp(c, linop, b, *, mu: float = 1e-2,
                      x0: torch.Tensor | None = None, continuations: int = 3,
                      opts: TfocsOptions | None = None):
    """`linop` maps x-space to the constraint space (apply = A x, adjoint =
    Aᵀλ).  Returns (x, lam, info); info["kkt"] holds the primal
    feasibility ‖Ax − b‖, the nonnegativity violation ‖min(x, 0)‖ and the
    objective cᵀx as Python floats."""
    dev = getattr(linop, "device", None)
    if dev is None:
        raise ValueError("solve_smoothed_lp: the operator has no device; "
                         "give it a `device` attribute (λ and x live there)")
    dev = T.resolve_device(dev)
    if getattr(linop, "row_shards", lambda: 1)() > 1:
        linop = _GatheredRows(linop)
    n = linop.in_shape[0]
    m = linop.out_shape[0]
    c = T.as_float_tensor(c, dev)
    b = T.as_float_tensor(b, dev)
    b = F.pad(b, (0, m - b.shape[0]))        # padding rows: 0 = 0
    x0 = torch.zeros(n, dtype=torch.float32, device=dev) if x0 is None \
        else T.as_float_tensor(x0, dev)
    opts = opts or TfocsOptions(max_iters=400, restart=True,
                                backtracking=True, L0=1.0)
    lam = torch.zeros(m, dtype=torch.float32, device=dev)
    info_all = {"continuations": []}
    adj = LinopAdjoint(linop)                  # λ ↦ Aᵀλ, adjoint x ↦ A x
    ident = LinopIdentity(m, dev)
    x_center = x = x0
    for _ in range(continuations):
        dual = _DualSmooth(c=c, x0=x_center, mu=mu)
        smooth = _AffineWrap(inner=dual, linop=adj, b=b)
        # The engine sees smooth(λ) over the identity on λ (+ ProxZero).
        lam, info = tfocs(smooth, ident, ProxZero(), lam, opts)
        x = dual.xstar(adj.apply(lam))
        x_center = x
        info_all["continuations"].append(info)
    info_all["kkt"] = {
        "primal_feasibility": float(torch.linalg.vector_norm(
            linop.apply(x) - b)),
        "nonneg_violation": float(torch.linalg.vector_norm(
            torch.clamp(x, max=0.0))),
        "objective": float(torch.dot(c, x)),
    }
    return x, lam, info_all
