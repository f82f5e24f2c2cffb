"""Smooth components of composite objectives (paper §3.2.2 `SmoothQuad`).

Counterpart of src/repro/core/tfocs/smooth.py: the row-separable four, and
SmoothLinear (the smoothed-LP dual), SmoothHuberL1 and SmoothSum.  A smooth
is evaluated at the output of the linear operator, the data-space vector;
`weights` masks padding rows and doubles as per-example weights.  Values
are 0-dim tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RowSeparable:
    """f(z) = Σᵢ wᵢ ℓ(zᵢ, tᵢ): `kind` is the fused-kernel loss id ("quad" |
    "logistic" | "huber" | "poisson"), `target` the per-row data, `weights`
    the per-row weights (None ⇒ all ones; distributed layouts substitute
    their padding-row mask), `param` the loss's scalar (the huber δ)."""
    kind: str
    target: torch.Tensor
    weights: torch.Tensor | None
    param: float = 1.0


def row_separable(smooth) -> RowSeparable | None:
    """The smooth's row-separable form, or None when it has none."""
    fn = getattr(smooth, "as_row_separable", None)
    return fn() if fn is not None else None


def _w(weights, z):
    return torch.ones_like(z) if weights is None else weights


@dataclass(frozen=True)
class SmoothQuad:
    """f(z) = ½ Σ wᵢ (zᵢ − bᵢ)²."""
    b: torch.Tensor
    weights: torch.Tensor | None = None

    def value(self, z):
        r = z - self.b
        return 0.5 * torch.sum(_w(self.weights, z) * r * r)

    def grad(self, z):
        return _w(self.weights, z) * (z - self.b)

    def as_row_separable(self) -> RowSeparable:
        return RowSeparable("quad", self.b, self.weights)


@dataclass(frozen=True)
class SmoothLogLoss:
    """f(z) = Σ wᵢ log(1 + exp(−yᵢ zᵢ)), labels y ∈ {−1, +1}."""
    y: torch.Tensor
    weights: torch.Tensor | None = None

    def value(self, z):
        m = -self.y * z
        return torch.sum(_w(self.weights, z)
                         * torch.logaddexp(torch.zeros_like(m), m))

    def grad(self, z):
        return _w(self.weights, z) * (-self.y) * torch.sigmoid(-self.y * z)

    def as_row_separable(self) -> RowSeparable:
        return RowSeparable("logistic", self.y, self.weights)


@dataclass(frozen=True)
class SmoothHuber:
    """f(z) = Σ wᵢ huber_δ(zᵢ − bᵢ): ½d² inside |d| ≤ δ, δ(|d| − ½δ)
    outside."""
    b: torch.Tensor
    delta: float = 1.0
    weights: torch.Tensor | None = None

    def value(self, z):
        d = z - self.b
        a = torch.abs(d)
        return torch.sum(_w(self.weights, z) * torch.where(
            a <= self.delta, 0.5 * d * d, self.delta * (a - 0.5 * self.delta)))

    def grad(self, z):
        return _w(self.weights, z) * torch.clamp(z - self.b, -self.delta,
                                                 self.delta)

    def as_row_separable(self) -> RowSeparable:
        return RowSeparable("huber", self.b, self.weights,
                            param=float(self.delta))


@dataclass(frozen=True)
class SmoothPoisson:
    """f(z) = Σ wᵢ (e^{zᵢ} − yᵢ zᵢ), Poisson NLL with log link, y ≥ 0."""
    y: torch.Tensor
    weights: torch.Tensor | None = None

    def value(self, z):
        return torch.sum(_w(self.weights, z) * (torch.exp(z) - self.y * z))

    def grad(self, z):
        return _w(self.weights, z) * (torch.exp(z) - self.y)

    def as_row_separable(self) -> RowSeparable:
        return RowSeparable("poisson", self.y, self.weights)


@dataclass(frozen=True)
class SmoothLinear:
    """f(z) = cᵀz, used by the smoothed-LP dual."""
    c: torch.Tensor

    def value(self, z):
        return torch.dot(self.c, z)

    def grad(self, z):
        return self.c


@dataclass(frozen=True)
class SmoothHuberL1:
    """Huber-smoothed λ‖z‖₁ (for methods that need a smooth L1, such as
    L-BFGS in the Figure-1 problems)."""
    lam: float
    delta: float = 1e-4

    def value(self, z):
        a = torch.abs(z)
        quad = 0.5 * z * z / self.delta
        return self.lam * torch.sum(torch.where(a <= self.delta, quad,
                                                a - 0.5 * self.delta))

    def grad(self, z):
        return self.lam * torch.clamp(z / self.delta, -1.0, 1.0)


@dataclass(frozen=True)
class SmoothSum:
    """Pointwise sum of smooth components over the same argument."""
    parts: tuple

    def value(self, z):
        return sum(p.value(z) for p in self.parts)

    def grad(self, z):
        return sum(p.grad(z) for p in self.parts)
