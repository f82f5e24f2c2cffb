"""Nonsmooth prox-capable components (paper §3.2.2 `ProxL1`).

Counterpart of src/repro/core/tfocs/prox.py.  prox_h(x, t) = argmin_u
h(u) + 1/(2t) ‖u − x‖²; vector math on the solver's variable.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ProxZero:
    """h ≡ 0 (unconstrained smooth minimization)."""

    def value(self, x):
        return x.new_zeros(())

    def prox(self, x, t):
        return x


@dataclass(frozen=True)
class ProxL1:
    """h(x) = λ‖x‖₁ → soft thresholding."""
    lam: float

    def value(self, x):
        return self.lam * torch.sum(torch.abs(x))

    def prox(self, x, t):
        return torch.sign(x) * torch.clamp(torch.abs(x) - t * self.lam, min=0.0)


@dataclass(frozen=True)
class ProxL2Sq:
    """h(x) = (λ/2)‖x‖₂² → shrinkage."""
    lam: float

    def value(self, x):
        return 0.5 * self.lam * torch.dot(x, x)

    def prox(self, x, t):
        return x / (1.0 + t * self.lam)


@dataclass(frozen=True)
class ProxNonneg:
    """Indicator of {x ≥ 0} → projection."""

    def value(self, x):
        return x.new_zeros(())   # +inf outside; solvers stay inside

    def prox(self, x, t):
        return torch.clamp(x, min=0.0)


@dataclass(frozen=True)
class ProxBox:
    lo: float
    hi: float

    def value(self, x):
        return x.new_zeros(())

    def prox(self, x, t):
        return torch.clamp(x, self.lo, self.hi)
