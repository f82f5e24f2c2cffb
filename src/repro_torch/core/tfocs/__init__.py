from .linop import LinopMatrix, LinopIdentity, LinopAdjoint, CountingLinop
from .smooth import (SmoothQuad, SmoothLogLoss, SmoothLinear, SmoothHuber,
                     SmoothHuberL1, SmoothPoisson, SmoothSum, RowSeparable,
                     row_separable)
from .prox import ProxZero, ProxL1, ProxL2Sq, ProxNonneg, ProxBox
from .solver import tfocs, TfocsOptions, fused_gradient_enabled
from .lp import solve_smoothed_lp
from .lasso import solve_lasso

__all__ = [
    "LinopMatrix", "LinopIdentity", "LinopAdjoint", "CountingLinop",
    "SmoothQuad", "SmoothLogLoss", "SmoothLinear", "SmoothHuber",
    "SmoothHuberL1", "SmoothPoisson", "SmoothSum", "RowSeparable",
    "row_separable",
    "ProxZero", "ProxL1", "ProxL2Sq", "ProxNonneg", "ProxBox",
    "tfocs", "TfocsOptions", "fused_gradient_enabled",
    "solve_smoothed_lp", "solve_lasso",
]
