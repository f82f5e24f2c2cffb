from .linop import LinopMatrix, LinopIdentity, CountingLinop
from .smooth import (SmoothQuad, SmoothLogLoss, SmoothHuber, SmoothPoisson,
                     RowSeparable, row_separable)
from .prox import ProxZero, ProxL1, ProxL2Sq, ProxNonneg, ProxBox
from .solver import tfocs, TfocsOptions, fused_gradient_enabled

__all__ = [
    "LinopMatrix", "LinopIdentity", "CountingLinop",
    "SmoothQuad", "SmoothLogLoss", "SmoothHuber", "SmoothPoisson",
    "RowSeparable", "row_separable",
    "ProxZero", "ProxL1", "ProxL2Sq", "ProxNonneg", "ProxBox",
    "tfocs", "TfocsOptions", "fused_gradient_enabled",
]
