"""The Figure-1 optimizer family (paper §3.3) on the TFOCS engine.

Counterpart of src/repro/core/optim/first_order.py.  `gra / acc / acc_r /
acc_b / acc_rb` are the one engine with flags (core.tfocs.solver); `lbfgs`
is core.optim.lbfgs, on the same composite.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.core.distmat import types as T
from repro_torch.core.tfocs.prox import ProxZero
from repro_torch.core.tfocs.solver import TfocsOptions, tfocs

METHODS = ("gra", "acc", "acc_r", "acc_b", "acc_rb", "lbfgs")

_FLAGS = {
    #            accel  backtracking restart
    "gra":      (False, False,       False),
    "acc":      (True,  False,       False),
    "acc_r":    (True,  False,       True),
    "acc_b":    (True,  True,        False),
    "acc_rb":   (True,  True,        True),
}


def minimize_first_order(method: str, smooth, linop, prox=None, x0=None,
                         opts: TfocsOptions | None = None):
    """Run a paper-named method; returns (x, info)."""
    if method == "lbfgs":
        from .lbfgs import lbfgs_composite
        return lbfgs_composite(smooth, linop, prox, x0, opts)
    if method not in _FLAGS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    accel, bt, restart = _FLAGS[method]
    opts = opts or TfocsOptions()
    opts = replace(opts, accel=accel, backtracking=bt, restart=restart)
    if not bt and opts.Lexact is None:
        # Fixed-step variants use 1/step_size as the exact Lipschitz bound.
        opts = replace(opts, Lexact=opts.L0)
    prox = prox or ProxZero()
    if x0 is None:
        x0 = torch.zeros(linop.in_shape, dtype=torch.float32,
                         device=T.resolve_device(linop.device))
    return tfocs(smooth, linop, prox, x0, opts)
