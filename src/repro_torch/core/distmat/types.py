"""Device resolution, row padding and the DistMatrix protocol.

Counterpart of src/repro/core/distmat/types.py.  The reference lays a
matrix out over a TPU mesh; the port runs on one device, so there is one
row shard and the cross-shard sum (psum) is the identity.  The padded-row
semantics stay: `rows` may hold more rows than `n_rows`, and padding rows
carry weight 0 in every loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises for CUDA when there is no card, so
    an entry point never drops to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_float_tensor(v, device: torch.device) -> torch.Tensor:
    """`v` on `device`; float64 becomes float32, as jax keeps it."""
    t = torch.as_tensor(v, device=device)
    return t.float() if t.dtype == torch.float64 else t


def pad_rows(x: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    """Pad axis 0 of `x` to a multiple; returns (padded, original_rows)."""
    m = x.shape[0]
    rem = (-m) % multiple
    if rem:
        x = torch.cat([x, x.new_zeros((rem, *x.shape[1:]))])
    return x, m


def _pad1(v: torch.Tensor, m_pad: int) -> torch.Tensor:
    return F.pad(v, (0, m_pad - v.shape[0])) if v.shape[0] < m_pad else v


def row_separable_inputs(smooth, m_pad: int, row_mask_fn: Callable):
    """Resolve a smooth (or its RowSeparable form) into fused-gradient
    kernel inputs: (kind, target, weights, param) with the data-space
    vectors padded to `m_pad` rows.  Default weights come from
    `row_mask_fn()` so padding rows contribute nothing; explicit weights are
    zero-padded, same effect."""
    sep = smooth if hasattr(smooth, "kind") else (
        smooth.as_row_separable()
        if hasattr(smooth, "as_row_separable") else None)
    if sep is None:
        raise ValueError("fused_grad needs a row-separable smooth")
    t = _pad1(torch.as_tensor(sep.target), m_pad)
    w = row_mask_fn() if sep.weights is None \
        else _pad1(torch.as_tensor(sep.weights), m_pad)
    return sep.kind, t, w, float(getattr(sep, "param", 1.0))


def row_separable_batch_inputs(smooths, m_pad: int, row_mask_fn: Callable):
    """Resolve a group of row-separable smooths into multi-RHS fused kernel
    inputs: (kind, targets (k × m_pad), weights (k × m_pad), param).

    `smooths` is a sequence of k smooths sharing one loss kind and param
    (what makes them one servable group), or a single smooth whose target
    and weights are already stacked 2-D (k × m).  Mixed kinds or params
    raise."""
    def resolve(s):
        sep = s if hasattr(s, "kind") else (
            s.as_row_separable() if hasattr(s, "as_row_separable") else None)
        if sep is None:
            raise ValueError("fused_grad_multi needs row-separable smooths")
        return sep

    if not isinstance(smooths, (list, tuple)):
        sep = resolve(smooths)
        t = torch.atleast_2d(torch.as_tensor(sep.target))
        seps = [sep]
        ts = list(t)
        ws = ([None] * t.shape[0] if sep.weights is None
              else list(torch.atleast_2d(torch.as_tensor(sep.weights))))
    else:
        seps = [resolve(s) for s in smooths]
        ts = [torch.as_tensor(s.target) for s in seps]
        ws = [None if s.weights is None else torch.as_tensor(s.weights)
              for s in seps]

    kinds = {s.kind for s in seps}
    params = {float(getattr(s, "param", 1.0)) for s in seps}
    if len(kinds) != 1 or len(params) != 1:
        raise ValueError(
            f"a fused group must share one loss kind/param, got "
            f"{sorted(kinds)} / {sorted(params)}")
    mask = row_mask_fn()
    t2 = torch.stack([_pad1(t, m_pad) for t in ts])
    w2 = torch.stack([mask if w is None else _pad1(w, m_pad) for w in ws])
    return kinds.pop(), t2, w2, params.pop()


@dataclass(frozen=True)
class DistMatrix:
    """Base for distributed matrices."""

    @property
    def shape(self) -> tuple[int, int]:  # pragma: no cover - abstract
        raise NotImplementedError

    def matvec(self, v: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def to_local(self) -> torch.Tensor:  # pragma: no cover - abstract
        raise NotImplementedError

    def normal_op(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """v ↦ Aᵀ(A v): the only operator the Lanczos SVD needs."""
        return lambda v: self.rmatvec(self.matvec(v))
