"""Mamba1 selective scan: the recurrence h_t = exp(dt_t·A)∘h_{t−1} +
dt_t·x_t·B_t, y_t = C_t·h_t + D·x_t, with its final state.

Replaces the TPU kernel ``src/repro/kernels/selective_scan.py:
selective_scan`` (``_scan_kernel``): the prefill scan of the Mamba1
serving path, and of Mamba2's (zamba2, N = 64), whose per-head recurrence
is this one with dt and A repeated over a head's channels.  On the H100 it
is bound by operations, Bt·S·d·N exponentials on the special-function
units, against one read of x and dt and one write of y, which take about
as long.  ``csrc/selective_scan.cu`` splits each (batch, channel)'s N
states over N/8 adjacent lanes of a warp (8 states a lane in registers:
eight lanes a channel at N = 64, four at 32, two at 16, one at 8), so that
enough warps are in flight to hide each step's latency; each exponential
is one ``ex2.approx`` of dt times A pre-scaled by log2(e), and every 4
steps the lanes of a channel sum their parts of y by a ``reduce_scatter``
(at N = 64 two lanes end with each step's sum, and one stores it).  The
walk over S runs in order.  16-step tiles of x and dt (the block's 16 to
128 channels: 128 threads over the lanes of a channel) and of B_t and C_t
stream through a 3-stage ring of 16-byte ``cp.async`` copies, each step's
row of x and dt from its 16-byte-aligned window, and y leaves through a
staged tile, coalesced.  It
starts from an optional h0 and writes the final state, which the reference
kernel lists as optional but does not write; prefill into a cache needs
it.

``selective_scan_plain`` is the same function in plain torch: the
sequential loop of ``ref.selective_scan_ref``.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

STATE_DIMS = (8, 16, 32, 64)


def selective_scan_plain(x, dt, A, B, C, D, h0=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (Bt, S, d); A: (d, N); B, C: (Bt, S, N); D: (d,); h0 (Bt, d,
    N) or None.  Returns (y (Bt, S, d) in x.dtype, f32 final state)."""
    return _ref.selective_scan_ref(x, dt, A, B, C, D, h0=h0)


def selective_scan(x, dt, A, B, C, D, h0=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/selective_scan.cu on contiguous f32 CUDA tensors (N in
    STATE_DIMS); returns (y (Bt, S, d), final state (Bt, d, N)), f32."""
    tensors = (x, dt, A, B, C, D) + (() if h0 is None else (h0,))
    dev = _build.check_device(*tensors)
    Bt, S, d = x.shape
    N = A.shape[-1]
    shapes = {"x": (x, (Bt, S, d)), "dt": (dt, (Bt, S, d)), "A": (A, (d, N)),
              "B": (B, (Bt, S, N)), "C": (C, (Bt, S, N)), "D": (D, (d,))}
    if h0 is not None:
        shapes["h0"] = (h0, (Bt, d, N))
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N not in STATE_DIMS:
        raise ValueError(f"state dim {N} is not one of {STATE_DIMS}")
    # The kernel copies x, dt, B and C in 16-byte pieces from 16-byte
    # boundaries: a view that starts off one is copied to one that does not.
    x, dt, B, C = (_build.aligned(t) for t in (x, dt, B, C))
    y = torch.empty_like(x)
    h_out = torch.empty((Bt, d, N), dtype=torch.float32, device=dev)
    _build.check(_build.lib().repro_selective_scan(
        dev.index, x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_out.data_ptr(), Bt, S, d, N, _build.stream(dev)),
        "selective_scan launch")
    selective_scan.launches += 1
    return y, h_out


selective_scan.launches = 0
