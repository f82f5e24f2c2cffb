"""The compressed all-reduce with error feedback (``precision="psum8"``).

Counterpart of src/repro/train/compression.py:118-149 (``psum_int8``).
The reference's training compressors (int8/top-k/low-rank gradient
compression for the optimizer) come with the training half of ROADMAP
queue 1 item 15.
"""
from __future__ import annotations

import torch

from repro_torch import compat


def psum_int8(x: torch.Tensor, res: torch.Tensor, mesh=None, axes=(),
              nshards: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized all-reduce with error feedback, in place of
    ``compat.psum(x, mesh, axes)``.

    Every rank quantizes its error-corrected partial ``x + res`` against
    one SHARED scale (a ``pmax`` of the global absmax over 127 //
    nshards), so the int8 sum of all ranks stays within ±127 and the
    all-reduce itself runs on int8 (a quarter of the f32 bytes).  Rounding
    is to nearest, ties to even; the quantization error stays on the rank
    as its f32 residual and is added back next call, so its bias cancels
    across solver iterations.  Returns ``(total, new_res)``: the
    dequantized f32 sum and the rank's new residual.  On one rank the
    collectives are the identity and the call is a quantize-dequantize
    round trip with the same error feedback."""
    gf = x.float() + res
    qmax = max(127 // max(int(nshards), 1), 1)
    amax = compat.pmax(torch.amax(torch.abs(gf)), mesh, axes)
    scale = torch.clamp(amax, min=1e-12) / qmax
    q = torch.clamp(torch.round(gf / scale), -qmax, qmax).to(torch.int8)
    tot = compat.psum(q, mesh, axes)
    out = tot.float() * scale
    new_res = gf - q.float() * scale
    return out, new_res
