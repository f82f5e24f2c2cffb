"""The one cast to float8_e4m3fn, and the cast of any result to its type.

Every e4m3 value the port makes comes from ``to_e4m3``: the storage of a
RowMatrix (one device and each rank's strip), ``astype_store``, convert's
tensors, and the e4m3 outputs of tsgram and gemm (their f32 result cast
here, on the card and in their plain versions alike).
"""
from __future__ import annotations

import torch

# e4m3fn's largest finite value is 448 (1.75 * 2^8); values past the
# midpoint 464 to the next step round to the NaN code.
E4M3_ROUNDS_TO_NAN = 464.0
_CAST_CHUNK = 1 << 24          # elements cast at a time (bounds the temps)


def to_e4m3(t: torch.Tensor) -> torch.Tensor:
    """`t` cast to float8_e4m3fn as the reference casts it (``astype``):
    round to nearest even, and NaN, with x's sign, where |x| > 464 (x
    rounds past 448), is infinite or is NaN.  torch's own cast saturates
    those to ±448, so its result is kept where |x| <= 464 (there the two
    agree bit for bit) and the NaN codes are written over the rest.
    float64 is cast to float32 first, as the reference keeps it."""
    if t.dtype == torch.float8_e4m3fn:
        return t
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.float()
    src = t.reshape(-1)
    out = torch.empty(src.shape, dtype=torch.uint8, device=t.device)
    for i in range(0, src.numel(), _CAST_CHUNK):
        x = src[i:i + _CAST_CHUNK]
        bits = x.to(torch.float8_e4m3fn).view(torch.uint8)
        nan = ~(x.abs() <= E4M3_ROUNDS_TO_NAN)
        neg = torch.signbit(x)
        bits.masked_fill_(nan & neg, 0xFF).masked_fill_(nan & ~neg, 0x7F)
        out[i:i + _CAST_CHUNK] = bits
    return out.view(torch.float8_e4m3fn).view(t.shape)


def cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """`t` in `dtype`: float8_e4m3fn through to_e4m3, any other type
    through ``Tensor.to``."""
    return to_e4m3(t) if dtype == torch.float8_e4m3fn else t.to(dtype)
