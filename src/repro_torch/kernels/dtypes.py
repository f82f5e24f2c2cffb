"""The casts to float8_e4m3fn and float8_e5m2, and the cast of any result
to its type.

Every fp8 value the port makes comes from ``to_e4m3`` or ``to_e5m2``
(through ``cast``): the storage of a RowMatrix (one device and each rank's
strip), ``astype_store``, convert's tensors, the sketch's test matrix,
and the fp8 outputs of tsgram, gemm and randsketch (their f32 result cast
here, on the card and in their plain versions alike).
"""
from __future__ import annotations

import torch

# The fp8 storage types.
FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)

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


def to_e5m2(t: torch.Tensor) -> torch.Tensor:
    """`t` cast to float8_e5m2 as the reference casts it (``astype``):
    torch's own cast, which agrees with it bit for bit on every number
    (round to nearest even, ±inf past the overflow midpoint 61440), with
    the reference's NaN codes written over torch's: from float32, 0x7E
    with x's sign (torch writes 0x7F); from bfloat16, 0x7F whatever the
    sign.  float64 is cast to float32 first, as the reference keeps it."""
    if t.dtype == torch.float8_e5m2:
        return t
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.float()
    src = t.reshape(-1)
    out = torch.empty(src.shape, dtype=torch.uint8, device=t.device)
    for i in range(0, src.numel(), _CAST_CHUNK):
        x = src[i:i + _CAST_CHUNK]
        bits = x.to(torch.float8_e5m2).view(torch.uint8)
        nan = torch.isnan(x)
        if t.dtype == torch.bfloat16:
            bits.masked_fill_(nan, 0x7F)
        else:
            neg = torch.signbit(x)
            bits.masked_fill_(nan & neg, 0xFE).masked_fill_(nan & ~neg, 0x7E)
        out[i:i + _CAST_CHUNK] = bits
    return out.view(torch.float8_e5m2).view(t.shape)


def cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """`t` in `dtype`: float8_e4m3fn through to_e4m3, float8_e5m2 through
    to_e5m2, any other type through ``Tensor.to``."""
    if dtype == torch.float8_e4m3fn:
        return to_e4m3(t)
    if dtype == torch.float8_e5m2:
        return to_e5m2(t)
    return t.to(dtype)
