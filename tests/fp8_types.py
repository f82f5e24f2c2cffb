"""The fp8 storage types as tests/test_torch_fp8.py, tests/test_torch_e5m2.py
and tests/test_torch_sketch_fp8.py use them: each type's torch and jax
dtypes, its step, the cast's edge values and what lies past its largest
finite value.  Not a test module."""
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
import torch


def bits(x) -> np.ndarray:
    """The uint8 codes of an fp8 array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@dataclass(frozen=True)
class Fp8:
    """One fp8 storage type as the tests use it."""
    torch: torch.dtype
    jax: object
    mant: int                  # mantissa bits
    emin: int                  # exponent of the smallest normal value
    edges: np.ndarray          # the cast's edge values
    scales: tuple              # the random values' scales, past the max
    past: tuple                # values past the largest finite one ...
    past_nan: bool             # ... NaN (else inf) in both packages

    @property
    def name(self) -> str:
        return str(self.torch).removeprefix("torch.")

    def jcast(self, x) -> np.ndarray:
        return bits(jnp.asarray(x).astype(self.jax))

    def dequantized(self, A: np.ndarray) -> np.ndarray:
        return np.asarray(jnp.asarray(A).astype(self.jax)
                          .astype(jnp.float32))

    def one_step(self, got, want) -> bool:
        """Each entry within one step of `want`'s (2^(e - mant) at 2^e <=
        |want| < 2^(e+1), floored at the smallest normal)."""
        g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
        e = np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** self.emin)))
        return bool((np.abs(g - w) <= 2.0 ** (e - self.mant)).all())


TYPE_E4M3 = Fp8(
    torch.float8_e4m3fn, jnp.float8_e4m3fn, 3, -6,
    np.array([448, -448, 460, 463.9, 464, -464, 464.1, 500, -1000, 1e30,
              np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 2.0 ** -10,
              -2.0 ** -10, 2.0 ** -9, 1.5 * 2.0 ** -9, 2.0 ** -11,
              1.25 * 2.0 ** -9, 240.0, 247.99, 248.0, 0.3], np.float32),
    (1e-3, 1e-1, 1.0, 30.0, 300.0, 1000.0),
    (500.0, -470.0, 464.0, 1e5), True)

_NAN_BITS = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF812345,
                      0x7FFFFFFF], np.uint32).view(np.float32)
TYPE_E5M2 = Fp8(
    torch.float8_e5m2, jnp.float8_e5m2, 2, -14,
    np.concatenate([np.array(
        [57344, -57344, 49152, 53248, 57343, 61439, 61440, -61440, 61441,
         1e5, -1e6, 1e30, np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0,
         2.0 ** -14, 2.0 ** -15, 2.0 ** -16, -2.0 ** -16, 2.0 ** -17,
         1.5 * 2.0 ** -17, 3 * 2.0 ** -18, 1.25 * 2.0 ** -16, 0.3, 1.125,
         1.375], np.float32), _NAN_BITS]),
    (1e-6, 1e-3, 1.0, 30.0, 3e3, 3e4, 1e5),
    (62000.0, -61440.0, 1e5, np.nan), False)
