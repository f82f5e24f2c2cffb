"""Randomized SVD via a blocked Gaussian range finder (Halko–Martinsson–
Tropp; distributed form after Li–Kluger–Tygert).

Counterpart of src/repro/core/linalg/randsvd.py: the `compute_svd` mode for
n too large for the Gram path but k small.  The range finder needs
2 + 2·q passes over A, built from the RowMatrix primitives:

  * ``A.sketch(r)``       — Y = AΩ, Ω drawn from a seeded generator;
  * ``tsqr``              — re-orthonormalization of the (m × r) basis after
    every pass (float32 loses the range fast without it);
  * ``A.project(Q)``      — B = AᵀQ (the randsketch kernel);
  * ``A.multiply_local``  — Y = AZ (the gemm kernel);
  * a local SVD of the small (r × n) projection.

Ω comes from torch's generator, not jax.random's, so the port's factors
differ from the reference's entry for entry; the singular values agree.
"""
from __future__ import annotations

import torch

from repro_torch.core.distmat import types as T
from repro_torch.core.distmat.rowmatrix import RowMatrix
from . import tsqr as _tsqr

# Default knobs (Halko et al. §4.3: small constant oversampling plus a
# couple of power iterations is enough for spectra with any visible decay).
OVERSAMPLING = 10
POWER_ITERS = 2


def randomized_range_finder(A: RowMatrix, r: int, *, power_iters: int,
                            seed: int) -> RowMatrix:
    """Orthonormal (m × r) basis Q for the range of (A Aᵀ)^q A.  Every pass
    re-orthonormalizes: the tall factor through TSQR, the small (n × r)
    factor through a local QR."""
    Y = A.sketch(r, seed=seed)                    # 1 pass:  Y = AΩ
    Q, _ = _tsqr.tsqr(Y)
    for _ in range(power_iters):
        Z = A.project(Q)                          # 1 pass:  Z = AᵀQ  (n × r)
        Z, _ = torch.linalg.qr(Z)                 # local reorth
        Y = A.multiply_local(Z)                   # 1 pass:  Y = AZ   (m × r)
        Q, _ = _tsqr.tsqr(Y)
    return Q


def randomized_svd(A: RowMatrix, k: int, *, oversampling: int = OVERSAMPLING,
                   power_iters: int = POWER_ITERS, seed: int = 0,
                   compute_u: bool = True
                   ) -> tuple[RowMatrix | None, torch.Tensor, torch.Tensor,
                              dict]:
    """Rank-k truncated SVD of A.  Returns (U (m × k) RowMatrix or None,
    s (k,), V (n × k), info).  U comes from rotating the range basis,
    U = Q·Ub: a product with Q, no extra pass over A.  fp8 storage
    (float8_e4m3fn, float8_e5m2) raises TypeError before any launch, where
    the reference's raises at TSQR of its fp8 sketch."""
    T.refuse_fp8(A.rows.dtype, "the randomized SVD")
    m, n = A.shape
    r = min(k + oversampling, min(m, n))
    if not k <= r:
        raise ValueError(f"need k <= k+p <= min(m,n), got k={k} r={r}")
    Q = randomized_range_finder(A, r, power_iters=power_iters, seed=seed)
    B = A.project(Q)                              # (n × r), Bᵀ = QᵀA
    # Local small SVD: Bᵀ = Ub Σ Vᵀ  ⇒  A ≈ (Q Ub) Σ Vᵀ.
    Ub, s, Vt = torch.linalg.svd(B.T.float(), full_matrices=False)
    info = {
        "mode": "randomized",
        "rank": r,
        "oversampling": oversampling,
        "power_iters": power_iters,
        "seed": seed,
        "passes_over_A": 2 + 2 * power_iters,
        # Convergence proxy: how much spectrum the oversampled tail still
        # carries; near zero means the basis caught the top-k subspace.
        "tail_ratio": (float(s[k] / torch.clamp(s[0], min=1e-30))
                       if r > k else float("nan")),
    }
    U = Q.multiply_local(Ub[:, :k]) if compute_u else None
    return U, s[:k], Vt[:k].T, info
