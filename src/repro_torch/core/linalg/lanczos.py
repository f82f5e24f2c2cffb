"""Matrix-free thick-restart Lanczos, the ARPACK (IRLM) analogue (paper
§3.1.1).

Counterpart of src/repro/core/linalg/lanczos.py.  The Krylov basis, the
small projected matrix T and the Ritz math are "driver" state on the
operator's device; the only contact with the matrix is `op(v)`, the
normal-equations product v ↦ Aᵀ(A v) (`DistMatrix.normal_op`), which for a
SparseRowMatrix is one bsr_matvec and one bsr_rmatmul.  Thick restart (Wu &
Simon 2000) keeps the k wanted Ritz vectors and the residual direction,
and every new direction is orthogonalized against the basis twice (DGKS).

The reference's `while_loop` / `fori_loop` are Python loops over device
tensors here; the restart test is one host sync per cycle.  v0 comes from
a torch.Generator seeded with `seed`, so it is not the reference's v0:
compare values and subspaces, not iterates.
"""
from __future__ import annotations

from typing import Callable

import torch


def _orthogonalize(w: torch.Tensor, V: torch.Tensor, upto: int
                   ) -> torch.Tensor:
    """Project w against the first `upto` rows of V, twice (DGKS)."""
    Vm = V[:upto]
    for _ in range(2):          # "twice is enough" (Kahan, Parlett)
        w = w - Vm.T @ (Vm @ w)
    return w


def lanczos_eigsh(op: Callable[[torch.Tensor], torch.Tensor], n: int, k: int,
                  *, ncv: int | None = None, max_restarts: int = 40,
                  tol: float = 1e-6, seed: int = 0, device="cpu"
                  ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Top-k eigenpairs of a symmetric PSD operator `op` of size n, in
    float32 on `device`.

    Returns (eigenvalues descending (k,), eigenvectors (n, k), info) with
    info["restarts"], ["resid"] (the k Ritz residual estimates),
    ["converged"], ["ncv"] and ["op_calls"]."""
    ncv = ncv or min(n, max(2 * k + 1, 20))
    if not (k < ncv <= n):
        raise ValueError(f"need k < ncv <= n, got k={k} ncv={ncv} n={n}")
    dev = torch.device(device)
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    v0 = torch.randn(n, generator=gen, device=dev, dtype=f32)
    V = torch.zeros((ncv + 1, n), device=dev, dtype=f32)
    V[0] = v0 / torch.linalg.vector_norm(v0)
    T = torch.zeros((ncv, ncv), device=dev, dtype=f32)
    beta = torch.zeros((), device=dev, dtype=f32)
    ritz = torch.zeros(ncv, device=dev, dtype=f32)
    resid = torch.full((ncv,), torch.inf, device=dev, dtype=f32)
    j = restarts = op_calls = 0
    done = False
    while not done and restarts < max_restarts:
        while j < ncv:
            # One Lanczos step: an operator call plus vector math.  The
            # whole masked coefficient column keeps T right in both the
            # tridiagonal and the thick-restart arrowhead phase.
            w = op(V[j])
            op_calls += 1
            coeffs = V[: j + 1] @ w                       # T[: j+1, j]
            w = _orthogonalize(w, V, j + 1)
            beta = torch.linalg.vector_norm(w)
            V[j + 1] = w / torch.where(beta > 0, beta, 1.0)
            T[:, j] = 0.0
            T[j, :] = 0.0
            T[: j + 1, j] = coeffs
            T[j, : j + 1] = coeffs
            if j + 1 < ncv:
                T[j + 1, j] = beta
                T[j, j + 1] = beta
            j += 1
        # Ritz extraction and thick restart (≙ ARPACK dsaupd).
        theta, S = torch.linalg.eigh(T)                  # ascending
        theta, S = theta.flip(0), S.flip(1)              # descending
        resid = torch.abs(beta * S[-1, :])
        scale = torch.clamp(theta.abs().max(), min=1e-30)
        done = bool(torch.all(resid[:k] <= tol * scale))
        Y = S[:, :k].T @ V[:-1]                          # (k, n) Ritz vectors
        last = V[-1].clone()
        V.zero_()
        V[:k] = Y
        V[k] = last
        b = beta * S[-1, :k]                             # arrowhead coupling
        T = torch.zeros_like(T)
        T.diagonal()[:k] = theta[:k]
        T[k, :k] = b
        T[:k, k] = b
        ritz = theta
        j = k
        restarts += 1
    info = {"restarts": restarts, "resid": resid[:k], "converged": done,
            "ncv": ncv, "op_calls": op_calls}
    return ritz[:k], V[:k].T, info


def svd_via_lanczos(A, k: int, **kw):
    """SVD of A from the eigendecomposition of AᵀA, where Lanczos only calls
    the normal-equations product: (σ (k,), V (n, k), info)."""
    _, n = A.shape
    vals, V, info = lanczos_eigsh(A.normal_op(), n, k, device=A.device, **kw)
    return torch.sqrt(torch.clamp(vals, min=0.0)), V, info
