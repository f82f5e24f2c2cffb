"""computeSVD / computePCA in Gram mode (paper §3.1.2, tall and skinny).

Counterpart of src/repro/core/linalg/svd.py for a RowMatrix: one pass over
A builds AᵀA (tsgram kernel), a local eigh gives Σ² and V, and one more
pass recovers U = A (VΣ⁻¹) (gemm kernel).  Wide inputs (m < n) go through
the transpose and swap the factors back.

`mode="auto"` picks gram for n ≤ GRAM_THRESHOLD, as the reference planner
does; the Lanczos and randomized modes wait for their own ports.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.distmat.rowmatrix import RowMatrix

# n at which an n×n float32 Gram stops being comfortable to hold and factor.
GRAM_THRESHOLD = 8192
_MODES = ("auto", "gram", "lanczos", "randomized")
_WAITING = {
    "lanczos": "ROADMAP queue 1 item 5a (L-BFGS and Lanczos)",
    "randomized": "ROADMAP queue 1 item 7 (randomized SVD)",
}


@dataclass(frozen=True)
class SVDResult:
    U: RowMatrix | None     # (m, k) left singular vectors
    s: torch.Tensor         # (k,) singular values, descending
    V: torch.Tensor         # (n, k) right singular vectors
    info: dict | None = None


def _recover_u(A: RowMatrix, s: torch.Tensor, V: torch.Tensor,
               rcond: float) -> RowMatrix:
    """U = A (V Σ⁻¹): one product with the small factor, no reduction."""
    inv = torch.where(s > rcond * torch.max(s),
                      1.0 / torch.clamp(s, min=1e-30), 0.0)
    return A.multiply_local(V * inv[None, :])


def _transpose(A: RowMatrix) -> RowMatrix:
    return RowMatrix.create(A.to_local().T, device=A.device)


def _swap_transposed(A: RowMatrix, res: SVDResult,
                     compute_u: bool) -> SVDResult:
    """SVD(Aᵀ) = U'ΣV'ᵀ ⇒ A = V'ΣU'ᵀ: V of A is U', U of A is V'."""
    V = res.U.to_local()
    U = RowMatrix.create(res.V, device=A.device) if compute_u else None
    return SVDResult(U=U, s=res.s, V=V,
                     info=dict(res.info or {}, transposed=True))


def compute_svd(A: RowMatrix, k: int, *, compute_u: bool = True,
                mode: str = "auto", gram_threshold: int = GRAM_THRESHOLD,
                rcond: float = 1e-9) -> SVDResult:
    if not isinstance(A, RowMatrix):
        raise TypeError(f"compute_svd needs a RowMatrix, got {type(A).__name__}")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}; expected auto | gram | "
                         "lanczos | randomized")
    m, n = A.shape
    k = min(k, min(m, n))
    if m < n:
        res = compute_svd(_transpose(A), k, compute_u=True, mode=mode,
                          gram_threshold=gram_threshold, rcond=rcond)
        return _swap_transposed(A, res, compute_u)
    if mode == "auto":
        if n > gram_threshold:
            raise NotImplementedError(
                f"n={n} > {gram_threshold}: the reference takes the "
                f"randomized or Lanczos mode, which wait for "
                f"{_WAITING['randomized']} and {_WAITING['lanczos']}")
        mode = "gram"
    if mode != "gram":
        raise NotImplementedError(f"mode={mode!r} waits for {_WAITING[mode]}")
    G = A.gram().float()
    w, V = torch.linalg.eigh(G)
    w, V = w.flip(0)[:k], V.flip(1)[:, :k]
    s = torch.sqrt(torch.clamp(w, min=0.0))
    info = {"mode": "gram", "plan": "gram", "iterations": 0, "a_passes": 1,
            "converged": True}
    U = None
    if compute_u:
        U = _recover_u(A, s, V, rcond)
        info["a_passes"] += 1          # the U = A(VΣ⁻¹) pass
    return SVDResult(U=U, s=s, V=V, info=info)


def compute_pca(A: RowMatrix, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Principal components from the Gram matrix with the rank-one mean
    correction; never forms the centered matrix.  Returns (components
    (n, k), explained variance (k,))."""
    m, n = A.shape
    mu = A.column_stats()["mean"]
    G = A.gram().float()
    cov = (G - m * torch.outer(mu, mu)) / max(m - 1, 1)
    w, V = torch.linalg.eigh(cov)
    w, V = w.flip(0)[:k], V.flip(1)[:, :k]
    return V, torch.clamp(w, min=0.0)
