"""computeSVD / computePCA (paper §3.1) for a RowMatrix or a
SparseRowMatrix.

Counterpart of src/repro/core/linalg/svd.py, with its three modes:

  * gram (§3.1.2, tall and skinny): one pass over A builds AᵀA (tsgram
    kernel; the sparse Gram through bsr_rmatmul), a local eigh gives Σ² and
    V, and one more pass recovers U = A (VΣ⁻¹) (gemm, or bsr_matmul for a
    SparseRowMatrix);
  * randomized (core/linalg/randsvd), RowMatrix only: 2 + 2q passes, the
    projections through the randsketch kernel; U falls out of the range
    basis;
  * lanczos (§3.1.1, core/linalg/lanczos): matrix-free thick-restart
    Lanczos on AᵀA, two A-passes per operator call (for a SparseRowMatrix
    bsr_matvec and bsr_rmatmul), then the U pass.

Wide inputs (m < n) go through the transpose and swap the factors back.
`mode="auto"` follows the reference planner's rule (launch/planner.py, op
"svd"): Lanczos for a SparseRowMatrix; for a RowMatrix gram for
n ≤ gram_threshold, else randomized for k ≤ randomized_k_threshold, else
Lanczos.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.distmat.rowmatrix import RowMatrix
from repro_torch.core.distmat.sparserow import SparseRowMatrix
from . import lanczos as _lanczos
from . import randsvd as _randsvd

# n at which an n×n float32 Gram stops being comfortable to hold and factor.
GRAM_THRESHOLD = 8192
# Past the Gram threshold, k at which Lanczos' sequential directions beat
# the (2 + 2q)-pass sketch.
RANDOMIZED_K_THRESHOLD = 128
_MODES = ("auto", "gram", "lanczos", "randomized")


@dataclass(frozen=True)
class SVDResult:
    U: RowMatrix | None     # (m, k) left singular vectors
    s: torch.Tensor         # (k,) singular values, descending
    V: torch.Tensor         # (n, k) right singular vectors
    info: dict | None = None


def _recover_u(A, s: torch.Tensor, V: torch.Tensor,
               rcond: float) -> RowMatrix:
    """U = A (V Σ⁻¹): one product with the small factor, no reduction."""
    inv = torch.where(s > rcond * torch.max(s),
                      1.0 / torch.clamp(s, min=1e-30), 0.0)
    return A.multiply_local(V * inv[None, :])


def _transpose(A):
    if isinstance(A, SparseRowMatrix):
        return A.transpose()
    return RowMatrix.create(A.to_local().T, device=A.device)


def _swap_transposed(A, res: SVDResult,
                     compute_u: bool) -> SVDResult:
    """SVD(Aᵀ) = U'ΣV'ᵀ ⇒ A = V'ΣU'ᵀ: V of A is U', U of A is V'."""
    V = res.U.to_local()
    U = RowMatrix.create(res.V, device=A.device) if compute_u else None
    return SVDResult(U=U, s=res.s, V=V,
                     info=dict(res.info or {}, transposed=True))


def auto_mode(n: int, k: int, *, gram_threshold: int = GRAM_THRESHOLD,
              randomized_k_threshold: int = RANDOMIZED_K_THRESHOLD,
              sparse: bool = False) -> str:
    """The reference planner's mode for n columns and k asked triplets:
    a sparse operator always takes the matrix-free Lanczos iteration."""
    if sparse:
        return "lanczos"
    if n <= gram_threshold:
        return "gram"
    if k <= randomized_k_threshold:
        return "randomized"
    return "lanczos"


def compute_svd(A, k: int, *, compute_u: bool = True,
                mode: str = "auto", gram_threshold: int = GRAM_THRESHOLD,
                randomized_k_threshold: int = RANDOMIZED_K_THRESHOLD,
                oversampling: int = _randsvd.OVERSAMPLING,
                power_iters: int = _randsvd.POWER_ITERS,
                rcond: float = 1e-9, seed: int = 0,
                **lanczos_kw) -> SVDResult:
    """Top-k singular triplets of a RowMatrix or SparseRowMatrix.
    `lanczos_kw` (ncv, max_restarts, tol) go to the Lanczos mode."""
    if not isinstance(A, (RowMatrix, SparseRowMatrix)):
        raise TypeError(f"compute_svd needs a RowMatrix or SparseRowMatrix, "
                        f"got {type(A).__name__}")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}; expected auto | gram | "
                         "lanczos | randomized")
    m, n = A.shape
    k = min(k, min(m, n))
    if m < n:
        res = compute_svd(_transpose(A), k, compute_u=True, mode=mode,
                          gram_threshold=gram_threshold,
                          randomized_k_threshold=randomized_k_threshold,
                          oversampling=oversampling, power_iters=power_iters,
                          rcond=rcond, seed=seed, **lanczos_kw)
        return _swap_transposed(A, res, compute_u)
    if mode == "auto":
        mode = auto_mode(n, k, gram_threshold=gram_threshold,
                         randomized_k_threshold=randomized_k_threshold,
                         sparse=isinstance(A, SparseRowMatrix))
    if mode == "lanczos":
        # Each operator call is a matvec and an rmatvec: 2 A-passes.
        s, V, info = _lanczos.svd_via_lanczos(A, k, seed=seed, **lanczos_kw)
        info = dict(info, mode="lanczos", plan="lanczos",
                    iterations=info["restarts"],
                    a_passes=2 * info["op_calls"])
        return _with_u(A, s, V, info, compute_u, rcond)
    if mode == "randomized":
        if not isinstance(A, RowMatrix):
            raise ValueError("mode='randomized' needs a RowMatrix "
                             "(row-sharded sketch/project primitives)")
        # Few-pass sketch path: U falls out of the range basis, so there
        # is no extra pass for it.
        U, s, V, info = _randsvd.randomized_svd(
            A, k, oversampling=oversampling, power_iters=power_iters,
            seed=seed, compute_u=compute_u)
        info = dict(info, plan="randomized", iterations=power_iters,
                    a_passes=info["passes_over_A"], converged=True)
        return SVDResult(U=U, s=s, V=V, info=info)
    G = A.gram().float()
    w, V = torch.linalg.eigh(G)
    w, V = w.flip(0)[:k], V.flip(1)[:, :k]
    s = torch.sqrt(torch.clamp(w, min=0.0))
    info = {"mode": "gram", "plan": "gram", "iterations": 0, "a_passes": 1,
            "converged": True}
    return _with_u(A, s, V, info, compute_u, rcond)


def _with_u(A, s: torch.Tensor, V: torch.Tensor, info: dict,
            compute_u: bool, rcond: float) -> SVDResult:
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
