"""computeSVD / computePCA (paper §3.1) for the §2 matrix types: RowMatrix,
SparseRowMatrix, IndexedRowMatrix, CoordinateMatrix and BlockMatrix.

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

Wide inputs (m < n) go through the transpose where the type has one
(RowMatrix and SparseRowMatrix by a copy, CoordinateMatrix for free
by swapping its index tensors) and swap the factors back; when the
transposed type returns no U (a CoordinateMatrix), V comes back as
AᵀV′Σ⁻¹, k matvecs.  IndexedRowMatrix and BlockMatrix have no transpose
here and take Lanczos on AᵀA directly.  `mode="auto"` follows the
reference planner's rule (launch/planner.py, op "svd"): Lanczos for every
type but RowMatrix; for a RowMatrix gram for n ≤ gram_threshold, else
randomized for k ≤ randomized_k_threshold, else Lanczos.  U comes back
for RowMatrix and SparseRowMatrix only, as in the reference.

On a mesh every mode runs on the row shards: the Gram and the projections
all_reduce over the row group, TSQR gathers the shards' R factors, and
every small factorization runs on each rank alike, so s and V have the
same bits on every rank and U comes back as a RowMatrix sharded like A.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.distmat.blockmatrix import BlockMatrix
from repro_torch.core.distmat.coordinatematrix import CoordinateMatrix
from repro_torch.core.distmat.rowmatrix import IndexedRowMatrix, RowMatrix
from repro_torch.core.distmat.sparserow import SparseRowMatrix
from . import lanczos as _lanczos
from . import randsvd as _randsvd

# n at which an n×n float32 Gram stops being comfortable to hold and factor.
GRAM_THRESHOLD = 8192
# Past the Gram threshold, k at which Lanczos' sequential directions beat
# the (2 + 2q)-pass sketch.
RANDOMIZED_K_THRESHOLD = 128
_MODES = ("auto", "gram", "lanczos", "randomized")
_TYPES = (RowMatrix, SparseRowMatrix, IndexedRowMatrix, CoordinateMatrix,
          BlockMatrix)


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
    """Aᵀ for the wide-input route, or None for a type without one
    (BlockMatrix, IndexedRowMatrix), which keeps the direct Lanczos path."""
    if isinstance(A, (CoordinateMatrix, SparseRowMatrix)):
        return A.transpose()
    if isinstance(A, RowMatrix):
        return RowMatrix.create(A.to_local().T, device=A.device,
                                mesh=A.mesh, row_axes=A.row_axes)
    return None


def _swap_transposed(A, At, res: SVDResult, compute_u: bool,
                     rcond: float) -> SVDResult:
    """SVD(Aᵀ) = U'ΣV'ᵀ ⇒ A = V'ΣU'ᵀ: V of A is U' (or AᵀV'Σ⁻¹ by k matvecs
    when the transposed type returned no U'), U of A is V'."""
    s = res.s
    if res.U is not None:
        V = res.U.to_local()
    else:
        inv = torch.where(s > rcond * torch.max(s),
                          1.0 / torch.clamp(s, min=1e-30), 0.0)
        V = torch.stack([At.matvec(res.V[:, i]) * inv[i]
                         for i in range(res.V.shape[1])], dim=1)
    U = RowMatrix.create(res.V, device=A.device,
                         mesh=getattr(A, "mesh", None),
                         row_axes=getattr(A, "row_axes", None)) \
        if compute_u else None
    return SVDResult(U=U, s=s, V=V,
                     info=dict(res.info or {}, transposed=True))


def auto_mode(n: int, k: int, *, gram_threshold: int = GRAM_THRESHOLD,
              randomized_k_threshold: int = RANDOMIZED_K_THRESHOLD,
              kind: str = "row", m: int | None = None, nnz: int | None = None,
              oversampling: int = _randsvd.OVERSAMPLING,
              power_iters: int = _randsvd.POWER_ITERS) -> str:
    """mode="auto": the execution planner's choice,
    launch/planner.plan("svd", ...), for n columns and k asked triplets of
    a matrix of `kind` "row" (a RowMatrix), "sparse" or any other: every
    type but RowMatrix takes the matrix-free Lanczos iteration."""
    from repro_torch.launch import planner as _planner
    ctx = {"kind": kind, "gram_threshold": gram_threshold,
           "randomized_k_threshold": randomized_k_threshold,
           "oversampling": oversampling, "power_iters": power_iters}
    if nnz is not None:
        ctx["nnz"] = int(nnz)
    return _planner.plan("svd", {"m": m or n, "n": n, "k": k},
                         context=ctx).choice


def compute_svd(A, k: int, *, compute_u: bool = True,
                mode: str = "auto", gram_threshold: int = GRAM_THRESHOLD,
                randomized_k_threshold: int = RANDOMIZED_K_THRESHOLD,
                oversampling: int = _randsvd.OVERSAMPLING,
                power_iters: int = _randsvd.POWER_ITERS,
                rcond: float = 1e-9, seed: int = 0,
                **lanczos_kw) -> SVDResult:
    """Top-k singular triplets of one of the §2 matrix types.
    `lanczos_kw` (ncv, max_restarts, tol) go to the Lanczos mode."""
    if not isinstance(A, _TYPES):
        raise TypeError("compute_svd needs a RowMatrix, SparseRowMatrix, "
                        "IndexedRowMatrix, CoordinateMatrix or BlockMatrix, "
                        f"got {type(A).__name__}")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}; expected auto | gram | "
                         "lanczos | randomized")
    m, n = A.shape
    k = min(k, min(m, n))
    if m < n and (At := _transpose(A)) is not None:
        res = compute_svd(At, k, compute_u=True, mode=mode,
                          gram_threshold=gram_threshold,
                          randomized_k_threshold=randomized_k_threshold,
                          oversampling=oversampling, power_iters=power_iters,
                          rcond=rcond, seed=seed, **lanczos_kw)
        return _swap_transposed(A, At, res, compute_u, rcond)
    if mode == "auto":
        kind = ("sparse" if isinstance(A, SparseRowMatrix)
                else "row" if isinstance(A, RowMatrix) else "other")
        mode = auto_mode(n, k, gram_threshold=gram_threshold,
                         randomized_k_threshold=randomized_k_threshold,
                         kind=kind, m=m,
                         nnz=A.nnz if kind == "sparse" else None,
                         oversampling=oversampling, power_iters=power_iters)
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
    if not isinstance(A, (RowMatrix, SparseRowMatrix)):
        raise ValueError("mode='gram' needs a RowMatrix or SparseRowMatrix "
                         f"(a Gram primitive), got {type(A).__name__}")
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
    if compute_u and isinstance(A, (RowMatrix, SparseRowMatrix)):
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
