"""The port's Lanczos SVD against numpy and the reference, on the CPU.

The port draws v0 from a torch.Generator, the reference from a JAX key, so
the iterates differ: singular values are compared (1e-4 relative) and
singular vectors as subspaces (after aligning signs), never iterate for
iterate.  Structural counts (op_calls, a_passes, the info keys) follow the
reference's formulas.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core.distmat import SparseRowMatrix as JSparseRowMatrix
from repro.core.linalg import compute_svd as j_compute_svd
from repro.core.linalg import lanczos as jlanczos
from repro_torch import api, convert
from repro_torch.core.distmat import RowMatrix, SparseRowMatrix
from repro_torch.core.linalg import compute_svd, lanczos_eigsh

LANCZOS = dict(tol=1e-7, max_restarts=300)


def block_sparse(m, n, bs, density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((m // bs, n // bs)) < density
    return (np.kron(mask, np.ones((bs, bs)))
            * rng.normal(size=(m, n))).astype(np.float32)


def _sparse_pair(a, bs=8):
    ref = JSparseRowMatrix.from_dense(a, bs=bs)
    port = convert.sparserow_from_numpy(np.asarray(ref.data),
                                        np.asarray(ref.cols), ref.dims,
                                        ref.nnz, device="cpu")
    return ref, port


def _aligned(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return got * np.where(np.sum(got * want, axis=0) < 0, -1.0, 1.0)


@pytest.mark.parametrize("n,k", [(60, 4), (120, 10)])
def test_lanczos_eigsh_matches_numpy(n, k):
    rng = np.random.default_rng(n)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = 10.0 * 0.85 ** np.arange(n)
    M = ((q * w) @ q.T).astype(np.float32)
    Mt = torch.from_numpy(M)
    vals, vecs, info = lanczos_eigsh(lambda v: Mt @ v, n, k, tol=1e-7,
                                     max_restarts=200)
    np.testing.assert_allclose(vals.numpy(), w[:k], rtol=1e-4)
    np.testing.assert_allclose(_aligned(vecs, q[:, :k]), q[:, :k], atol=1e-3)
    ncv = min(n, max(2 * k + 1, 20))
    assert info["ncv"] == ncv and info["converged"]
    assert info["op_calls"] == ncv + max(info["restarts"] - 1, 0) * (ncv - k)
    jvals, _, jinfo = jlanczos.lanczos_eigsh(lambda v: jnp.asarray(M) @ v,
                                             n, k, tol=1e-7, max_restarts=200)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-4)
    assert set(info) == set(jinfo)
    with pytest.raises(ValueError, match="ncv"):
        lanczos_eigsh(lambda v: Mt @ v, n, k, ncv=k)


def test_sparse_svd_takes_lanczos_and_matches_numpy():
    """tests/test_sparserow.py::TestSparseSVD's bar: σ within 1e-4 of the
    dense SVD's, and U Σ Vᵀ the rank-4 truncation."""
    dense = block_sparse(80, 64, 8, 0.3, seed=11)
    ref, srm = _sparse_pair(dense)
    res = compute_svd(srm, 4, **LANCZOS)
    assert res.info["mode"] == "lanczos" and res.info["plan"] == "lanczos"
    u, s, vt = np.linalg.svd(dense, full_matrices=False)
    np.testing.assert_allclose(res.s.numpy(), s[:4], rtol=1e-4)
    want = j_compute_svd(ref, 4, **LANCZOS)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(want.s), rtol=1e-4)
    U = res.U.to_local().numpy()
    assert isinstance(res.U, RowMatrix) and U.shape == (80, 4)
    recon = U @ np.diag(res.s.numpy()) @ res.V.numpy().T
    np.testing.assert_allclose(recon, u[:, :4] @ np.diag(s[:4]) @ vt[:4],
                               atol=5e-3)
    info = res.info
    assert info["a_passes"] == 2 * info["op_calls"] + 1
    assert info["iterations"] == info["restarts"]
    assert set(want.info) <= set(info)


def test_mode_lanczos_on_a_dense_rowmatrix():
    rng = np.random.default_rng(3)
    u, _ = np.linalg.qr(rng.normal(size=(200, 40)))
    v, _ = np.linalg.qr(rng.normal(size=(40, 40)))
    a = ((u * (10.0 * 0.8 ** np.arange(40))) @ v.T).astype(np.float32)
    got = compute_svd(RowMatrix.create(a, device="cpu"), 5, mode="lanczos",
                      **LANCZOS)
    want = j_compute_svd(JRowMatrix.create(jnp.asarray(a)), 5,
                         mode="lanczos", **LANCZOS)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-4)
    np.testing.assert_allclose(_aligned(got.V, want.V), np.asarray(want.V),
                               atol=1e-3)
    assert got.info["a_passes"] == 2 * got.info["op_calls"] + 1
    no_u = compute_svd(RowMatrix.create(a, device="cpu"), 5, mode="lanczos",
                       compute_u=False, **LANCZOS)
    assert no_u.U is None
    assert no_u.info["a_passes"] == 2 * no_u.info["op_calls"]


def test_wide_sparse_goes_through_the_transpose():
    dense = block_sparse(48, 96, 8, 0.4, seed=5)
    ref, srm = _sparse_pair(dense)
    res = compute_svd(srm, 3, **LANCZOS)
    assert res.info["transposed"] and res.info["mode"] == "lanczos"
    s = np.linalg.svd(dense, compute_uv=False)[:3]
    np.testing.assert_allclose(res.s.numpy(), s, rtol=1e-4)
    want = j_compute_svd(ref, 3, **LANCZOS)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(want.s), rtol=1e-4)
    assert res.U.to_local().shape == (48, 3) and res.V.shape == (96, 3)
    recon = res.U.to_local().numpy() @ np.diag(res.s.numpy()) @ res.V.numpy().T
    u, sv, vt = np.linalg.svd(dense, full_matrices=False)
    np.testing.assert_allclose(recon, u[:, :3] @ np.diag(sv[:3]) @ vt[:3],
                               atol=5e-3)


def test_sparse_gram_mode_and_randomized_refusal():
    dense = block_sparse(80, 64, 8, 0.3, seed=12)
    _, srm = _sparse_pair(dense)
    res = compute_svd(srm, 4, mode="gram")
    s = np.linalg.svd(dense, compute_uv=False)[:4]
    np.testing.assert_allclose(res.s.numpy(), s, rtol=1e-3)
    assert res.info["a_passes"] == 2
    with pytest.raises(ValueError, match="needs a RowMatrix"):
        compute_svd(srm, 4, mode="randomized")


def test_svd_request_on_a_sparse_matrix():
    dense = block_sparse(80, 64, 8, 0.3, seed=13)
    srm = SparseRowMatrix.from_dense(dense, 8, device="cpu")
    res = api.svd(api.SvdRequest(A=srm, k=4, device="cpu",
                                 options=dict(LANCZOS)))
    U, s, V = res.factors
    assert res.info["plan"] == "lanczos" and res.info["converged"]
    assert res.info["degraded"] is None
    np.testing.assert_allclose(s.numpy(),
                               np.linalg.svd(dense, compute_uv=False)[:4],
                               rtol=1e-4)
    assert U.shape == (80, 4) and V.shape == (64, 4)
