"""The port's Gram-mode SVD, PCA and TSQR against the reference, on the CPU.

Singular values agree to 1e-4 relative.  Singular vectors from ``eigh``
are defined up to sign, so each column is compared after aligning its
sign.  TSQR fixes R's diagonal to be non-negative on both sides, so Q and R
compare directly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core.linalg import svd as jsvd
from repro.core.linalg.tsqr import tsqr as jtsqr
from repro_torch import convert
from repro_torch.core.distmat import RowMatrix
from repro_torch.core.linalg import (GRAM_THRESHOLD, compute_pca,
                                     compute_svd, tsqr)


def _matrix(m, n, seed=0, decay=0.8):
    """Rows with a decaying spectrum, so the top singular values are
    separated and the vectors are well defined."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(m, min(m, n))))
    v, _ = np.linalg.qr(rng.normal(size=(n, min(m, n))))
    s = 10.0 * decay ** np.arange(min(m, n))
    return ((u * s) @ v.T).astype(np.float32)


def _pair(a, store=None):
    ref = JRowMatrix.create(jnp.asarray(a), store_dtype=store)
    port = convert.rowmatrix_from_numpy(np.asarray(ref.rows), ref.n_rows,
                                        device="cpu")
    return ref, port


def _aligned(got, want):
    """`got` with each column's sign matched to `want`'s."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return got * np.where(np.sum(got * want, axis=0) < 0, -1.0, 1.0)


@pytest.mark.parametrize("m,n,k", [(300, 40, 6), (257, 64, 10),
                                   (40, 90, 5)])
def test_gram_svd_matches_reference(m, n, k):
    ref, port = _pair(_matrix(m, n, seed=m))
    want = jsvd.compute_svd(ref, k, mode="gram")
    got = compute_svd(port, k, mode="gram")
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-4)
    np.testing.assert_allclose(_aligned(got.V, want.V), np.asarray(want.V),
                               atol=1e-3)
    U, jU = got.U.to_local(), np.asarray(want.U.to_local())
    assert U.shape == (m, k)
    np.testing.assert_allclose(_aligned(U, jU), jU, atol=1e-3)
    assert got.info["a_passes"] == want.info["a_passes"]
    assert got.info["plan"] == "gram"
    assert got.info.get("transposed", False) == (m < n)
    # U is orthonormal and reconstructs A.
    np.testing.assert_allclose(U.T @ U, np.eye(k), atol=1e-3)


def test_gram_svd_with_bf16_storage_matches_reference():
    ref, port = _pair(_matrix(200, 32, seed=5), store=jnp.bfloat16)
    assert port.rows.dtype == torch.bfloat16
    want = jsvd.compute_svd(ref, 4, mode="gram")
    got = compute_svd(port, 4, mode="gram")
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-4)
    assert got.U.rows.dtype == torch.bfloat16


def test_auto_mode_is_gram_up_to_the_threshold():
    ref, port = _pair(_matrix(120, 30, seed=6))
    got = compute_svd(port, 3)                          # mode="auto"
    assert got.info["mode"] == "gram" and GRAM_THRESHOLD == 8192
    want = jsvd.compute_svd(ref, 3)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-4)
    # Past the threshold the reference planner takes the randomized mode
    # for small k (tests/test_torch_randsvd.py) and Lanczos for large k.
    assert compute_svd(port, 3, gram_threshold=16).info["mode"] == \
        "randomized"
    lz = dict(tol=1e-7, max_restarts=100)
    assert compute_svd(port, 3, gram_threshold=16, randomized_k_threshold=2,
                       **lz).info["mode"] == "lanczos"
    got = compute_svd(port, 3, mode="lanczos", **lz)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-4)
    with pytest.raises(ValueError, match="unknown mode"):
        compute_svd(port, 3, mode="qr")


def test_compute_svd_without_u_and_method_entry_point():
    _, port = _pair(_matrix(100, 20, seed=7))
    res = port.compute_svd(4, compute_u=False)
    assert res.U is None and res.info["a_passes"] == 1
    assert res.s.shape == (4,) and res.V.shape == (20, 4)


def test_pca_matches_reference():
    a = _matrix(180, 24, seed=8) + 3.0
    ref, port = _pair(a)
    jV, jw = jsvd.compute_pca(ref, 5)
    V, w = port.compute_pca(5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-4)
    np.testing.assert_allclose(_aligned(V, jV), np.asarray(jV), atol=1e-3)
    V2, _ = compute_pca(port, 5)
    assert torch.equal(V, V2)


@pytest.mark.parametrize("m,n", [(240, 16), (97, 33)])
def test_tsqr_matches_reference(m, n):
    rng = np.random.default_rng(m + n)
    a = rng.normal(size=(m, n)).astype(np.float32)
    ref, port = _pair(a)
    jQ, jR = jtsqr(ref)
    Q, R = port.tall_skinny_qr()
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(Q.to_local().numpy(),
                               np.asarray(jQ.to_local()), atol=1e-4)
    q = Q.to_local().double()
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(n), atol=1e-4)
    np.testing.assert_allclose((q @ R.double()).numpy(), a, atol=1e-4)
    Q2, R2 = tsqr(port)
    assert torch.equal(R, R2)


def test_compute_svd_needs_a_rowmatrix():
    with pytest.raises(TypeError, match="RowMatrix"):
        compute_svd(torch.zeros(4, 2), 1)
    rm = RowMatrix.create(np.eye(6, 3, dtype=np.float32), device="cpu")
    assert compute_svd(rm, 10).s.shape == (3,)          # k capped at n
