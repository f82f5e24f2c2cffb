"""The port's §2 matrix types against the reference's, on the CPU:
IndexedRowMatrix, CoordinateMatrix (products, transpose, conversions,
to_sparse_row_matrix), BlockMatrix (multiply, add, validate, both matvec
modes, the dim-mismatch error), the local SparseMatrixCSC and SparseVector,
RowMatrix.to_sparse_row_matrix, and compute_svd on each new type (a
narrow and a wide CoordinateMatrix, an IndexedRowMatrix, a BlockMatrix).
The cases mirror tests/test_distmat.py at its tolerances.  Lanczos draws
v0 from a torch.Generator, so singular values are compared within 1e-4
and subspaces by their principal angles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import distmat as jd
from repro.core.linalg import compute_svd as j_compute_svd
from repro_torch import api
from repro_torch.core import distmat as d
from repro_torch.core.linalg import compute_svd
from repro_torch.core.linalg.svd import auto_mode
from repro_torch.launch.planner import BS_CANDIDATES

RNG = np.random.default_rng(0)
LANCZOS = dict(tol=1e-7, max_restarts=100)


def rand(m, n, seed):
    return np.random.default_rng(seed).normal(size=(m, n)).astype(np.float32)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


# -- IndexedRowMatrix -----------------------------------------------------------

def test_indexed_row_matrix_matches_reference():
    idx = np.array([4, 0, 2], np.int64)
    A = rand(3, 5, 1)
    im = d.IndexedRowMatrix.create(idx, A, device="cpu")
    jim = jd.IndexedRowMatrix.create(jnp.asarray(idx), jnp.asarray(A))
    out = im.to_local().numpy()
    assert out.shape[0] == 5 and im.shape == jim.shape == (3, 5)
    _close(out, jim.to_local(), rtol=1e-6)
    _close(out[idx], A, rtol=1e-6)
    v, u = rand(5, 1, 2)[:, 0], rand(3, 1, 3)[:, 0]
    _close(im.matvec(torch.from_numpy(v)), np.asarray(
        jim.matvec(jnp.asarray(v)))[:3], rtol=1e-5)
    _close(im.rmatvec(torch.from_numpy(u)), jim.rmatvec(jnp.asarray(u)),
           rtol=1e-5, atol=1e-6)
    assert im.to_row_matrix() is im.inner and im.device.type == "cpu"
    with pytest.raises(ValueError, match="indices"):
        d.IndexedRowMatrix.create(idx[:2], A, device="cpu")


# -- CoordinateMatrix -----------------------------------------------------------

def _coo(m=15, n=9, nnz=40, seed=1):
    rng = np.random.default_rng(seed)
    ri = rng.integers(0, m, nnz)
    ci = rng.integers(0, n, nnz)
    va = rng.normal(size=nnz).astype(np.float32)
    D = np.zeros((m, n), np.float32)
    np.add.at(D, (ri, ci), va)
    cm = d.CoordinateMatrix.create(ri, ci, va, (m, n), device="cpu")
    jcm = jd.CoordinateMatrix.create(jnp.asarray(ri), jnp.asarray(ci),
                                     jnp.asarray(va), (m, n))
    return cm, jcm, D


def test_coordinate_products():
    cm, jcm, D = _coo()
    x = np.random.default_rng(2).normal(size=9).astype(np.float32)
    y = np.random.default_rng(3).normal(size=15).astype(np.float32)
    got = cm.matvec(torch.from_numpy(x))
    _close(got, jcm.matvec(jnp.asarray(x)), rtol=1e-4, atol=1e-5)
    _close(got, D @ x, rtol=1e-4, atol=1e-5)
    got = cm.rmatvec(torch.from_numpy(y))
    _close(got, jcm.rmatvec(jnp.asarray(y)), rtol=1e-4, atol=1e-5)
    _close(got, D.T @ y, rtol=1e-4, atol=1e-5)
    _close(cm.frobenius_norm(), jcm.frobenius_norm(), rtol=1e-5)
    assert cm.nnz == jcm.nnz == 40 and cm.shape == (15, 9)
    # normal_op is the DistMatrix default: Aᵀ(A v).
    _close(cm.normal_op()(torch.from_numpy(x)), D.T @ (D @ x), rtol=1e-4,
           atol=1e-4)


def test_coordinate_transpose_swaps_the_indices():
    cm, jcm, D = _coo()
    t, jt = cm.transpose(), jcm.transpose()
    assert t.shape == jt.shape == (9, 15)
    assert t.row_idx is cm.col_idx and t.values is cm.values
    assert t.by_row is cm.by_col and t.by_col is cm.by_row
    _close(t.to_local(), jt.to_local(), rtol=1e-6)
    _close(t.to_local(), D.T, rtol=1e-6)


def test_coordinate_products_sum_sorted_runs():
    """create sorts the entries by row and keeps a copy sorted by column;
    each output sums its run, empty rows and columns give 0, and a second
    call gives the same bits."""
    rng = np.random.default_rng(6)
    m, n, nnz = 30, 20, 200
    ri = rng.integers(0, m - 3, nnz)            # the last 3 rows empty
    ci = rng.integers(2, n, nnz)                # the first 2 columns empty
    va = rng.normal(size=nnz).astype(np.float32)
    D = np.zeros((m, n), np.float32)
    np.add.at(D, (ri, ci), va)
    cm = d.CoordinateMatrix.create(ri, ci, va, (m, n), device="cpu")
    jcm = jd.CoordinateMatrix.create(jnp.asarray(ri), jnp.asarray(ci),
                                     jnp.asarray(va), (m, n))
    assert bool((cm.row_idx.diff() >= 0).all())
    np.testing.assert_array_equal(cm.by_row.offsets.diff().numpy(),
                                  np.bincount(ri, minlength=m))
    np.testing.assert_array_equal(cm.by_col.offsets.diff().numpy(),
                                  np.bincount(ci, minlength=n))
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=m).astype(np.float32))
    for got, ref, want, in (
            (cm.matvec(x), jcm.matvec(jnp.asarray(x.numpy())), D @ x.numpy()),
            (cm.rmatvec(y), jcm.rmatvec(jnp.asarray(y.numpy())),
             D.T @ y.numpy())):
        _close(got, ref, rtol=1e-4, atol=1e-5)
        _close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(cm.matvec(x)[-3:], torch.zeros(3))
    assert torch.equal(cm.rmatvec(y)[:2], torch.zeros(2))
    assert torch.equal(cm.matvec(x), cm.matvec(x))
    assert torch.equal(cm.rmatvec(y), cm.rmatvec(y))
    _close(cm.to_local(), D, rtol=1e-6, atol=1e-7)


def test_coordinate_conversions():
    cm, jcm, D = _coo()
    _close(cm.to_local(), jcm.to_local(), rtol=1e-6)
    _close(cm.to_local(), D, rtol=1e-6)
    irm, jirm = cm.to_indexed_row_matrix(), jcm.to_indexed_row_matrix()
    assert isinstance(irm, d.IndexedRowMatrix)
    _close(irm.indices, np.asarray(jirm.indices)[: jirm.inner.n_rows])
    _close(irm.to_local().numpy()[:15], np.asarray(jirm.to_local())[:15],
           rtol=1e-5, atol=1e-6)
    bm, jbm = cm.to_block_matrix(4, 4), jcm.to_block_matrix(4, 4)
    assert isinstance(bm, d.BlockMatrix)
    _close(bm.to_local(), jbm.to_local(), rtol=1e-6)


@pytest.mark.parametrize("bs", [8, 16])
def test_coordinate_to_sparse_row_matrix(bs):
    cm, jcm, D = _coo(m=40, n=27, nnz=300, seed=4)
    srm, jsrm = cm.to_sparse_row_matrix(bs=bs), jcm.to_sparse_row_matrix(
        bs=bs)
    assert isinstance(srm, d.SparseRowMatrix) and srm.device.type == "cpu"
    np.testing.assert_array_equal(srm.cols.numpy(), np.asarray(jsrm.cols))
    _close(srm.data, jsrm.data, rtol=1e-6, atol=1e-7)
    assert srm.nnz == jsrm.nnz and srm.dims == jsrm.dims
    _close(srm.to_local(), D, rtol=1e-6, atol=1e-7)
    x = np.random.default_rng(5).normal(size=27).astype(np.float32)
    _close(srm.matvec(torch.from_numpy(x))[:40], D @ x, rtol=1e-4,
           atol=1e-5)
    # bs="auto" takes plan("bsr_bs")'s block size on the entries' ELL
    # widths (tests/test_torch_planner.py holds the decision itself).
    auto = cm.to_sparse_row_matrix()
    assert auto.bs in BS_CANDIDATES
    _close(auto.to_local(), D, rtol=1e-6, atol=1e-7)


def test_rowmatrix_to_sparse_row_matrix():
    a = rand(37, 20, 6)
    a[np.abs(a) < 1.0] = 0.0
    srm = d.RowMatrix.create(a, device="cpu").to_sparse_row_matrix(bs=8)
    jsrm = jd.RowMatrix.create(jnp.asarray(a)).to_sparse_row_matrix(bs=8)
    np.testing.assert_array_equal(srm.cols.numpy(), np.asarray(jsrm.cols))
    _close(srm.data, jsrm.data, rtol=0, atol=0)
    assert srm.nnz == jsrm.nnz
    auto = d.RowMatrix.create(a, device="cpu").to_sparse_row_matrix()
    assert auto.bs in BS_CANDIDATES
    _close(auto.to_local(), a, rtol=0, atol=0)


# -- BlockMatrix --------------------------------------------------------------

def test_block_multiply_add_validate():
    A, B = rand(14, 10, 7), rand(10, 6, 8)
    ba = d.BlockMatrix.create(A, device="cpu")
    bb = d.BlockMatrix.create(B, device="cpu")
    jba, jbb = jd.BlockMatrix.create(A), jd.BlockMatrix.create(B)
    ba.validate()
    prod = ba.multiply(bb)
    assert prod.shape == (14, 6) and prod.data.dtype == torch.float32
    _close(prod.to_local(), jba.multiply(jbb).to_local(), rtol=1e-3,
           atol=1e-4)
    _close(prod.to_local(), A @ B, rtol=1e-3, atol=1e-4)
    _close(ba.add(ba).to_local(), jba.add(jba).to_local(), rtol=1e-6)
    _close(ba.transpose().to_local(), jba.transpose().to_local(), rtol=0)
    _close(ba.frobenius_norm(), jba.frobenius_norm(), rtol=1e-5)
    with pytest.raises(ValueError, match="dim mismatch"):
        ba.add(bb)


def test_block_multiply_keeps_bf16():
    A, B = rand(20, 12, 9), rand(12, 7, 10)
    ba = d.BlockMatrix.create(torch.from_numpy(A).bfloat16(), device="cpu")
    bb = d.BlockMatrix.create(torch.from_numpy(B).bfloat16(), device="cpu")
    prod = ba.multiply(bb)
    assert prod.data.dtype == torch.bfloat16
    want = ba.data.float() @ bb.data.float()
    torch.testing.assert_close(prod.data, want.bfloat16(), rtol=0, atol=0)


def test_block_matvec_both_modes():
    A = rand(12, 8, 11)
    bm, jbm = d.BlockMatrix.create(A, device="cpu"), jd.BlockMatrix.create(A)
    v = RNG.normal(size=8).astype(np.float32)
    u = RNG.normal(size=12).astype(np.float32)
    got = bm.matvec(torch.from_numpy(v))
    _close(got, np.asarray(jbm.matvec(jnp.asarray(v)))[:12], rtol=1e-4)
    _close(got, A @ v, rtol=1e-4)
    w = jnp.asarray(np.pad(v, (0, jbm.data.shape[1] - 8)))
    _close(bm.matvec_model_sharded(torch.from_numpy(v)),
           np.asarray(jbm.matvec_model_sharded(w))[:12], rtol=1e-4)
    _close(bm.rmatvec(torch.from_numpy(u)),
           np.asarray(jbm.rmatvec(jnp.asarray(u)))[:8], rtol=1e-4, atol=1e-5)
    _close(bm.rmatvec_model_sharded(torch.from_numpy(u)),
           np.asarray(jbm.rmatvec_model_sharded(jnp.asarray(u)))[:8],
           rtol=1e-4, atol=1e-5)


def test_block_dim_mismatch_raises():
    for lib, kw in ((d, {"device": "cpu"}), (jd, {})):
        with pytest.raises(ValueError, match="inner dim mismatch"):
            lib.BlockMatrix.create(rand(4, 4, 1), **kw).multiply(
                lib.BlockMatrix.create(rand(5, 4, 2), **kw))


# -- local sparse types -------------------------------------------------------

def test_csc_roundtrip_and_ops():
    rng = np.random.default_rng(5)
    S = ((rng.random((9, 7)) < 0.4) * rng.normal(size=(9, 7))
         ).astype(np.float32)
    sp, jsp = d.SparseMatrixCSC.from_dense(S, device="cpu"), \
        jd.SparseMatrixCSC.from_dense(S)
    np.testing.assert_array_equal(sp.col_ptr.numpy(), np.asarray(jsp.col_ptr))
    np.testing.assert_array_equal(sp.row_idx.numpy(), np.asarray(jsp.row_idx))
    np.testing.assert_array_equal(sp.values.numpy(), np.asarray(jsp.values))
    assert sp.nnz == jsp.nnz
    _close(sp.to_dense(), jsp.to_dense(), rtol=1e-6)
    x = rng.normal(size=7).astype(np.float32)
    y = rng.normal(size=9).astype(np.float32)
    B = rng.normal(size=(7, 3)).astype(np.float32)
    C = rng.normal(size=(9, 2)).astype(np.float32)
    _close(sp.matvec(torch.from_numpy(x)), jsp.matvec(jnp.asarray(x)),
           rtol=1e-4, atol=1e-5)
    _close(sp.matvec(torch.from_numpy(y), transpose=True),
           jsp.matvec(jnp.asarray(y), transpose=True), rtol=1e-4, atol=1e-5)
    _close(sp.matmat(torch.from_numpy(B)), jsp.matmat(jnp.asarray(B)),
           rtol=1e-4, atol=1e-5)
    _close(sp.matmat(torch.from_numpy(C), transpose=True),
           jsp.matmat(jnp.asarray(C), transpose=True), rtol=1e-4, atol=1e-5)


def test_sparse_vector():
    v = np.array([1.0, 0.0, 3.0], np.float32)
    sv, jsv = d.SparseVector.from_dense(v, device="cpu"), \
        jd.SparseVector.from_dense(v)
    assert sv.size == jsv.size == 3
    assert list(sv.indices.numpy()) == list(np.asarray(jsv.indices)) == [0, 2]
    _close(sv.to_dense(), jsv.to_dense())
    other = np.array([2.0, 5.0, 1.0], np.float32)
    assert float(sv.dot(torch.from_numpy(other))) == pytest.approx(
        float(jsv.dot(jnp.asarray(other)))) == pytest.approx(5.0)


# -- compute_svd on the new types ------------------------------------------------

def _spectrum(m, n, seed):
    """A dense matrix with separated leading singular values."""
    a = rand(m, n, seed)
    return a * np.geomspace(4.0, 0.5, n, dtype=np.float32)[None, :]


def _coo_of(a):
    ri, ci = np.nonzero(a)
    return ri, ci, a[ri, ci]


def _same_subspace(got, want, k):
    cos = np.linalg.svd(np.asarray(got, np.float64)[:, :k].T
                        @ np.asarray(want, np.float64)[:, :k],
                        compute_uv=False)
    assert cos.min() >= 1 - 1e-4, cos


def _types(a):
    ri, ci, va = _coo_of(a)
    idx = np.arange(a.shape[0]) * 3
    return {
        "coordinate": (d.CoordinateMatrix.create(ri, ci, va, a.shape,
                                                 device="cpu"),
                       jd.CoordinateMatrix.create(jnp.asarray(ri),
                                                  jnp.asarray(ci),
                                                  jnp.asarray(va), a.shape)),
        "indexed": (d.IndexedRowMatrix.create(idx, a, device="cpu"),
                    jd.IndexedRowMatrix.create(jnp.asarray(idx),
                                               jnp.asarray(a))),
        "block": (d.BlockMatrix.create(a, device="cpu"),
                  jd.BlockMatrix.create(jnp.asarray(a))),
    }


@pytest.mark.parametrize("kind,shape", [
    ("coordinate", (70, 24)), ("coordinate", (24, 70)),
    ("indexed", (70, 24)), ("indexed", (24, 70)),
    ("block", (70, 24)), ("block", (24, 70))])
def test_compute_svd_on_the_new_types(kind, shape):
    a = _spectrum(*shape, seed=12)
    a[np.abs(a) < 0.3] = 0.0            # some sparsity for the COO form
    port, ref = _types(a)[kind]
    k = 4
    got = compute_svd(port, k, **LANCZOS)
    want = j_compute_svd(ref, k, **LANCZOS)
    s64 = np.linalg.svd(a.astype(np.float64), compute_uv=False)[:k]
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-4)
    np.testing.assert_allclose(got.s.numpy(), s64, rtol=1e-4)
    assert got.info["mode"] == want.info["mode"] == "lanczos"
    assert got.V.shape == (shape[1], k)
    _same_subspace(got.V.numpy(), want.V, k)
    wide_coo = kind == "coordinate" and shape[0] < shape[1]
    assert got.info.get("transposed", False) == wide_coo
    if wide_coo:
        # The transposed route: U from V' of Aᵀ, V by the generic
        # AᵀV'Σ⁻¹ recovery (k matvecs of the transposed type).
        assert want.info["transposed"]
        _same_subspace(got.U.to_local().numpy(), want.U.to_local(), k)
        u = got.U.to_local().numpy()
        np.testing.assert_allclose(
            a @ got.V.numpy(), u * got.s.numpy()[None, :], atol=2e-3)
    else:
        assert got.U is None and want.U is None


def test_auto_mode_sends_every_other_type_to_lanczos():
    assert auto_mode(8, 2) == "gram"
    for kind in ("sparse", "other"):
        assert auto_mode(8, 2, kind=kind) == "lanczos"
    port, _ = _types(_spectrum(40, 8, seed=13))["coordinate"]
    got = compute_svd(port, 2, **LANCZOS)
    assert got.info["mode"] == "lanczos"
    with pytest.raises(ValueError, match="mode='gram' needs"):
        compute_svd(port, 2, mode="gram")
    with pytest.raises(TypeError, match="compute_svd needs"):
        compute_svd(torch.zeros(4, 2), 1)


def test_api_compute_svd_on_a_coordinate_matrix():
    a = _spectrum(60, 20, seed=14)
    port, ref = _types(a)["coordinate"]
    U, s, V, info = api.compute_svd(port, 3, device="cpu", **LANCZOS)
    jU, js, jV, jinfo = japi.compute_svd(ref, 3, **LANCZOS)
    assert U is None and jU is None
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4)
    _same_subspace(V.numpy(), jV, 3)
    assert info["plan"] == jinfo["plan"] == "lanczos"
    assert info["degraded"] is None and info["precision"] == "f32"
