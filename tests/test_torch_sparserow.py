"""The port's SparseRowMatrix against the reference's, on the CPU.

Both are built from the same numpy arrays at bs = 8 (ragged m and n, so the
padding rows and columns are exercised); the reference runs its default
(jnp) dispatch with ``dispatch="bsr"``, the port its plain torch versions
(``device="cpu"``).  Solves are compared at convergence, where the float32
stopping tests of both packages have fired (ROADMAP queue 3).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.distmat import SparseRowMatrix as JSparseRowMatrix
from repro.kernels import ref as jref
from repro.core.tfocs.smooth import (SmoothHuber, SmoothLogLoss,
                                     SmoothPoisson, SmoothQuad)
from repro_torch import api, convert
from repro_torch.core.distmat import RowMatrix, SparseRowMatrix
from repro_torch.core.tfocs import smooth as psmooth
from repro_torch.core.tfocs.linop import CountingLinop, LinopMatrix

BS = 8


def _matrix(m, n, density=0.35, seed=0):
    """Block-structured sparsity on a bs grid, cut to a ragged (m, n)."""
    rng = np.random.default_rng(seed)
    mb, nb = -(-m // BS), -(-n // BS)
    mask = rng.random((mb, nb)) < density
    a = np.kron(mask, np.ones((BS, BS))) * rng.normal(size=(mb * BS, nb * BS))
    return a[:m, :n].astype(np.float32)


def _pair(a, **kw):
    ref = JSparseRowMatrix.from_dense(a, bs=BS, **kw)
    port = convert.sparserow_from_numpy(
        np.asarray(ref.data), np.asarray(ref.cols), ref.dims, ref.nnz,
        None if ref.scales is None else np.asarray(ref.scales), device="cpu")
    return ref, port


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("m,n", [(83, 61), (40, 40), (17, 90)])
def test_constructors_match_the_reference(m, n):
    a = _matrix(m, n, seed=m)
    ref = JSparseRowMatrix.from_dense(a, bs=BS)
    got = SparseRowMatrix.from_dense(a, BS, device="cpu")
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(ref.cols))
    assert got.dims == ref.dims and got.nnz == ref.nnz
    assert (got.n_pad, got.m_pad, got.bs, got.ell) == (ref.n_pad, ref.m_pad,
                                                      ref.bs, ref.ell)
    assert got.block_density() == pytest.approx(ref.block_density())
    np.testing.assert_array_equal(got.to_local().numpy(), a)
    # COO entries, shuffled, with a duplicate that adds up.
    r, c = np.nonzero(a)
    v = a[r, c]
    perm = np.random.default_rng(1).permutation(len(r))
    r, c, v = (np.concatenate([x[perm], x[:1]]) for x in (r, c, v))
    v[-1] = 0.5
    ref_e = JSparseRowMatrix.from_entries(r, c, v, (m, n), bs=BS)
    got_e = SparseRowMatrix.from_entries(r, c, v, (m, n), BS, device="cpu")
    np.testing.assert_array_equal(got_e.data.numpy(), np.asarray(ref_e.data))
    np.testing.assert_array_equal(got_e.cols.numpy(), np.asarray(ref_e.cols))
    assert got_e.nnz == ref_e.nnz
    _close(got_e.to_local(), ref_e.to_local(), rtol=0, atol=1e-6)


def test_products_match_the_reference():
    ref, port = _pair(_matrix(83, 61, seed=3))
    rng = np.random.default_rng(4)
    v = rng.normal(size=61).astype(np.float32)
    u = rng.normal(size=ref.m_pad).astype(np.float32)
    B = rng.normal(size=(61, 5)).astype(np.float32)
    want = {"matvec": ref.matvec(jnp.asarray(v), dispatch="bsr"),
            "rmatvec": ref.rmatvec(jnp.asarray(u), dispatch="bsr"),
            "multiply_local": ref.multiply_local(jnp.asarray(B),
                                                 dispatch="bsr").to_local(),
            "gram": ref.gram(dispatch="bsr")}
    for dispatch in ("bsr", "dense", "auto"):
        _close(port.matvec(torch.from_numpy(v), dispatch=dispatch),
               want["matvec"])
        _close(port.rmatvec(torch.from_numpy(u), dispatch=dispatch),
               want["rmatvec"])
        U = port.multiply_local(torch.from_numpy(B), dispatch=dispatch)
        assert isinstance(U, RowMatrix) and U.n_rows == 83
        _close(U.to_local(), want["multiply_local"])
        _close(port.gram(dispatch=dispatch), want["gram"], atol=1e-3)
    _close(port.normal_op()(torch.from_numpy(v)),
           ref.normal_op()(jnp.asarray(v)), atol=1e-3)
    with pytest.raises(ValueError, match="dispatch"):
        port.matvec(torch.from_numpy(v), dispatch="planner")


def _smooths(loss, b, w):
    jb, pb = jnp.asarray(b), torch.from_numpy(b.copy())
    jw, pw = jnp.asarray(w), torch.from_numpy(w.copy())
    if loss == "quad":
        return SmoothQuad(b=jb, weights=jw), psmooth.SmoothQuad(b=pb,
                                                               weights=pw)
    if loss == "logistic":
        return (SmoothLogLoss(y=jb, weights=jw),
                psmooth.SmoothLogLoss(y=pb, weights=pw))
    if loss == "huber":
        return (SmoothHuber(b=jb, delta=0.5, weights=jw),
                psmooth.SmoothHuber(b=pb, delta=0.5, weights=pw))
    return (SmoothPoisson(y=jb, weights=jw),
            psmooth.SmoothPoisson(y=pb, weights=pw))


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("loss", ["quad", "logistic", "huber", "poisson"])
def test_fused_grad_matches_the_reference(storage, loss):
    a = _matrix(83, 61, seed=7)
    ref, port = _pair(a)
    if storage != "f32":
        dt = {"bf16": ml_dtypes.bfloat16, "int8": "int8"}[storage]
        ref = ref.astype_store(dt)
        port = convert.sparserow_from_numpy(
            np.asarray(ref.data), np.asarray(ref.cols), ref.dims, ref.nnz,
            None if ref.scales is None else np.asarray(ref.scales),
            device="cpu")
    rng = np.random.default_rng(8)
    x = (0.2 * rng.normal(size=61)).astype(np.float32)
    b = rng.normal(size=ref.m_pad).astype(np.float32)
    if loss == "logistic":
        b = np.sign(b)
    elif loss == "poisson":
        b = rng.poisson(1.0, ref.m_pad).astype(np.float32)
    w = np.asarray(ref._row_mask(), np.float32)
    np.testing.assert_array_equal(port._row_mask().numpy(), w)
    js, ps = _smooths(loss, b, w)
    want = ref.fused_grad(jnp.asarray(x), js, dispatch="bsr", chunks=1)
    g_want = want[1]
    if storage == "bf16":
        # The reference's jnp form narrows the residual to bf16 for bf16
        # blocks; the port keeps it f32, as both kernels do.  Hold g to the
        # reference's densifying oracle, which keeps it f32 too.
        dense = np.zeros((ref.m_pad, 61), np.float32)
        dense[:83] = np.asarray(ref.to_local(), np.float32)
        g_want = jref.fused_grad_ref(jnp.asarray(dense), jnp.asarray(x),
                                     jnp.asarray(b), jnp.asarray(w),
                                     loss=loss, param=0.5)[1]
    for dispatch in ("bsr", "dense"):
        got = port.fused_grad(torch.from_numpy(x), ps, dispatch=dispatch)
        _close(got[0], want[0], rtol=1e-5, atol=1e-4)
        _close(got[1], g_want)
        _close(got[2], want[2])
        assert got[1].shape == (61,) and got[2].shape == (ref.m_pad,)


def test_storage_and_statistics_match_the_reference():
    a = _matrix(83, 61, seed=9)
    ref, port = _pair(a)
    assert port.out_dtype == torch.float32
    q_ref, q = ref.astype_store("int8"), port.astype_store("int8")
    assert q.data.dtype == torch.int8 and q.out_dtype == torch.float32
    assert np.abs(q.data.numpy().astype(int)
                  - np.asarray(q_ref.data).astype(int)).max() <= 1
    _close(q.scales, q_ref.scales, rtol=1e-7, atol=0)
    assert q.astype_store(torch.int8) is q
    _close(q.dequantize().to_local(), q_ref.dequantize().to_local())
    bf = port.astype_store(torch.bfloat16)
    assert bf.data.dtype == torch.bfloat16 and bf.out_dtype == torch.float32
    assert bf.astype_store(torch.float32).data.dtype == torch.float32
    assert port.astype_store(torch.float32) is port
    _close(port.frobenius_norm(), ref.frobenius_norm(), rtol=1e-6)
    _close(port.column_norms(), ref.column_norms(), rtol=1e-5)
    _close(q.column_norms(), q_ref.column_norms(), rtol=1e-5)
    d = np.linspace(0.5, 2.0, 61).astype(np.float32)
    _close(port.scale_columns(torch.from_numpy(d)).to_local(),
           ref.scale_columns(jnp.asarray(d)).to_local(), rtol=1e-6)
    rm = port.to_row_matrix()
    assert isinstance(rm, RowMatrix) and rm.shape == (83, 61)
    _close(rm.to_local(), ref.to_row_matrix().to_local(), rtol=0, atol=0)
    t = port.transpose()
    assert t.shape == (61, 83) and t.bs == BS
    np.testing.assert_array_equal(t.data.numpy(),
                                  np.asarray(ref.transpose().data))


def test_what_waits_for_later_slices_raises():
    _, port = _pair(_matrix(40, 24, seed=2))
    x = torch.zeros(24)
    sm = psmooth.SmoothQuad(b=torch.zeros(port.m_pad))
    # bs="auto" and quantize="auto" ask the planner
    # (tests/test_torch_planner.py): a tiny identity stays exact.
    eye = SparseRowMatrix.from_dense(np.eye(16, dtype=np.float32), "auto",
                                     device="cpu")
    assert eye.bs in (8, 16, 32, 64, 128)
    assert torch.equal(eye.to_local(), torch.eye(16))
    assert SparseRowMatrix.from_dense(np.eye(16, dtype=np.float32), 8,
                                      device="cpu",
                                      quantize="auto").scales is None
    with pytest.raises(ValueError, match="bs must be"):
        SparseRowMatrix.from_dense(np.eye(16, dtype=np.float32), 4,
                                   device="cpu")
    # The group pass and DIMSUM are ported (tests/test_torch_sparse_serve.py
    # and tests/test_torch_dimsum.py hold them against the reference).
    f, g, z = port.fused_grad_multi(x[None], [sm])
    assert (f.shape, g.shape, z.shape) == ((1,), (1, 24), (1, port.m_pad))
    assert port.column_similarities(0.5).shape == (24, 24)
    # Since the cluster path landed (tests/test_torch_cluster.py holds
    # them on 4 ranks): remesh onto one device keeps every block, the
    # psum8 residual is the strip's (1, n_pad) row and obeys the error-
    # feedback identity, and chunks > 1 matches eager within tolerance.
    same = port.remesh(None)
    assert torch.equal(same.data, port.data)
    assert torch.equal(same.cols, port.cols)
    res0 = port.init_psum_residual()
    assert res0.shape == (1, port.n_pad) and not res0.any()
    f, g, _ = port.fused_grad(x, sm)
    f8, g8, _, res1 = port.fused_grad(x, sm, residual=res0)
    assert torch.equal(f8, f)
    np.testing.assert_allclose((g8 + res1[0, :24]).numpy(), g.numpy(),
                               rtol=1e-5, atol=1e-5)
    fc, gc, _ = port.fused_grad(x, sm, chunks=2)
    assert torch.equal(fc, f)
    np.testing.assert_allclose(gc.numpy(), g.numpy(), rtol=1e-5, atol=1e-5)


def test_sparse_rows_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseRowMatrix.from_dense(np.eye(16, dtype=np.float32), 8)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("loss,method", [("quad", "gra"),
                                         ("quad", "acc_rb"),
                                         ("logistic", "gra")])
def test_api_solve_matches_the_reference(fused, loss, method):
    """At convergence: x within 1e-3 of the reference's at the same fused=
    setting, A-passes and plan as the engine counts them."""
    a = _matrix(163, 61, density=0.6, seed=11)      # condition number ~4
    ref, port = _pair(a)
    rng = np.random.default_rng(12)
    z = a @ rng.normal(size=61).astype(np.float32)
    b = (z + 0.1 * rng.normal(size=163)).astype(np.float32) \
        if loss == "quad" else np.where(z > 0, 1.0, -1.0).astype(np.float32)
    # L0 = the smooth's Lipschitz constant: ||A||² (quad), ||A||²/4
    # (logistic, with an l2 term that makes it strongly convex).
    L0 = float(np.linalg.norm(a, 2)) ** 2 / (1 if loss == "quad" else 4)
    kw = dict(loss=loss, method=method, L0=L0, tol=1e-6, max_iters=1000,
              reg="l2" if loss == "logistic" else "none",
              lam=1.0 if loss == "logistic" else 0.0)
    want = japi.solve(japi.SolveRequest(A=ref, b=jnp.asarray(b), **kw),
                      fused=fused)
    got = api.solve(api.SolveRequest(A=port, b=torch.from_numpy(b),
                                     device="cpu", **kw), fused=fused)
    assert got.info["plan"] == want.info["plan"]
    assert got.info["converged"] and bool(want.info["converged"])
    _close(got.x, want.x, rtol=1e-3, atol=1e-3)
    # Run-time A-pass counts equal the operator's calls.
    linop = CountingLinop(LinopMatrix(port))
    assert linop.out_shape == (ref.m_pad,)
    assert LinopMatrix(port).operand_dtype() == torch.float32


def test_counting_linop_counts_sparse_passes():
    a = _matrix(40, 24, seed=13)
    _, port = _pair(a)
    b = torch.from_numpy(np.random.default_rng(14).normal(size=40)
                         .astype(np.float32))
    from repro_torch.core.optim.first_order import minimize_first_order
    from repro_torch.core.tfocs.prox import ProxZero
    from repro_torch.core.tfocs.solver import TfocsOptions
    for fused in (True, False):
        lin = CountingLinop(LinopMatrix(port))
        sm = psmooth.SmoothQuad(b=lin.pad_data(b), weights=lin.row_weights())
        _, info = minimize_first_order(
            "gra", sm, lin, ProxZero(),
            opts=TfocsOptions(max_iters=20, L0=50.0, fused=fused))
        assert lin.total() == info["a_passes"]
        assert (lin.counts["fused_grad"] > 0) == fused


def test_convert_carries_int8_and_bf16_across():
    a = _matrix(40, 24, seed=15)
    ref = JSparseRowMatrix.from_dense(a, bs=BS, quantize="int8")
    port = convert.sparserow_from_numpy(
        np.asarray(ref.data), np.asarray(ref.cols), ref.dims, ref.nnz,
        np.asarray(ref.scales), device="cpu")
    assert port.data.dtype == torch.int8 and port.scales is not None
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    bf = JSparseRowMatrix.from_dense(a, bs=BS).astype_store(
        ml_dtypes.bfloat16)
    pbf = convert.sparserow_from_numpy(np.asarray(bf.data),
                                       np.asarray(bf.cols), bf.dims, bf.nnz,
                                       device="cpu")
    assert pbf.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(pbf.data.float().numpy(),
                                  np.asarray(bf.data, np.float32))


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_gram_builds_one_column_strip_at_a_time(storage):
    """The sparse Gram densifies one 512-column strip at a time: each strip
    holds exactly the columns of the densified matrix, and the Gram (both
    dispatches) matches the float64 Gram of the stored values; in f32 the
    Gram and the Gram-mode SVD also match the reference's."""
    a = _matrix(90, 530, density=0.3, seed=21)       # two strips, ragged
    ref, port = _pair(a)
    if storage != "f32":
        port = port.astype_store(
            {"bf16": torch.bfloat16, "int8": torch.int8}[storage])
    dense = port._dense().float()
    for c0 in range(0, port.n_pad, 512):
        c1 = min(c0 + 512, port.n_pad)
        assert torch.equal(port._dense_columns(c0, c1), dense[:, c0:c1])
    d64 = port.to_local().double()
    want = (d64.T @ d64).numpy()
    scale = np.abs(want).max()
    for dispatch in ("bsr", "dense"):
        got = port.gram(dispatch=dispatch)
        assert got.shape == (530, 530) and got.dtype == torch.float32
        _close(got.double() / scale, want / scale, rtol=0, atol=1e-6)
    if storage == "f32":
        _close(port.gram().double() / scale,
               np.asarray(ref.gram(dispatch="bsr"), np.float64) / scale,
               rtol=0, atol=1e-6)
        jres = ref.compute_svd(4, mode="gram")
        res = port.compute_svd(4, mode="gram")
        assert res.info["mode"] == "gram"
        _close(res.s, jres.s, rtol=1e-5, atol=0)
