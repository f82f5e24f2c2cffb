"""The port's sparse serving path against the reference's, on the CPU.

SparseRowMatrix.fused_grad_multi (the group pass of a SolverServer on a
sparse design matrix) is held against the reference's at small ragged
sizes, built from the same numpy arrays: every loss; f32, bf16 and int8
storage; k = 1, 3 and 8 slots; bs = 8 and 16; padding rows, and block-rows
whose padding slots share column 0 with a stored block.  The reference runs
its default CPU dispatch (fused_grad_bsr_multi_jnp; its Pallas interpret
path raises on this jax), the port its plain torch version
(``device="cpu"``), at tests/test_fusedgrad.py's tolerances: 1e-5 for f,
1e-4 for g and z.  Then one trace of gra, acc_rb and lbfgs requests goes
through both servers on the same sparse matrix, and the answers are compared
at convergence, where the float32 stopping tests of both packages have fired
(ROADMAP queue 3).
"""
import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.distmat import SparseRowMatrix as JSparseRowMatrix
from repro.core.tfocs.smooth import (SmoothHuber, SmoothLogLoss,
                                     SmoothPoisson, SmoothQuad)
from repro.kernels import fusedgrad as jfg
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro_torch import api, convert
from repro_torch.core.distmat import SparseRowMatrix
from repro_torch.core.tfocs import CountingLinop, LinopMatrix
from repro_torch.core.tfocs import smooth as psmooth
from repro_torch.kernels import fusedgrad, ops
from repro_torch.launch.serve import GroupRunner, SolverServer


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many tiny torch ops, which
    torch's thread pool slows by 50× when the machine's cores are shared
    (a parallel test run); restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrix(m, n, bs, density=0.35, seed=0):
    """Block-structured sparsity on a bs grid, cut to a ragged (m, n); every
    other block-row holds block column 0, so block-rows with fewer blocks
    than the widest carry padding slots at a column they also store."""
    rng = np.random.default_rng(seed)
    mb, nb = -(-m // bs), -(-n // bs)
    mask = rng.random((mb, nb)) < density
    mask[::2, 0] = True
    a = np.kron(mask, np.ones((bs, bs))) * rng.normal(size=(mb * bs, nb * bs))
    return a[:m, :n].astype(np.float32)


def _pair(a, bs, storage="f32"):
    ref = JSparseRowMatrix.from_dense(a, bs=bs)
    if storage != "f32":
        ref = ref.astype_store({"bf16": ml_dtypes.bfloat16,
                                "int8": "int8"}[storage])
    port = convert.sparserow_from_numpy(
        np.asarray(ref.data), np.asarray(ref.cols), ref.dims, ref.nnz,
        None if ref.scales is None else np.asarray(ref.scales), device="cpu")
    return ref, port


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _smooths(loss, B, W, reference=True):
    """k reference (unless not asked for) and k port smooths for the rows
    of B and W."""
    jkind = {"quad": lambda b, w: SmoothQuad(b=b, weights=w),
             "logistic": lambda b, w: SmoothLogLoss(y=b, weights=w),
             "huber": lambda b, w: SmoothHuber(b=b, delta=0.5, weights=w),
             "poisson": lambda b, w: SmoothPoisson(y=b, weights=w)}[loss]
    pkind = {"quad": lambda b, w: psmooth.SmoothQuad(b=b, weights=w),
             "logistic": lambda b, w: psmooth.SmoothLogLoss(y=b, weights=w),
             "huber": lambda b, w: psmooth.SmoothHuber(b=b, delta=0.5,
                                                       weights=w),
             "poisson": lambda b, w: psmooth.SmoothPoisson(y=b, weights=w)
             }[loss]
    js = [jkind(jnp.asarray(b), jnp.asarray(w)) for b, w in zip(B, W)] \
        if reference else None
    ps = [pkind(torch.from_numpy(b.copy()), torch.from_numpy(w.copy()))
          for b, w in zip(B, W)]
    return js, ps


def _multi_case(loss, storage, k, bs, seed):
    """The pair, X (k × n), targets and weights (k × m_pad; padding rows
    weighted 0) for a group pass; the first rows are the same for every
    k."""
    m, n = 83, 61
    ref, port = _pair(_matrix(m, n, bs, seed=seed), bs, storage)
    assert ((port.cols.numpy() == 0).sum(axis=1) > 1).any()  # shared column
    assert ref.m_pad > m                                      # padding rows
    rng = np.random.default_rng(seed)
    X = (0.2 * rng.normal(size=(8, n))).astype(np.float32)
    B = rng.normal(size=(8, ref.m_pad)).astype(np.float32)
    if loss == "logistic":
        B = np.sign(B)
    elif loss == "poisson":
        B = rng.poisson(1.0, (8, ref.m_pad)).astype(np.float32)
    W = rng.random((8, ref.m_pad)).astype(np.float32)
    W[:, m:] = 0.0
    return ref, port, X[:k], B[:k], W[:k]


@functools.lru_cache(maxsize=None)
def _reference_pass(loss, storage, bs):
    """The reference's kernels/ops.fused_grad_bsr_multi (its CPU dispatch,
    fused_grad_bsr_multi_jnp) on eight slots, as numpy (f, g, z).  Its
    slots are independent sums, so the first k rows are its answer for
    the first k slots; one call serves every k."""
    ref, _, X, B, W = _multi_case(loss, storage, 8, bs, bs)
    n = X.shape[1]
    xp = np.pad(X, ((0, 0), (0, ref.n_pad - n)))
    f, g, z = jops.fused_grad_bsr_multi(
        ref._local(ref.data, ref.cols, *ref._scale_ops()), jnp.asarray(xp),
        jnp.asarray(B), jnp.asarray(W), loss=loss, param=0.5)
    g = np.asarray(g)[:, :n]
    if storage == "bf16":
        # The reference's jnp form narrows the residual to bf16 for bf16
        # blocks; the port keeps it f32, as both kernels do.  Hold g to the
        # reference's dense form on the same (f32) values, which keeps it
        # f32 too.
        dense = np.zeros((ref.m_pad, n), np.float32)
        dense[:ref.dims[0]] = np.asarray(ref.to_local(), np.float32)
        g = np.asarray(jfg.fused_grad_multi_jnp(
            jnp.asarray(dense), jnp.asarray(X), jnp.asarray(B),
            jnp.asarray(W), loss=loss, param=0.5)[1])
    return np.asarray(f), g, np.asarray(z)


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
def test_fused_grad_multi_matches_the_reference(loss, storage, k, bs):
    """The port's group pass of k slots, both dispatches, against the
    reference's on the same stored blocks."""
    ref, port, X, B, W = _multi_case(loss, storage, k, bs, bs)
    f_want, g_want, z_want = _reference_pass(loss, storage, bs)
    n = X.shape[1]
    _, ps = _smooths(loss, B, W, reference=False)
    for dispatch in ("bsr", "dense"):
        f, g, z = port.fused_grad_multi(torch.from_numpy(X), ps,
                                        dispatch=dispatch)
        assert (f.shape, g.shape, z.shape) == ((k,), (k, n), (k, ref.m_pad))
        _close(f, f_want[:k], 1e-5)
        _close(g, g_want[:k], 1e-4)
        _close(z, z_want[:k], 1e-4)


def test_sparse_row_matrix_group_pass_matches_the_reference():
    """SparseRowMatrix.fused_grad_multi on both sides, smooths in, padding
    done by each package."""
    ref, port, X, B, W = _multi_case("poisson", "f32", 3, 8, 7)
    js, ps = _smooths("poisson", B, W)
    want = ref.fused_grad_multi(jnp.asarray(X), js, dispatch="bsr")
    got = port.fused_grad_multi(torch.from_numpy(X), ps)
    for u, v, tol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        _close(u, v, tol)


def test_group_rows_are_single_request_gradients():
    """Each slot of a group pass is that request's own fused_grad, and a
    zero-weight slot contributes exactly nothing."""
    _, port = _pair(_matrix(83, 61, 8, seed=3), 8)
    rng = np.random.default_rng(4)
    X = torch.from_numpy((0.2 * rng.normal(size=(3, 61))).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(3, port.m_pad)).astype(np.float32))
    W = port._row_mask().repeat(3, 1)
    W[2] = 0.0
    sms = [psmooth.SmoothHuber(b=B[i], delta=0.5, weights=W[i])
           for i in range(3)]
    f, g, z = port.fused_grad_multi(X, sms)
    for i in range(2):
        fi, gi, zi = port.fused_grad(X[i], sms[i])
        _close(f[i], fi, 1e-5)
        _close(g[i], gi, 1e-5)
        _close(z[i], zi, 1e-5)
    assert float(f[2]) == 0.0 and not bool(g[2].any())


def test_bsr_multi_dispatch_on_the_cpu():
    """CPU tensors take the plain version (no launch); the kernel wrapper
    refuses them; a bad loss is refused first."""
    _, port = _pair(_matrix(40, 24, 8, seed=5), 8)
    a = port._local()
    X, T = torch.ones(2, 24), torch.ones(2, port.m_pad)
    ops.reset_launch_counts()
    f, g, z = ops.fused_grad_bsr_multi(a, X, T, T, loss="quad")
    want = fusedgrad.fused_grad_bsr_multi_plain(a, X, T, T, loss="quad")
    for u, v in zip((f, g, z), want):
        assert torch.equal(u, v)
    assert ops.launch_counts()["fused_grad_bsr_multi"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        fusedgrad.fused_grad_bsr_multi(a, X, T, T, loss="quad")
    with pytest.raises(ValueError, match="loss"):
        ops.fused_grad_bsr_multi(a, X, T, T, loss="hinge")
    # Storage the kernel does not take is refused before any launch.
    q = port.astype_store("int8")._local()
    with pytest.raises(ValueError, match="CUDA tensors"):
        fusedgrad.fused_grad_bsr_multi(q, X, T, T, loss="quad")


def test_counting_linop_sees_one_pass_per_group_step():
    """A sparse group runs one fused_grad_multi per group pass and no other
    pass over A, whatever the method."""
    a = _matrix(163, 61, 8, density=0.6, seed=11)
    _, port = _pair(a, 8)
    rng = np.random.default_rng(12)
    bs = [(a @ rng.normal(size=61)).astype(np.float32) for _ in range(3)]
    L0 = float(np.linalg.norm(a, 2)) ** 2
    for method in ("gra", "acc_rb", "lbfgs"):
        lin = CountingLinop(LinopMatrix(port))
        runner = GroupRunner(lin, "quad", method=method, slots=3)
        for b in bs:
            runner.admit(api.SolveRequest(A=port, b=b, method=method, L0=L0,
                                          tol=0.0, max_iters=6,
                                          device="cpu"))
        while runner.busy():
            runner.step()
        assert lin.counts["fused_grad_multi"] == runner.a_passes > 0
        assert lin.total() == runner.a_passes


def _trace_problem(seed=21):
    a = _matrix(163, 61, 8, density=0.6, seed=seed)    # condition number ~4
    rng = np.random.default_rng(seed + 1)
    z = rng.normal(size=(4, 61)) @ a.T
    b_quad = (z[:3] + 0.01 * rng.normal(size=(3, 163))).astype(np.float32)
    b_log = np.where(z[3] > 0, 1.0, -1.0).astype(np.float32)
    return a, b_quad, b_log


def test_one_trace_served_by_both_servers():
    """gra, acc_rb and lbfgs groups on one SparseRowMatrix through the
    reference's server and the port's: every answer converges in both and
    agrees with the reference's within 1e-3, the tolerance of the sparse
    solves in tests/test_torch_sparserow.py (each package's float32
    stopping test fires at its own rounding floor)."""
    a, b_quad, b_log = _trace_problem()
    ref, port = _pair(a, 8)
    L0 = float(np.linalg.norm(a, 2)) ** 2
    plan = [("gra", "quad", b_quad[0], 1e-7),
            ("gra", "quad", b_quad[1], 1e-7),
            ("acc_rb", "quad", b_quad[2], 1e-8),
            ("acc_rb", "quad", b_quad[0], 1e-8),
            ("lbfgs", "logistic", b_log, 1e-6),
            ("lbfgs", "logistic", -b_log, 1e-6)]
    jsrv, tsrv = jserve.SolverServer(slots=2), SolverServer(slots=2)
    jids, tids = [], []
    for method, loss, b, tol in plan:
        kw = dict(method=method, loss=loss, tol=tol, max_iters=1000,
                  L0=L0 if loss == "quad" else L0 / 4)
        jids.append(jsrv.submit(japi.SolveRequest(A=ref, b=b, **kw)))
        tids.append(tsrv.submit(api.SolveRequest(A=port, b=b, device="cpu",
                                                 **kw)))
    jsrv.run()
    tsrv.run()
    for (method, _, _, _), jid, tid in zip(plan, jids, tids):
        j, t = jsrv.result(jid), tsrv.result(tid)
        assert t.info["plan"] == j.info["plan"] == "fused-group"
        assert t.info["converged"] and bool(j.info["converged"]), method
        _close(t.x, j.x, 1e-3)
    assert tsrv.stats["admitted"] == len(plan)


def test_sparse_group_matches_serial_and_direct_solves():
    """A slots=3 sparse group, the same requests one at a time, and the
    direct api.solve agree at convergence; a group's a_passes are the group
    passes while resident."""
    a, b_quad, _ = _trace_problem(seed=31)
    _, port = _pair(a, 8)
    L0 = float(np.linalg.norm(a, 2)) ** 2
    reqs = lambda: [api.SolveRequest(A=port, b=b, L0=L0, tol=1e-7,  # noqa
                                     max_iters=2000, device="cpu")
                    for b in b_quad]
    grouped, serial = SolverServer(slots=3), SolverServer(slots=1)
    gids = [grouped.submit(r) for r in reqs()]
    sids = [serial.submit(r) for r in reqs()]
    grouped.run()
    serial.run()
    assert grouped.stats["a_passes"] == max(
        grouped.result(i).info["a_passes"] for i in gids)
    for gid, sid, r in zip(gids, sids, reqs()):
        g, s = grouped.result(gid), serial.result(sid)
        d = api.solve(r)
        assert g.info["converged"] and s.info["converged"]
        assert float((g.x - s.x).abs().max()) < 1e-4
        assert float((g.x - d.x).abs().max()) < 1e-4


def test_forty_slot_sparse_group_matches_serial_solves():
    """One acc_rb group of 40 slots on a SparseRowMatrix (five 8-slot
    chunks of the fused kernel, past its former 32-slot cap), the same
    requests served one at a time, and api.solve agree request by request;
    the group's A-passes are the group passes while resident."""
    a, _, _ = _trace_problem(seed=41)
    _, port = _pair(a, 8)
    rng = np.random.default_rng(42)
    B = (rng.normal(size=(40, 61)) @ a.T
         + 0.01 * rng.normal(size=(40, 163))).astype(np.float32)
    L0 = float(np.linalg.norm(a, 2)) ** 2
    reqs = lambda: [api.SolveRequest(A=port, b=b, L0=L0, tol=1e-8,  # noqa
                                     method="acc_rb", max_iters=2000,
                                     device="cpu") for b in B]
    grouped, serial = SolverServer(slots=40), SolverServer(slots=1)
    gids = [grouped.submit(r) for r in reqs()]
    sids = [serial.submit(r) for r in reqs()]
    grouped.run()
    serial.run()
    assert grouped.stats["a_passes"] == max(
        grouped.result(i).info["a_passes"] for i in gids)
    for gid, sid, r in zip(gids, sids, reqs()):
        g, s = grouped.result(gid), serial.result(sid)
        d = api.solve(r)
        assert g.info["plan"] == "fused-group"
        assert g.info["converged"] and s.info["converged"]
        assert float((g.x - s.x).abs().max()) < 1e-4
        assert float((g.x - d.x).abs().max()) < 1e-4
