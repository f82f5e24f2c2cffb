"""Low-precision storage in the port: the single-device cases of
tests/test_precision.py, port against reference on the same numpy inputs.

  * store_dtype float32 is the default path bit for bit; astype_store
    round trips; the bf16 Gram is close to AᵀA; the int8 sparse matvec is
    within its quantization bound;
  * the Figure-1 family (method × precision), port against reference,
    both in bf16, at the reference's bound (100 × tol); the explicit
    "psum8" falls back to f32 where the reference's does, and raises on a
    RowMatrix's θ ≡ 1 fused engine (its compressed all-reduce waits for
    multi-GPU); "auto" resolves and reports; the int8 BlockELL operand
    through the fused solver;
  * SparseRowMatrix.from_dense's "auto" against the reference's choice
    where the choice is a byte ratio on both sides, and the budgeted
    server's cases of tests/test_serve.py, one trace through both
    servers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core.distmat import SparseRowMatrix as JSparseRowMatrix
from repro.launch import planner as jplanner
from repro.launch.serve import SolverServer as JSolverServer
from repro_torch import api
from repro_torch.core.distmat import RowMatrix, SparseRowMatrix
from repro_torch.kernels import autotune as at
from repro_torch.launch import planner
from repro_torch.launch.serve import SolverServer


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    at.reset()
    yield
    at.reset()
    torch.set_num_threads(threads)


def _problem(m=192, n=24, seed=0, noise=0.01):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    x = rng.normal(size=(n,)).astype(np.float32)
    b = (A @ x + noise * rng.normal(size=m)).astype(np.float32)
    return A, b


def _block_sparse(m=256, n=128, bs=32, density=0.3, seed=1):
    rng = np.random.default_rng(seed)
    mask = rng.random((m // bs, n // bs)) < density
    return (np.kron(mask, np.ones((bs, bs)))
            * rng.normal(size=(m, n))).astype(np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


class TestF32BitCompat:
    def test_store_f32_is_identity(self):
        A, _ = _problem()
        base = RowMatrix.create(A, device="cpu")
        kept = RowMatrix.create(A, device="cpu", store_dtype=torch.float32)
        assert kept.rows.dtype == torch.float32
        assert torch.equal(base.gram(), kept.gram())
        v = torch.linspace(-1, 1, A.shape[1])
        assert torch.equal(base.matvec(v), kept.matvec(v))
        assert base.astype_store(torch.float32) is base

    def test_astype_store_round_trip_shape(self):
        A, _ = _problem()
        rm = RowMatrix.create(A, device="cpu")
        lo = rm.astype_store(torch.bfloat16)
        assert lo.rows.dtype == torch.bfloat16
        assert lo.out_dtype == torch.float32            # compute stays f32
        assert rm.rows.dtype == torch.float32           # a copy, not a cast
        back = lo.astype_store(torch.float32)
        assert back.rows.dtype == torch.float32 and back.shape == rm.shape
        ref = JRowMatrix.create(jnp.asarray(A)).astype_store(jnp.bfloat16)
        np.testing.assert_array_equal(
            lo.rows.float().numpy(), np.asarray(ref.rows.astype(jnp.float32)))

    def test_fp8_storage_waits_for_its_item(self):
        """Both fp8 types the reference casts to are storage types now
        (tests/test_torch_fp8.py, tests/test_torch_e5m2.py): e4m3 and
        e5m2 through create and astype_store; a type the reference's
        kernels do not take (float16) still raises TypeError."""
        A, _ = _problem()
        for dt in (torch.float8_e4m3fn, torch.float8_e5m2):
            made = RowMatrix.create(A, device="cpu", store_dtype=dt)
            assert made.rows.dtype == dt and made.out_dtype == torch.float32
            cast = RowMatrix.create(A, device="cpu").astype_store(dt)
            assert torch.equal(cast.rows.view(torch.uint8),
                               made.rows.view(torch.uint8))
        with pytest.raises(TypeError, match="float8_e5m2"):
            RowMatrix.create(A, device="cpu", store_dtype=torch.float16)

    def test_unquantized_sparse_unchanged(self):
        dense = _block_sparse()
        srm = SparseRowMatrix.from_dense(dense, bs=32, device="cpu")
        none = SparseRowMatrix.from_dense(dense, bs=32, device="cpu",
                                          quantize="none")
        assert torch.equal(srm.gram(), none.gram())


class TestStorageParity:
    def test_bf16_gram_close(self):
        A, _ = _problem(512, 32, seed=2)
        rm = RowMatrix.create(A, device="cpu", store_dtype=torch.bfloat16)
        g = rm.gram()
        assert g.dtype == torch.float32
        ref = A.T @ A
        rel = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert rel < 2e-2, rel
        jg = np.asarray(JRowMatrix.create(
            jnp.asarray(A), store_dtype=jnp.bfloat16).gram())
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5, atol=1e-4)

    def test_int8_sparse_matvec_bounded(self):
        dense = _block_sparse()
        srm = SparseRowMatrix.from_dense(dense, bs=32, device="cpu",
                                         quantize="int8")
        assert srm.scales is not None
        v = np.random.default_rng(3).normal(size=dense.shape[1]) \
            .astype(np.float32)
        got = srm.matvec(torch.from_numpy(v)).numpy()[:dense.shape[0]]
        ref = dense @ v
        bound = (np.abs(dense).max() / 127.0) * np.abs(v).sum()
        assert np.abs(got - ref).max() <= bound
        assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-2
        jsrm = JSparseRowMatrix.from_dense(dense, bs=32, quantize="int8")
        np.testing.assert_allclose(
            got, np.asarray(jsrm.matvec(jnp.asarray(v)))[:dense.shape[0]],
            rtol=1e-5, atol=1e-5)


# The Figure-1 family under forced low precision, port against reference.
# bf16 runs on both sides; the engines that never take the compressed
# wire report "f32" for "psum8" on both sides; gra's θ ≡ 1 engine takes it
# on both sides (the int8 wire with error feedback, one shard here;
# tests/test_torch_compression.py holds four).
FAMILY = [
    ("gra", "bf16", "bf16"),
    ("gra", "psum8", "psum8"),
    ("acc_b", "bf16", "bf16"),
    ("acc_b", "psum8", "f32"),
    ("acc_rb", "bf16", "bf16"),
    ("acc_rb", "psum8", "f32"),
    ("lbfgs", "bf16", "bf16"),
    ("lbfgs", "psum8", "f32"),
]


class TestSolverParity:
    @pytest.mark.parametrize("method,precision,expect", FAMILY)
    def test_family_parity(self, method, precision, expect):
        A, b = _problem(seed=5)
        L = float(np.linalg.norm(A, 2) ** 2)
        tol = 1e-5
        kw = dict(loss="quad", tol=tol, max_iters=600, L0=L)
        M = RowMatrix.create(A, device="cpu")
        ref = api.solve(api.SolveRequest(A=M, b=b, method=method,
                                         device="cpu", **kw))
        assert ref.info["precision"] == "f32"
        req = api.SolveRequest(A=M, b=b, method=method, precision=precision,
                               device="cpu", **kw)
        if expect == "raises":
            with pytest.raises(NotImplementedError, match="multi-GPU"):
                api.solve(req)
            return
        low = api.solve(req)
        assert low.info["precision"] == expect, low.info
        assert M.rows.dtype == torch.float32     # the caller's A stays
        # the guard scale: bf16 admitted at tol >= 1e-5
        assert _rel(low.x, ref.x) < 100 * tol, (method, precision)
        # ... and the reference's run of the same request, both bf16.
        jM = JRowMatrix.create(jnp.asarray(A))
        jlow = japi.solve(japi.SolveRequest(A=jM, b=b, method=method,
                                            precision=precision, **kw))
        assert _rel(low.x, jlow.x) < 100 * tol, (method, precision)
        if expect in ("bf16", "psum8"):
            assert jlow.info["precision"] == expect

    def test_auto_resolves_and_reports(self):
        A, b = _problem(seed=6)
        M = RowMatrix.create(A, device="cpu")
        L = float(np.linalg.norm(A, 2) ** 2)
        r = api.solve(api.SolveRequest(A=M, b=b, method="gra", tol=1e-9,
                                       max_iters=50, L0=L, device="cpu"))
        assert r.info["precision"] == "f32"
        # Loose, but the operand is under the savings floor: f32.
        r = api.solve(api.SolveRequest(A=M, b=b, method="gra", tol=1e-3,
                                       max_iters=50, L0=L, device="cpu"))
        assert r.info["precision"] == "f32"

    def test_auto_picks_bf16_where_it_pays(self):
        """2048 x 2048 f32 (16.8 MB, 5 µs a pass on the H100 model): bf16
        saves half the bytes, over the 2 µs floor, so "auto" at a tol over
        bf16's guard runs it and reports it; the reference's sweep (on its
        own reference model) picks bf16 too."""
        A, b = _problem(2048, 2048, seed=7)
        L = float(np.linalg.norm(A, 2) ** 2)
        kw = dict(loss="quad", method="gra", tol=1e-4, max_iters=4, L0=L)
        r = api.solve(api.SolveRequest(A=RowMatrix.create(A, device="cpu"),
                                       b=b, device="cpu", **kw))
        assert r.info["precision"] == "bf16"
        j = japi.solve(japi.SolveRequest(A=JRowMatrix.create(jnp.asarray(A)),
                                         b=b, **kw))
        assert j.info["precision"] == "bf16"
        assert _rel(r.x, j.x) < 1e-2

    def test_local_psum8_falls_back(self):
        """A local operand has no wire to compress (as in the reference)."""
        A, b = _problem(seed=7)
        kw = dict(A=A, b=b, method="gra", tol=1e-5, max_iters=50,
                  L0=float(np.linalg.norm(A, 2) ** 2), precision="psum8")
        r = api.solve(api.SolveRequest(device="cpu", **kw))
        assert r.info["precision"] == "f32"
        assert japi.solve(japi.SolveRequest(**kw)).info["precision"] == "f32"

    def test_bsr_solver_parity_int8(self):
        dense = _block_sparse(m=256, n=64, bs=32, density=0.4, seed=8)
        rng = np.random.default_rng(9)
        xs = rng.normal(size=64).astype(np.float32)
        b = (dense @ xs + 0.01 * rng.normal(size=256)).astype(np.float32)
        L = float(np.linalg.norm(dense, 2) ** 2)
        kw = dict(loss="quad", tol=1e-6, max_iters=600, L0=L, method="acc_b")
        exact = SparseRowMatrix.from_dense(dense, bs=32, device="cpu")
        quant = SparseRowMatrix.from_dense(dense, bs=32, device="cpu",
                                           quantize="int8")
        ref = api.solve(api.SolveRequest(A=exact, b=b, device="cpu", **kw))
        got = api.solve(api.SolveRequest(A=quant, b=b, device="cpu", **kw))
        assert _rel(got.x, ref.x) < 5e-2
        jq = JSparseRowMatrix.from_dense(dense, bs=32, quantize="int8")
        jgot = japi.solve(japi.SolveRequest(A=jq, b=b, **kw))
        assert _rel(got.x, jgot.x) < 1e-3


class TestAutoAgainstTheReference:
    @pytest.mark.parametrize("m,n,bs,tol,want", [
        # 16384 x 2048 with two stored 128-blocks a block-row (the stored
        # fraction of the reference's int8 golden, 2/16): 16.8 MB of f32
        # blocks, int8 saves 75% (3.8 µs on the H100 model, more on the
        # reference's slower HBM), so both quantize at tol 1e-3 ...
        (16384, 2048, 128, 1e-3, "int8"),
        # ... neither under int8's guard ...
        (16384, 2048, 128, 1e-4, "none"),
        # ... and neither on a 16 x 16 matrix (under the savings floor).
        (16, 16, 8, 1e-3, "none")])
    def test_quantize_auto(self, m, n, bs, tol, want):
        a = np.zeros((m, n), np.float32)
        a[:, :min(256, n)] = 1.0
        got = SparseRowMatrix.from_dense(a, bs=bs, device="cpu",
                                         quantize="auto", tol=tol)
        ref = JSparseRowMatrix.from_dense(a, bs=bs, quantize="auto", tol=tol)
        assert (got.scales is not None) == (want == "int8")
        assert (ref.scales is not None) == (want == "int8")

    @pytest.mark.parametrize("seed", [10, 11])
    def test_dispatch_auto_at_low_density(self, seed):
        """Two stored 128-blocks of 16 a block-row (the reference's BSR
        goldens' fraction): both planners keep the BlockELL product."""
        rng = np.random.default_rng(seed)
        mask = np.zeros((32, 16), bool)
        for i in range(32):
            mask[i, rng.choice(16, 2, replace=False)] = True
        dense = (np.kron(mask, np.ones((128, 128)))
                 * rng.normal(size=(4096, 2048))).astype(np.float32)
        srm = SparseRowMatrix.from_dense(dense, bs=128, device="cpu")
        jsrm = JSparseRowMatrix.from_dense(dense, bs=128)
        assert srm._use_bsr(1, "auto") and jsrm._use_bsr(1, "auto")
        v = rng.normal(size=2048).astype(np.float32)
        np.testing.assert_allclose(
            srm.matvec(torch.from_numpy(v)).numpy()[:4096],
            np.asarray(jsrm.matvec(jnp.asarray(v)))[:4096],
            rtol=1e-4, atol=1e-4)


def _trace(m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    bs = [(A @ rng.normal(size=n)).astype(np.float32) for _ in range(k)]
    return A, bs


def _both(budget_of, slots):
    """The same budgeted server in both packages; `budget_of(cost)` sets
    the budget from each package's own modeled group pass."""
    jcost = jplanner.plan("fusedgrad", {"m": 96, "n": 16}).cost_s
    pcost = planner.plan("fused_grad", {"m": 96, "n": 16},
                         backend="cpu").cost_s
    return (JSolverServer(slots=slots, budget_s=budget_of(jcost)),
            SolverServer(slots=slots, budget_s=budget_of(pcost),
                         backend="cpu"))


def _req(mod, A, b, **kw):
    return mod.SolveRequest(A=A, b=b, loss="quad", method="gra", tol=1e-6,
                            max_iters=150, **kw)


class TestBudgetedServer:
    def test_admission_respects_budget(self):
        """Two groups (distinct matrices) under a budget that fits one:
        the second waits until the first drains, in both servers."""
        (A1, bs1), (A2, bs2) = _trace(96, 16, 1, 11), _trace(96, 16, 1, 12)
        jsrv, psrv = _both(lambda c: 1.5 * c, 4)
        for srv, mod, kw in ((jsrv, japi, {}), (psrv, api, {"device": "cpu"})):
            i1 = srv.submit(_req(mod, A1, bs1[0], **kw))
            i2 = srv.submit(_req(mod, A2, bs2[0], **kw))
            srv.step()
            assert srv.pending() == 1
            assert srv.stats["deferred_steps"] >= 1
            srv.run()
            assert [e[0] for e in srv._events] == [i1, i2]
        for (jid, _, _), (pid, _, _) in zip(jsrv._events, psrv._events):
            np.testing.assert_allclose(
                np.asarray(psrv.result(pid).x),
                np.asarray(jsrv.result(jid).x), rtol=1e-4, atol=1e-4)

    def test_joining_an_active_group_is_free(self):
        A, bs = _trace(96, 16, 4, 13)
        jsrv, psrv = _both(lambda c: 1.1 * c, 4)
        for srv, mod, kw in ((jsrv, japi, {}), (psrv, api, {"device": "cpu"})):
            for b in bs:
                srv.submit(_req(mod, A, b, **kw))
            srv.step()
            assert srv.pending() == 0
            srv.run()
            assert len(srv._events) == 4

    def test_fifo_fairness_under_overload(self):
        jsrv, psrv = _both(lambda c: 1.5 * c, 2)
        traces = [_trace(96, 16, 1, 20 + s) for s in range(4)]
        for srv, mod, kw in ((jsrv, japi, {}), (psrv, api, {"device": "cpu"})):
            ids = [srv.submit(_req(mod, A, bs[0], **kw)) for A, bs in traces]
            srv.run()
            assert [e[0] for e in srv._events] == ids
        assert jsrv.stats["steps"] == psrv.stats["steps"]
        assert jsrv.stats["deferred_steps"] == psrv.stats["deferred_steps"]

    def test_a_budget_under_one_pass_cannot_deadlock(self):
        A, bs = _trace(96, 16, 2, 30)
        srv = SolverServer(slots=1, budget_s=1e-15, backend="cpu")
        ids = [srv.submit(_req(api, A, b, device="cpu")) for b in bs]
        srv.run()
        assert all(srv.result(i) is not None for i in ids)

    def test_one_shots_are_priced(self):
        A, bs = _trace(96, 12, 1, 17)
        R = RowMatrix.create(A, device="cpu")
        srv = SolverServer(slots=2, budget_s=1e-3, backend="cpu")
        s0 = srv.submit(_req(api, A, bs[0], device="cpu"))
        s1 = srv.submit(api.SvdRequest(A=R, k=3, device="cpu"))
        s2 = srv.submit(api.SimilarityRequest(A=R, device="cpu"))
        srv.run()
        assert srv._price(api.SvdRequest(A=R, k=3, device="cpu")) == \
            planner.plan("svd", {"m": 96, "n": 12, "k": 3},
                         backend="cpu").cost_s
        assert all(srv.result(i) is not None for i in (s0, s1, s2))
