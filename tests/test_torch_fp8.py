"""float8_e4m3fn storage in the port against the reference on the CPU.

The shared tests below take the fp8 type from the module's `fp8` fixture
(float8_e4m3fn here); tests/test_torch_e5m2.py runs them on float8_e5m2
by overriding it.  The same numpy inputs (seeded) go to both packages:

  * the cast (kernels/dtypes.to_e4m3) bit for bit against jax's
    ``astype`` at the edges (±448, the rounding midpoint 464, past it,
    ±inf, NaN, -0, the subnormal steps) and on random f32 and bf16 values;
  * the plain versions of the four kernels e4m3 reaches (fused_grad,
    fused_grad_multi, tsgram, gemm) against the reference's CPU dispatch,
    and tsgram and gemm also against its Pallas kernels in interpret mode;
  * the paths: RowMatrix.create and astype_store (the reference's bits),
    the Gram, the Gram SVD (U in e4m3), api.solve on combinations the
    reference runs on e4m3 storage (each engine, loss and reg), and one
    trace through both servers;
  * every path the reference refuses raises TypeError in the port, with
    no launch; the paths the reference runs on e4m3 (sketch, project
    and the chunked products through randsketch) run, on e5m2 too
    (float8_e5m2 itself: tests/test_torch_e5m2.py);
  * the reference's e4m3 arrays carried across by convert;
  * one two-rank gloo mesh: the fused pass and the Gram on e4m3 strips
    against one rank.

n is 64 and 100, so one width is not a multiple of 16 (an e4m3 row's
16-byte pieces)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_cluster_cases as C
from fp8_types import TYPE_E4M3, TYPE_E5M2, Fp8, bits as _bits
from repro import api as japi
from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core.linalg.tsqr import tsqr as jtsqr
from repro.kernels import gemm as jgemm_kernel
from repro.kernels import ops as jops
from repro.launch.serve import SolverServer as JSolverServer
from repro_torch import api, convert
from repro_torch.core.distmat import RowMatrix
from repro_torch.core.distmat import types as T
from repro_torch.core.linalg.tsqr import tsqr as ttsqr
from repro_torch.core.tfocs.smooth import SmoothQuad
from repro_torch.kernels import autotune as at
from repro_torch.kernels import dtypes
from repro_torch.kernels import fusedgrad, ops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import planner
from repro_torch.launch.serve import SolverServer

E4M3 = torch.float8_e4m3fn
M = 300
WIDTHS = (64, 100)
# The reference tests' own tolerances (tests/test_fusedgrad.py at f32).
TOL_F, TOL_GZ = 1e-5, 1e-4


@pytest.fixture(scope="module")
def fp8() -> Fp8:
    """The fp8 type the shared tests run on."""
    return TYPE_E4M3


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    at.reset()
    yield
    at.reset()
    torch.set_num_threads(threads)


def _problem(n: int, m: int = M, seed: int = 0, noise: float = 0.1):
    rng = np.random.default_rng(seed + n)
    A = rng.normal(size=(m, n)).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32) / np.sqrt(n)
    b = (A @ x + noise * rng.normal(size=m)).astype(np.float32)
    return A, b


# -- the cast -----------------------------------------------------------------

def _random_values(fp8: Fp8, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    scale = rng.choice(fp8.scales, 20000)
    return (rng.normal(size=20000) * scale).astype(np.float32)


@pytest.mark.parametrize("values", ["edges", "random"])
@pytest.mark.parametrize("source", ["float32", "bfloat16"])
def test_cast_is_the_references_bit_for_bit(values, source, fp8):
    x = fp8.edges if values == "edges" else _random_values(fp8, 1)
    if source == "bfloat16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
        t = T.tensor_from_array(x)
        assert t.dtype == torch.bfloat16
    else:
        t = torch.from_numpy(x)
    want = fp8.jcast(x)
    got = _bits(dtypes.cast(t, fp8.torch))
    np.testing.assert_array_equal(got, want)
    # torch's own cast writes other codes (e4m3: it saturates where the
    # reference gives NaN; e5m2: other NaN codes); the helper takes it over
    # only where the two agree.
    if values == "edges":
        assert (_bits(t.to(fp8.torch)) != want).any()


def test_cast_takes_every_bf16_pattern(fp8):
    """dtypes.cast from bf16 on all 2^16 bit patterns: the reference's
    codes."""
    x = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(
        ml_dtypes.bfloat16)
    np.testing.assert_array_equal(
        _bits(dtypes.cast(T.tensor_from_array(x), fp8.torch)), fp8.jcast(x))


def test_cast_keeps_shape_and_is_idempotent(fp8):
    x = torch.from_numpy(_random_values(fp8, 2)).reshape(200, 100)
    y = dtypes.cast(x, fp8.torch)
    assert y.shape == (200, 100) and y.dtype == fp8.torch
    assert dtypes.cast(y, fp8.torch) is y
    np.testing.assert_array_equal(_bits(dtypes.cast(x.double(), fp8.torch)),
                                  _bits(y))


# -- carrying the reference's arrays across -----------------------------------

def test_e4m3_arrays_cross_by_their_bits(fp8):
    A, _ = _problem(100)
    jrm = JRowMatrix.create(jnp.asarray(A), store_dtype=fp8.jax)
    rows = np.asarray(jrm.rows)
    assert rows.dtype == getattr(ml_dtypes, fp8.name)
    rm = convert.rowmatrix_from_numpy(rows, jrm.n_rows, device="cpu")
    assert rm.rows.dtype == fp8.torch and rm.shape == jrm.shape
    np.testing.assert_array_equal(_bits(rm.rows), _bits(rows))
    t = convert.tensor_from_numpy(rows, device="cpu")
    np.testing.assert_array_equal(_bits(t), _bits(rows))
    f = T.as_float_tensor(rows, torch.device("cpu"))
    np.testing.assert_array_equal(_bits(f), _bits(rows))
    # A cast on the way in takes the reference's rounding.
    e = convert.tensor_from_numpy(fp8.edges, device="cpu", dtype=fp8.torch)
    np.testing.assert_array_equal(_bits(e), fp8.jcast(fp8.edges))
    back = convert.rowmatrix_from_numpy(A, A.shape[0], device="cpu",
                                        store_dtype=fp8.torch)
    np.testing.assert_array_equal(_bits(back.rows), _bits(rows)[:M])


# -- the kernels' plain versions against the reference ------------------------

def _targets(loss: str, z: np.ndarray, rng) -> np.ndarray:
    if loss == "logistic":
        return np.where(z + rng.normal(size=z.shape) > 0, 1.0, -1.0) \
            .astype(np.float32)
    if loss == "poisson":
        return rng.poisson(np.exp(0.3 * np.clip(z, -3, 3))).astype(np.float32)
    return (z + 0.5 * rng.normal(size=z.shape)).astype(np.float32)


def _kernel_inputs(fp8: Fp8, n: int, k: int, loss: str, seed: int):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, n)).astype(np.float32)
    X = (rng.normal(size=(k, n)) / np.sqrt(n)).astype(np.float32)
    Z = X @ fp8.dequantized(A).T
    Tg = _targets(loss, Z, rng)
    W = rng.random((k, M)).astype(np.float32)
    W[:, -M // 8:] = 0.0
    return A, X, Tg, W


@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
@pytest.mark.parametrize("n", WIDTHS)
def test_fused_grad_plain_matches_reference(n, loss, fp8):
    A, X, Tg, W = _kernel_inputs(fp8, n, 1, loss, seed=n)
    ja = jnp.asarray(A).astype(fp8.jax)
    want = jops.fused_grad(ja, jnp.asarray(X[0]), jnp.asarray(Tg[0]),
                           jnp.asarray(W[0]), loss=loss, param=0.5)
    a = dtypes.cast(torch.from_numpy(A), fp8.torch)
    got = ops.fused_grad(a, torch.from_numpy(X[0]), torch.from_numpy(Tg[0]),
                         torch.from_numpy(W[0]), loss=loss, param=0.5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=TOL_F, atol=TOL_F)
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=TOL_GZ, atol=TOL_GZ)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("loss", ["quad", "logistic", "huber"])
def test_fused_grad_multi_plain_matches_reference(k, loss, fp8):
    A, X, Tg, W = _kernel_inputs(fp8, 100, k, loss, seed=k)
    ja = jnp.asarray(A).astype(fp8.jax)
    want = jops.fused_grad_multi(ja, jnp.asarray(X), jnp.asarray(Tg),
                                 jnp.asarray(W), loss=loss, param=0.5)
    got = ops.fused_grad_multi(dtypes.cast(torch.from_numpy(A), fp8.torch),
                               torch.from_numpy(X), torch.from_numpy(Tg),
                               torch.from_numpy(W), loss=loss, param=0.5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=TOL_F, atol=TOL_F)
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=TOL_GZ, atol=TOL_GZ)


@pytest.mark.parametrize("n", WIDTHS)
def test_tsgram_plain_matches_reference_and_its_kernel(n, fp8):
    A, _ = _problem(n)
    ja = jnp.asarray(A).astype(fp8.jax)
    a = dtypes.cast(torch.from_numpy(A), fp8.torch)
    got = ops.tsgram(a, out_dtype=torch.float32).numpy()
    for force in (False, True):
        want = np.asarray(jops.tsgram(ja, out_dtype=jnp.float32,
                                      force_pallas=force))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    Ad = fp8.dequantized(A).astype(np.float64)
    np.testing.assert_allclose(got, Ad.T @ Ad, rtol=1e-5, atol=1e-3)
    # An fp8 Gram, the reference's default out_dtype for fp8 A.
    g8 = ops.tsgram(a)
    assert g8.dtype == fp8.torch
    assert fp8.one_step(g8.float().numpy(),
                        np.asarray(jops.tsgram(ja)).astype(np.float32))


@pytest.mark.parametrize("n", WIDTHS)
def test_gemm_plain_matches_reference_and_its_kernel(n, fp8):
    A, _ = _problem(n)
    rng = np.random.default_rng(n)
    B = (rng.normal(size=(n, 16)) / np.sqrt(n)).astype(np.float32)
    ja = jnp.asarray(A).astype(fp8.jax)
    a = dtypes.cast(torch.from_numpy(A), fp8.torch)
    got = ops.gemm(a, torch.from_numpy(B), out_dtype=torch.float32).numpy()
    for force in (False, True):
        want = np.asarray(jops.gemm(ja, jnp.asarray(B), out_dtype=jnp.float32,
                                    force_pallas=force))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # The reference's Pallas kernel at its own tiles, fp8 in and out.
    jk = np.asarray(jgemm_kernel.gemm(
        jnp.pad(ja, ((0, 4), (0, 128 - n))),
        jnp.pad(jnp.asarray(B), ((0, 128 - n), (0, 112))), bm=8, bn=128,
        bk=128, interpret=True))[:M, :16]
    c8 = ops.gemm(a, torch.from_numpy(B))
    assert c8.dtype == fp8.torch
    assert fp8.one_step(c8.float().numpy(), jk.astype(np.float32))
    assert fp8.one_step(c8.float().numpy(), np.asarray(
        jops.gemm(ja, jnp.asarray(B))).astype(np.float32))


# -- the paths ------------------------------------------------------------------

@pytest.mark.parametrize("source", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", WIDTHS)
def test_storage_takes_the_references_bits(n, source, fp8):
    A, _ = _problem(n)
    A[3, :4] = fp8.past            # past the largest finite: NaN or inf
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    if source == "bfloat16":
        jA, tA = jA.astype(jnp.bfloat16), tA.to(torch.bfloat16)
    want = _bits(JRowMatrix.create(jA, store_dtype=fp8.jax).rows)
    made = RowMatrix.create(tA, device="cpu", store_dtype=fp8.torch)
    np.testing.assert_array_equal(_bits(made.rows), want[:M])
    base = RowMatrix.create(tA, device="cpu")
    cast = base.astype_store(fp8.torch)
    jcast = JRowMatrix.create(jA).astype_store(fp8.jax)
    np.testing.assert_array_equal(_bits(cast.rows), _bits(jcast.rows)[:M])
    assert base.rows.dtype == tA.dtype              # a copy, not a cast
    assert cast.out_dtype == torch.float32
    past = cast.rows[3, :2].float().numpy()
    assert (np.isnan(past) if fp8.past_nan else np.isinf(past)).all()
    back = cast.astype_store(torch.float32)
    np.testing.assert_array_equal(
        back.rows.numpy(),
        np.asarray(jcast.astype_store(jnp.float32).rows)[:M])


@pytest.mark.parametrize("n", WIDTHS)
def test_gram_and_gram_svd_match_reference(n, fp8):
    A, _ = _problem(n)
    jrm = JRowMatrix.create(jnp.asarray(A), store_dtype=fp8.jax)
    rm = RowMatrix.create(A, device="cpu", store_dtype=fp8.torch)
    g = rm.gram()
    assert g.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), np.asarray(jrm.gram()), rtol=1e-5,
                               atol=1e-3)
    k = 6
    jres = japi.svd(japi.SvdRequest(A=jrm, k=k, mode="auto"))
    res = api.svd(api.SvdRequest(A=rm, k=k, mode="auto", device="cpu"))
    assert res.info["plan"] == jres.info["plan"] == "gram"
    assert res.info["a_passes"] == jres.info["a_passes"] == 2
    U, s, V = res.factors
    jU, js, _ = jres.factors
    s64 = np.linalg.svd(fp8.dequantized(A).astype(np.float64),
                        compute_uv=False)[:k]
    assert np.max(np.abs(s.numpy() - js) / js) <= 1e-4
    assert np.max(np.abs(s.numpy() - s64) / s64) <= 1e-4
    # U in A's type, as the reference's multiply_local keeps it.
    assert U.rows.dtype == fp8.torch
    ju = np.asarray(jU.rows)[:M]
    assert ju.dtype == getattr(ml_dtypes, fp8.name)
    # Columns are defined up to sign: align each to the reference's.
    u = U.rows.float().numpy()
    sign = np.sign(np.sum(u * ju.astype(np.float32), axis=0))
    assert fp8.one_step(u * sign, ju.astype(np.float32))


# api.solve on fp8 storage: combinations the reference runs there (gra
# for quad, logistic and huber with reg none, l1 or l2; quad's fused
# accelerated engine; lbfgs), each at convergence on both sides, the
# objectives within 1e-5 (quad lbfgs runs in the server test's group).
# lbfgs stops at ||g|| < tol |f|, which f32 meets on both sides at 1e-3
# (ROADMAP queue 3: stops at the rounding floor).
SOLVES = [("quad", "gra", "l2"), ("quad", "acc", "l1"),
          ("quad", "acc_rb", "none"), ("logistic", "gra", "none"),
          ("huber", "gra", "l1"), ("logistic", "lbfgs", "none"),
          ("huber", "lbfgs", "none")]


def _solve_kw(fp8, loss, method, reg, A, b):
    noisy = b + 2.0 * np.random.default_rng(7).normal(size=b.shape)
    y = np.where(noisy > 0, 1.0, -1.0).astype(np.float32)
    L = float(np.linalg.norm(fp8.dequantized(A), 2) ** 2)
    return dict(b=y if loss == "logistic" else b, loss=loss, method=method,
                reg=reg, lam=0.5, param=0.5,
                L0=0.25 * L if loss == "logistic" else L,
                tol=1e-3 if method == "lbfgs" else 1e-7, max_iters=3000)


@pytest.mark.parametrize("loss,method,reg", SOLVES)
def test_solve_matches_reference(loss, method, reg, fp8):
    A, b = _problem(64, seed=3)
    kw = _solve_kw(fp8, loss, method, reg, A, b)
    jrm = JRowMatrix.create(jnp.asarray(A), store_dtype=fp8.jax)
    rm = RowMatrix.create(A, device="cpu", store_dtype=fp8.torch)
    j = japi.solve(japi.SolveRequest(A=jrm, **kw))
    t = api.solve(api.SolveRequest(A=rm, device="cpu", **kw))
    assert bool(j.info["converged"]) and bool(t.info["converged"])
    assert t.info["precision"] == j.info["precision"] == "f32"
    jf, tf = float(j.info["objective"]), float(t.info["objective"])
    assert abs(tf - jf) <= 1e-5 * abs(jf), (tf, jf)
    assert t.x.dtype == torch.float32


def test_explicit_bf16_recasts_e4m3_storage(fp8):
    """precision="bf16" recasts the operand (a bf16 copy of the fp8
    values, exact) as the reference's solver does; the caller's matrix
    keeps its fp8 type."""
    A, b = _problem(64, seed=3)
    kw = _solve_kw(fp8, "quad", "gra", "none", A, b)
    jrm = JRowMatrix.create(jnp.asarray(A), store_dtype=fp8.jax)
    rm = RowMatrix.create(A, device="cpu", store_dtype=fp8.torch)
    j = japi.solve(japi.SolveRequest(A=jrm, precision="bf16", **kw))
    t = api.solve(api.SolveRequest(A=rm, device="cpu", precision="bf16",
                                   **kw))
    assert t.info["precision"] == j.info["precision"] == "bf16"
    assert rm.rows.dtype == fp8.torch
    jf, tf = float(j.info["objective"]), float(t.info["objective"])
    assert abs(tf - jf) <= 1e-5 * abs(jf)


def test_server_matches_reference(fp8):
    """gra, acc_rb and lbfgs groups on one fp8 A through both servers,
    every answer within 1e-5 of the other's objective and of the float64
    optimum of the dequantized A (lbfgs capped at 100 iterations: its
    ||g|| < tol |f| test cannot pass at f32's floor, ROADMAP queue 3)."""
    A, _ = _problem(64, seed=5)
    rng = np.random.default_rng(11)
    Ad = fp8.dequantized(A)
    bs = [(Ad @ rng.normal(size=64) / 8 + 0.1 * rng.normal(size=M))
          .astype(np.float32) for _ in range(6)]
    L = float(np.linalg.norm(Ad, 2) ** 2)
    jrm = JRowMatrix.create(jnp.asarray(A), store_dtype=fp8.jax)
    rm = RowMatrix.create(A, device="cpu", store_dtype=fp8.torch)
    jsrv, tsrv = JSolverServer(slots=2), SolverServer(slots=2)
    pairs = []
    for i, b in enumerate(bs):
        method = ("gra", "acc_rb", "lbfgs")[i % 3]
        kw = dict(b=b, loss="quad", method=method, L0=L,
                  max_iters=100 if method == "lbfgs" else 400,
                  tol=1e-3 if method == "lbfgs" else 1e-7)
        pairs.append((jsrv.submit(japi.SolveRequest(A=jrm, **kw)),
                      tsrv.submit(api.SolveRequest(A=rm, device="cpu",
                                                   **kw))))
    jsrv.run()
    tsrv.run()
    A64 = Ad.astype(np.float64)
    for (jid, tid), b in zip(pairs, bs):
        j, t = jsrv.result(jid), tsrv.result(tid)
        assert t.info["plan"] == "fused-group"

        def obj(x):
            r = A64 @ np.asarray(x, np.float64) - b
            return 0.5 * float(r @ r)
        f64 = obj(np.linalg.lstsq(A64, b, rcond=None)[0])
        jf, tf = obj(j.x), obj(t.x.numpy())
        assert abs(tf - jf) <= 1e-5 * jf and abs(tf - f64) <= 1e-5 * f64


# -- what the reference refuses -------------------------------------------------

def _lanczos(rm, api_):
    return api_.svd(api_.SvdRequest(A=rm, k=3, mode="lanczos",
                                    **({} if api_ is japi
                                       else {"device": "cpu"})))


def _randomized(rm, api_):
    return api_.svd(api_.SvdRequest(A=rm, k=3, mode="randomized",
                                    **({} if api_ is japi
                                       else {"device": "cpu"})))


def _similarities(rm, api_):
    return api_.similarities(api_.SimilarityRequest(
        A=rm, **({} if api_ is japi else {"device": "cpu"})))


def _solve(loss, method, fused="auto"):
    def run(rm, api_):
        A, b = _problem(64, seed=3)
        kw = _solve_kw(TYPE_E4M3, loss, method, "none", A, b)
        kw["max_iters"] = 5
        if api_ is japi:
            return japi.solve(japi.SolveRequest(A=rm, **kw), fused=fused)
        return api.solve(api.SolveRequest(A=rm, device="cpu", **kw),
                         fused=fused)
    return run


REFUSED = {
    "matvec": lambda rm, api_: rm.matvec(
        (jnp if api_ is japi else torch).ones(64)),
    "rmatvec": lambda rm, api_: rm.rmatvec(
        (jnp if api_ is japi else torch).ones(M)),
    "column_stats": lambda rm, api_: rm.column_stats(),
    "scale_columns": lambda rm, api_: rm.scale_columns(
        (jnp if api_ is japi else torch).ones(64)),
    "lanczos_svd": _lanczos,
    "randomized_svd": _randomized,
    "tsqr": lambda rm, api_: (jtsqr if api_ is japi else ttsqr)(rm),
    "pca": lambda rm, api_: rm.compute_pca(3),
    "dimsum": _similarities,
    "logistic_acc": _solve("logistic", "acc"),
    "huber_acc_rb": _solve("huber", "acc_rb"),
    "poisson_acc": _solve("poisson", "acc"),
    "quad_unfused": _solve("quad", "gra", fused=False),
}


@pytest.fixture(scope="module")
def e4m3_pair(fp8):
    """One fp8 matrix in each package."""
    A, _ = _problem(64, seed=3)
    return (JRowMatrix.create(jnp.asarray(A), store_dtype=fp8.jax),
            RowMatrix.create(A, device="cpu", store_dtype=fp8.torch))


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_refused_where_the_reference_raises(what, e4m3_pair, fp8):
    """Each path the reference refuses raises TypeError naming both fp8
    types (and this one) and the reference-side refusal, with no
    launch."""
    jrm, rm = e4m3_pair
    with pytest.raises(Exception):
        REFUSED[what](jrm, japi)
    ops.reset_launch_counts()
    with pytest.raises(TypeError, match="float8_e4m3fn or float8_e5m2") \
            as err:
        REFUSED[what](rm, api)
    assert fp8.name in str(err.value) and T.FP8_REFUSED in str(err.value)
    assert not any(ops.launch_counts().values())


def test_e4m3_reaches_four_kernels_alone_on_the_cpu():
    """The block-sparse wrappers refuse e4m3 on either device, before any
    work (the reference's BlockELL has no fp8); randsketch, the fifth
    dense kernel, takes it since sketch, project and the chunked products
    reach it, and its plain version widens A exactly."""
    a = dtypes.to_e4m3(torch.randn(40, 16))
    q = torch.randn(40, 3)
    got = ops.randsketch(a, q, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), (a.double().T @ q.double())
                               .numpy(), rtol=1e-5, atol=1e-5)
    from repro_torch.kernels import bsr
    bell = bsr.BlockELL(dtypes.to_e4m3(torch.randn(5, 2, 8, 8)),
                        torch.zeros(5, 2, dtype=torch.int32), (40, 16))
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        ops.bsr_matvec(bell, torch.randn(16))


# Paths the reference runs on fp8 storage, each against the same call on
# the dequantized f32 matrix (the f32 storage path the reference tests
# hold to the reference): sketch on one device (the test matrix's fp8
# values; Y in A's type), and the chunked fused gradient on one device
# (chunks=4, the mesh's body with one shard).
RUNS = {"sketch": lambda rm, x, sep: rm.sketch(3).rows,
        "chunked_fused_grad": lambda rm, x, sep: rm.fused_grad(
            x, sep, chunks=4)[1]}


@pytest.mark.parametrize("t8", [TYPE_E4M3, TYPE_E5M2], ids=["e4m3", "e5m2"])
@pytest.mark.parametrize("what", sorted(RUNS))
def test_paths_the_reference_runs_run_on_fp8(what, t8):
    """RowMatrix.sketch and the chunked fused gradient run on fp8 storage,
    as the reference's do: the chunked gradient's segments through
    randsketch (its plain version here), g within 1e-4 of eager; the sketch in A's type,
    within one fp8 step of the f32 product of the fp8 values (the
    reference's ``a @ omega``, tests/test_torch_e5m2.py holds it to the
    reference)."""
    A, b = _problem(64, seed=4)
    rm = RowMatrix.create(A, device="cpu", store_dtype=t8.torch)
    sep = SmoothQuad(torch.as_tensor(b))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=64)
                         .astype(np.float32)) / 8
    got = RUNS[what](rm, x, sep)
    if what == "chunked_fused_grad":
        want = rm.fused_grad(x, sep)[1]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL_GZ,
                                   atol=TOL_GZ)
    else:
        assert got.dtype == t8.torch and got.shape == (M, 3)
        gen = torch.Generator().manual_seed(0)
        om = dtypes.cast(torch.randn((64, 3), generator=gen), t8.torch)
        assert t8.one_step(got.double().numpy(),
                           (rm.rows.double() @ om.double()).numpy())


def test_plans_price_each_route():
    """plan("grad" | "gram") on e4m3 storage: the fused kernel's f32 FMAs
    and tsgram's 16-bit tensor-core products, a quarter of f32's bytes;
    gemm's TF32 products, two a product; the fused route alone."""
    m, n = 1 << 21, 1024
    grad = planner.plan("grad", {"m": m, "n": n}, E4M3, backend="cuda")
    assert grad.choice == "fused"
    assert grad.terms["route"] == "fma"
    assert grad.terms["hbm_bytes"] == m * n + 4 * (2 * n + 3 * m + 1)
    gram = planner.plan("gram", {"m": m, "n": n}, E4M3, backend="cuda")
    assert gram.terms["route"] == "bf16"
    assert gram.terms["flops"] == float(m) * n * (n + 1)
    terms = at.cost_terms("gemm", {"bn": 16}, {"m": m, "k": n, "n": 16},
                          E4M3)
    assert terms.route == "tf32" and terms.flops == 2 * 2.0 * m * n * 16
    assert at.gemm_smem(32, 1)[0] >= 2
    # On a mesh the chunked routes (randsketch launches on the e4m3
    # strip) compete as on f32; the unfused one is never chosen.
    ctx = {"axes": (64,)}
    grad = planner.plan("grad", {"m": 4096, "n": 4096}, E4M3, context=ctx)
    assert any(lb.startswith("fused-overlap") for lb, _ in grad.alternatives)
    assert grad.choice == "fused"
    gram = planner.plan("gram", {"m": 4096, "n": 4096}, E4M3, context=ctx)
    assert any(lb.startswith("overlap") for lb, _ in gram.alternatives)


# -- a mesh -------------------------------------------------------------------

def test_two_rank_mesh_matches_one_rank(fp8):
    """fp8 strips on a two-rank gloo mesh (each rank casting its own strip
    through dtypes.cast): the fused pass and the Gram within f32
    tolerance of one device, the strips the one-device rows' bits."""
    A, b = _problem(64, m=101, seed=9)
    x = np.random.default_rng(1).normal(size=64).astype(np.float32) / 8
    ranks = tmesh.spawn(C.fp8_rank, 2, args=(A, b, x, fp8.name),
                        backend="gloo", device="cpu", timeout_s=60,
                        deadline_s=120)
    one = RowMatrix.create(A, device="cpu", store_dtype=fp8.torch)
    f, g, z = one.fused_grad(torch.from_numpy(x),
                             SmoothQuad(torch.from_numpy(b)))
    gram = one.gram()
    strips = torch.cat([r["strip"] for r in ranks])[:101]
    np.testing.assert_array_equal(strips.numpy(), _bits(one.rows))
    for r in ranks:
        assert r["dtype"] == str(fp8.torch)
        np.testing.assert_allclose(r["f"].numpy(), f.numpy(), rtol=1e-5)
        np.testing.assert_allclose(r["g"].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(r["gram"].numpy(), gram.numpy(),
                                   rtol=1e-5, atol=1e-3)
    z2 = torch.cat([r["z"] for r in ranks])[:101]
    np.testing.assert_allclose(z2.numpy(), z[:101].numpy(), rtol=1e-4,
                               atol=1e-4)
