"""The port's optimizer front door against the reference's, on the CPU:
`make_problem` (the four Figure-1 problems, the same numpy draws, L from
the on-device power iteration), `composite_value`, `lbfgs_value_and_grad`,
`minimize` for every problem and method at fused=True and fused=False,
`api.minimize`, `api.solve(SolveRequest(problem=...))`, `api.compute_svd`,
a problem request through `SolverServer`, and the server's demo CLI.

Fixed-step methods (gra, acc, acc_r) take the same decisions on both sides,
so their counts and histories are compared step for step.  Backtracking
and Armijo tests (acc_b, acc_rb, lbfgs) compare f32 values at the rounding
floor and can fall either way near the optimum (ROADMAP queue 3): their
answers are compared at convergence or at tests/test_optim.py's bound, and
their A-pass counts against each engine's formula on each side.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import optim as jopt
from repro.core.distmat import RowMatrix as JRowMatrix
from repro_torch import api
from repro_torch.core import optim
from repro_torch.core.distmat import RowMatrix
from repro_torch.core.tfocs import CountingLinop
from repro_torch.launch import serve

NAMES = ("linear", "linear_l1", "logistic", "logistic_l2")
M, N = 256, 64
FIXED_STEP = ("gra", "acc", "acc_r")


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny torch ops: one intra-op thread keeps them fast on shared
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(name, m=M, n=N):
    return (jopt.make_problem(name, m=m, n=n),
            optim.make_problem(name, m=m, n=n, device="cpu"))


@pytest.mark.parametrize("n", [64, 1024])
@pytest.mark.parametrize("name", NAMES)
def test_make_problem_draws_the_reference_data(name, n):
    ref = jopt.make_problem(name, m=M, n=n)
    got = optim.make_problem(name, m=M, n=n, device="cpu")
    rA, gA = ref.linop.A, got.linop.A
    assert gA.shape == rA.shape and gA.device.type == "cpu"
    np.testing.assert_array_equal(gA.to_local().numpy(),
                                  np.asarray(rA.rows)[: rA.n_rows])
    target = "b" if name.startswith("linear") else "y"
    np.testing.assert_array_equal(
        getattr(got.smooth, target).numpy()[:M],
        np.asarray(getattr(ref.smooth, target))[:M])
    np.testing.assert_array_equal(got.smooth.weights.numpy()[:M],
                                  np.asarray(ref.smooth.weights)[:M])
    assert got.L == pytest.approx(ref.L, rel=1e-6)
    assert type(got.prox).__name__ == type(ref.prox).__name__
    assert getattr(got.prox, "lam", None) == getattr(ref.prox, "lam", None)
    assert type(got.smooth_for_lbfgs).__name__ == \
        type(ref.smooth_for_lbfgs).__name__


def test_make_problem_refuses_a_mesh_and_unknown_names():
    """A one-device mesh gives the device= problem bit for bit (the
    multi-rank problems: tests/test_torch_cluster.py); unknown names
    still raise."""
    from repro_torch.core.distmat import types as T
    on_mesh = optim.make_problem("linear", m=16, n=4,
                                 mesh=T.single_device_mesh("cpu"))
    plain = optim.make_problem("linear", m=16, n=4, device="cpu")
    assert torch.equal(on_mesh.linop.A.rows, plain.linop.A.rows)
    assert torch.equal(on_mesh.smooth.b, plain.smooth.b)
    assert on_mesh.L == plain.L
    with pytest.raises(ValueError, match="unknown problem"):
        optim.make_problem("quadratic", m=16, n=4, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_composite_value_and_lbfgs_value_and_grad(name):
    ref, got = _pair(name)
    x = (np.random.default_rng(3).normal(size=got.linop.in_shape[0])
         * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        optim.composite_value(got, torch.from_numpy(x)).item(),
        float(jopt.composite_value(ref, jnp.asarray(x))), rtol=1e-5)
    for fused in (True, False):
        f, g = optim.lbfgs_value_and_grad(got, fused=fused)(
            torch.from_numpy(x))
        jf, jg = jopt.lbfgs_value_and_grad(ref, fused=fused)(jnp.asarray(x))
        np.testing.assert_allclose(f.item(), float(jf), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jg).max()))


def _passes_formula(info):
    k = info["iterations"]
    if info["plan"] in ("fused", "two-pass") and "n_evals" in info:
        return info["n_evals"] * (1 if info["plan"] == "fused" else 2)
    bt = info["n_backtracks"]
    return {"fused": 1 + k + bt, "fused_affine": 2 + k + bt,
            "cached": 1 + 2 * (k + bt)}[info["plan"]]


def _ints(info):
    return {k: int(info[k]) for k in ("iterations", "a_passes")
            if k in info} | {k: int(info[k]) for k in
                             ("n_backtracks", "n_evals") if k in info}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("method", optim.METHODS)
@pytest.mark.parametrize("name", NAMES)
def test_minimize_matches_reference(name, method, fused):
    ref, got = _pair(name)
    jx, jinfo = jopt.minimize(ref, method, max_iters=150, fused=fused)
    counting = CountingLinop(got.linop)
    x, info = optim.minimize(
        optim.Problem(got.name, counting, got.smooth, got.prox,
                      got.smooth_for_lbfgs, got.L),
        method, max_iters=150, fused=fused)
    jx = np.asarray(jx)
    # Structure: the same engine, its A-passes by its formula, counted at
    # run time on the port's side.
    assert info["plan"] == jinfo["plan"]
    assert info["a_passes"] == counting.total() == _passes_formula(info)
    assert int(jinfo["a_passes"]) == _passes_formula(
        {**jinfo, **_ints(jinfo)})
    assert {"iterations", "a_passes", "converged", "plan",
            "history"} <= set(info)
    f = optim.composite_value(got, x).item()
    jf = float(jopt.composite_value(ref, jnp.asarray(jx)))
    scale = max(1.0, float(np.linalg.norm(jx)))
    if method in FIXED_STEP:
        # The same decisions: the same counts and the same history.
        assert info["iterations"] == int(jinfo["iterations"])
        assert info["a_passes"] == int(jinfo["a_passes"])
        assert info["converged"] == bool(jinfo["converged"])
        k = info["iterations"]
        np.testing.assert_allclose(info["history"][:k].numpy(),
                                   np.asarray(jinfo["history"])[:k],
                                   rtol=1e-5)
        assert np.linalg.norm(x.numpy() - jx) / scale <= 1e-5
        np.testing.assert_allclose(f, jf, rtol=1e-5)
    else:
        # Backtracking at the f32 rounding floor: the answers agree to the
        # floor's reach, and both sit at tests/test_optim.py's bound of the
        # better of the two.
        assert np.linalg.norm(x.numpy() - jx) / scale <= 1e-3
        np.testing.assert_allclose(f, jf, rtol=1e-4)
        best = min(f, jf)
        assert f <= best + 0.05 * (abs(best) + 1.0)


def test_minimize_step_size_and_method_check():
    ref, got = _pair("linear")
    for step in (1e-3, 1.0 / got.L):
        jx, jinfo = jopt.minimize(ref, "gra", max_iters=30, step_size=step,
                                  fused=True)
        x, info = optim.minimize(got, "gra", max_iters=30, step_size=step,
                                 fused=True)
        assert info["iterations"] == int(jinfo["iterations"])
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="method must be"):
        optim.minimize(got, "sgd")


@pytest.mark.parametrize("method", ["gra", "acc_rb", "lbfgs"])
def test_api_minimize_and_problem_request(method):
    ref, got = _pair("logistic_l2")
    x, info = optim.minimize(got, method, max_iters=60, fused=True)
    ax, ainfo = api.minimize(got, method, max_iters=60, fused=True)
    res = api.solve(api.SolveRequest(problem=got, method=method,
                                     max_iters=60, tol=1e-10, device="cpu"),
                    fused=True)
    jx, jinfo = japi.minimize(ref, method, max_iters=60, fused=True)
    for y, i in ((ax, ainfo), (res.x, res.info)):
        torch.testing.assert_close(y, x, rtol=0, atol=0)
        assert i["iterations"] == info["iterations"]
        assert i["a_passes"] == info["a_passes"]
        assert i["degraded"] is None and i["plan"] == info["plan"]
    assert res.request_id.startswith("solve-")
    assert np.linalg.norm(x.numpy() - np.asarray(jx)) \
        / max(1.0, float(np.linalg.norm(jx))) <= 1e-3
    # step_size skips the request path, as in the reference.
    sx, _ = api.minimize(got, method, max_iters=10, step_size=0.01,
                         fused=True)
    tx, _ = optim.minimize(got, method, max_iters=10, step_size=0.01,
                           fused=True)
    torch.testing.assert_close(sx, tx, rtol=0, atol=0)


def test_problem_request_validation():
    _, got = _pair("linear")
    api.SolveRequest(problem=got, device="cpu")        # no (A, b) needed
    with pytest.raises(ValueError, match="problem/smooth"):
        api.SolveRequest(device="cpu")
    with pytest.raises(ValueError, match="problem/smooth"):
        japi.SolveRequest()


@pytest.mark.parametrize("mode", ["auto", "gram", "lanczos"])
def test_api_compute_svd_matches_reference(mode):
    a = np.random.default_rng(11).normal(size=(90, 12)).astype(np.float32)
    a *= np.linspace(3.0, 1.0, 12, dtype=np.float32)
    kw = dict(tol=1e-7, max_restarts=100) if mode == "lanczos" else {}
    jU, js, jV, jinfo = japi.compute_svd(JRowMatrix.create(jnp.asarray(a)),
                                         4, mode=mode, **kw)
    U, s, V, info = api.compute_svd(RowMatrix.create(a, device="cpu"), 4,
                                    mode=mode, device="cpu", **kw)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4)
    cos = np.linalg.svd(V.numpy().T @ np.asarray(jV), compute_uv=False)
    assert cos.min() >= 1 - 1e-4
    assert info["plan"] == jinfo["plan"]
    assert info["a_passes"] == int(jinfo["a_passes"])
    np.testing.assert_allclose(U.to_local().numpy(),
                               np.asarray(jU.to_local()) * np.sign(
                                   np.sum(U.to_local().numpy()
                                          * np.asarray(jU.to_local()), 0)),
                               atol=1e-3)
    want = api.svd(api.SvdRequest(A=RowMatrix.create(a, device="cpu"), k=4,
                                  mode=mode, options=kw, device="cpu"))
    torch.testing.assert_close(s, want.factors[1], rtol=0, atol=0)


# -- the server ---------------------------------------------------------------

def test_problem_request_is_served_one_shot():
    _, got = _pair("linear_l1")
    server = serve.SolverServer(slots=4)
    req = api.SolveRequest(problem=got, method="acc_rb", max_iters=80,
                           tol=1e-10, device="cpu")
    assert not serve.batchable(req)
    rid = server.submit(req)
    rng = np.random.default_rng(0)
    A = RowMatrix.create(rng.normal(size=(40, 6)).astype(np.float32),
                         device="cpu")
    grouped = [server.submit(api.SolveRequest(
        A=A, b=rng.normal(size=40).astype(np.float32), method="gra",
        max_iters=50, device="cpu")) for _ in range(2)]
    server.run()
    assert server.stats["oneshot"] == 1 and server.stats["admitted"] == 2
    got_res = server.result(rid)
    want = api.solve(api.SolveRequest(problem=got, method="acc_rb",
                                      max_iters=80, tol=1e-10, device="cpu"))
    torch.testing.assert_close(got_res.x, want.x, rtol=0, atol=0)
    assert got_res.info["iterations"] == want.info["iterations"]
    assert got_res.info["plan"] == "fused_affine"
    assert all(server.result(r).info["plan"] == "fused-group"
               for r in grouped)


def test_serve_main_runs_on_the_cpu(capsys):
    server = serve.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("served 16 requests in ")
    assert lines[1].startswith(f"group A-passes: {server.stats['a_passes']} ")
    assert lines[2].startswith("latency p50 ")
    assert len(lines) == 6 and all(l.startswith("  solve-")
                                   for l in lines[3:])
    assert server.stats["admitted"] == 16 and not server.busy()
    # --budget-us prices admission with the planner; one matrix is one
    # group, which every request joins for free.
    budgeted = serve.main(["--device", "cpu", "--m", "8", "--n", "2",
                           "--budget-us", "50"])
    assert budgeted.budget_s == pytest.approx(50e-6)
    assert budgeted.stats["admitted"] == 16 and not budgeted.busy()
