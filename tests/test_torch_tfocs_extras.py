"""The port's TFOCS extras against the reference's, on the CPU: the smooth
components SmoothLinear, SmoothHuberL1 and SmoothSum, LinopAdjoint,
solve_lasso on the fixture of tests/test_tfocs.py and solve_smoothed_lp on
its LP, each at that file's tolerances.  Inputs are numpy arrays from a
seed, fed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core import tfocs as jt
from repro_torch.core.distmat import RowMatrix
from repro_torch.core.tfocs import (LinopAdjoint, LinopMatrix, SmoothHuberL1,
                                    SmoothLinear, SmoothLogLoss, SmoothQuad,
                                    SmoothSum, TfocsOptions, solve_lasso,
                                    solve_smoothed_lp)


def _vec(seed, n, scale=1.0):
    return (np.random.default_rng(seed).normal(size=n) * scale).astype(
        np.float32)


SMOOTHS = {
    "linear": (lambda: SmoothLinear(torch.from_numpy(_vec(1, 40))),
               lambda: jt.SmoothLinear(jnp.asarray(_vec(1, 40)))),
    # δ of the order of z's entries, so both branches of the Huber are hit.
    "huber_l1": (lambda: SmoothHuberL1(0.7, delta=0.5),
                 lambda: jt.SmoothHuberL1(0.7, delta=0.5)),
    "huber_l1_default": (lambda: SmoothHuberL1(2.0),
                         lambda: jt.SmoothHuberL1(2.0)),
    "sum": (lambda: SmoothSum((SmoothQuad(torch.from_numpy(_vec(2, 40))),
                               SmoothHuberL1(0.3, delta=0.2),
                               SmoothLinear(torch.from_numpy(_vec(3, 40))))),
            lambda: jt.SmoothSum((jt.SmoothQuad(jnp.asarray(_vec(2, 40))),
                                  jt.SmoothHuberL1(0.3, delta=0.2),
                                  jt.SmoothLinear(jnp.asarray(_vec(3, 40)))))),
}


@pytest.mark.parametrize("name", sorted(SMOOTHS))
def test_smooth_value_and_grad_match_reference(name):
    port, ref = (f() for f in SMOOTHS[name])
    z = _vec(0, 40)
    z[:5] *= 1e-5                       # inside the Huber's quadratic part
    got_v = port.value(torch.from_numpy(z))
    got_g = port.grad(torch.from_numpy(z))
    assert got_v.dim() == 0
    np.testing.assert_allclose(got_v.item(), float(ref.value(jnp.asarray(z))),
                               rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref.grad(
        jnp.asarray(z))), rtol=1e-5, atol=1e-6)


def test_linop_adjoint_matches_reference():
    a = np.random.default_rng(4).normal(size=(13, 6)).astype(np.float32)
    base = LinopMatrix(RowMatrix.create(a, device="cpu"))
    jbase = jt.LinopMatrix(JRowMatrix.create(jnp.asarray(a)))
    adj, jadj = LinopAdjoint(base), jt.LinopAdjoint(jbase)
    assert adj.in_shape == jadj.in_shape == (13,)
    assert adj.out_shape == jadj.out_shape == (6,)
    u, x = _vec(5, 13), _vec(6, 6)
    np.testing.assert_allclose(adj.apply(torch.from_numpy(u)).numpy(),
                               np.asarray(jadj.apply(jnp.asarray(u))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(adj.adjoint(torch.from_numpy(x)).numpy(),
                               np.asarray(jadj.adjoint(jnp.asarray(x)))[:13],
                               rtol=1e-5, atol=1e-6)
    w = adj.row_weights()
    assert w.device == base.device and w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), np.asarray(jadj.row_weights()))
    assert adj.pad_data(torch.ones(6)).shape == (6,)


# -- lasso: the fixture of tests/test_tfocs.py ---------------------------------

@pytest.fixture(scope="module")
def lasso_problem():
    rng = np.random.default_rng(2)
    m, n = 80, 24
    A = rng.normal(size=(m, n)).astype(np.float32)
    xt = np.zeros(n, np.float32)
    xt[:5] = rng.normal(size=5) * 2
    b = (A @ xt + 0.01 * rng.normal(size=m)).astype(np.float32)
    lam = 0.5
    L = np.linalg.norm(A, 2) ** 2
    x = np.zeros(n)
    for _ in range(30000):                       # ISTA reference, float64
        x -= A.T @ (A @ x - b) / L
        x = np.sign(x) * np.maximum(np.abs(x) - lam / L, 0)
    f_ref = 0.5 * np.linalg.norm(A @ x - b) ** 2 + lam * np.abs(x).sum()
    return A, b, lam, L, x, f_ref


def _obj(A, b, lam, x):
    x = np.asarray(x, np.float64)
    return 0.5 * np.linalg.norm(A @ x - b) ** 2 + lam * np.abs(x).sum()


def test_lasso_matches_reference(lasso_problem):
    A, b, lam, L, x_ref, f_ref = lasso_problem
    opts = dict(max_iters=600, tol=1e-12, backtracking=True, restart=True)
    jx, _ = jt.solve_lasso(JRowMatrix.create(A), jnp.asarray(b), lam,
                           opts=jt.TfocsOptions(**opts))
    x, info = solve_lasso(RowMatrix.create(A, device="cpu"), b, lam,
                          opts=TfocsOptions(**opts))
    assert info["plan"] == "fused_affine"
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    assert _obj(A, b, lam, x) <= f_ref * (1 + 1e-3)
    np.testing.assert_allclose(x.numpy(), x_ref, atol=5e-3)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=5e-3)


def test_lasso_default_options_are_acc_rb(lasso_problem):
    A, b, lam, L, x_ref, f_ref = lasso_problem
    jx, jinfo = jt.solve_lasso(JRowMatrix.create(A), jnp.asarray(b), lam)
    x, info = solve_lasso(RowMatrix.create(A, device="cpu"),
                          torch.from_numpy(b), lam)
    assert info["plan"] == "fused_affine"
    assert info["a_passes"] == 2 + info["iterations"] + info["n_backtracks"]
    assert info["n_restarts"] > 0
    assert _obj(A, b, lam, x) <= f_ref * (1 + 1e-3)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=5e-3)


def test_lasso_backtracking_counts(lasso_problem):
    A, b, lam, *_ = lasso_problem
    opts = dict(max_iters=50, backtracking=True, L0=1e-3)
    _, jinfo = jt.solve_lasso(JRowMatrix.create(A), jnp.asarray(b), lam,
                              opts=jt.TfocsOptions(**opts))
    _, info = solve_lasso(RowMatrix.create(A, device="cpu"), b, lam,
                          opts=TfocsOptions(**opts))
    # L0 deliberately tiny → backtracking must have fired on both sides.
    assert info["n_backtracks"] > 0 and int(jinfo["n_backtracks"]) > 0


# -- the smoothed LP of tests/test_tfocs.py -----------------------------------

def _lp():
    rng = np.random.default_rng(7)
    mc, nc = 6, 14
    Ac = rng.normal(size=(mc, nc)).astype(np.float32)
    xstar = np.zeros(nc, np.float32)
    xstar[:3] = rng.random(3).astype(np.float32) + 0.5
    bc = Ac @ xstar
    y = rng.normal(size=mc).astype(np.float32)
    s = np.zeros(nc, np.float32)
    s[3:] = rng.random(nc - 3).astype(np.float32) + 0.1
    c = Ac.T @ y + s                       # strict complementarity
    return Ac, bc, c, xstar


def _reference_lp():
    Ac, bc, c, _ = _lp()

    class Op:
        in_shape = (Ac.shape[1],)
        out_shape = (Ac.shape[0],)
        apply = staticmethod(lambda x: jnp.asarray(Ac) @ x)
        adjoint = staticmethod(lambda u: jnp.asarray(Ac).T @ u)

    x, _, _ = jt.solve_smoothed_lp(
        jnp.asarray(c), Op, jnp.asarray(bc), mu=1e-2, continuations=6,
        opts=jt.TfocsOptions(max_iters=500, backtracking=True, restart=True))
    return np.asarray(x)


@pytest.mark.parametrize("operator", ["plain", "rowmatrix"])
def test_smoothed_lp_kkt_and_reference(operator):
    Ac, bc, c, xstar = _lp()
    if operator == "plain":
        At = torch.from_numpy(Ac)

        class Op:
            in_shape = (Ac.shape[1],)
            out_shape = (Ac.shape[0],)
            device = torch.device("cpu")
            apply = staticmethod(lambda x: At @ x)
            adjoint = staticmethod(lambda u: At.T @ u)

        op, cc, bb = Op, torch.from_numpy(c), torch.from_numpy(bc)
    else:
        op, cc, bb = LinopMatrix(RowMatrix.create(Ac, device="cpu")), c, bc
    x, lam, info = solve_smoothed_lp(
        cc, op, bb, mu=1e-2, continuations=6,
        opts=TfocsOptions(max_iters=500, backtracking=True, restart=True))
    kkt = info["kkt"]
    assert all(isinstance(v, float) for v in kkt.values())
    assert kkt["primal_feasibility"] < 1e-2
    assert kkt["nonneg_violation"] == 0.0
    np.testing.assert_allclose(x.numpy(), xstar, atol=0.05)
    np.testing.assert_allclose(x.numpy(), _reference_lp(), atol=0.05)
    np.testing.assert_allclose(kkt["objective"], float(c @ xstar), rtol=1e-2)
    assert lam.shape == (Ac.shape[0],) and lam.device.type == "cpu"
    assert len(info["continuations"]) == 6
    assert all(i["plan"] == "cached" for i in info["continuations"])


def test_smoothed_lp_lives_on_the_operators_device():
    Ac, bc, c, _ = _lp()
    op = LinopMatrix(RowMatrix.create(Ac, device="cpu"))
    x, lam, _ = solve_smoothed_lp(c, op, bc, continuations=1,
                                  opts=TfocsOptions(max_iters=5))
    assert x.device == lam.device == op.device
    assert x.dtype == lam.dtype == torch.float32


def test_smoothed_lp_needs_the_operators_device():
    """The device is the operator's, never taken from c or assumed."""
    Ac, bc, c, _ = _lp()
    At = torch.from_numpy(Ac)

    class Op:
        in_shape = (Ac.shape[1],)
        out_shape = (Ac.shape[0],)
        apply = staticmethod(lambda x: At @ x)
        adjoint = staticmethod(lambda u: At.T @ u)

    with pytest.raises(ValueError, match="no device"):
        solve_smoothed_lp(torch.from_numpy(c), Op, torch.from_numpy(bc),
                          continuations=1, opts=TfocsOptions(max_iters=5))


def test_logloss_and_huber_l1_compose():
    """SmoothSum of a row-separable smooth and a regularizer is not
    row-separable: the engines fall back to apply + adjoint."""
    from repro_torch.core.tfocs import row_separable
    y = torch.from_numpy(np.sign(_vec(8, 10)))
    s = SmoothSum((SmoothLogLoss(y), SmoothHuberL1(0.1)))
    assert row_separable(s) is None
    z = torch.from_numpy(_vec(9, 10))
    torch.testing.assert_close(
        s.value(z), SmoothLogLoss(y).value(z) + SmoothHuberL1(0.1).value(z))
