"""The port's TFOCS engines against the reference's, on the CPU.

Problems are made with numpy from a seed and cross through
``repro_torch.convert``.  Both sides run the same engine with the same
options (``fused`` and ``precision`` set explicitly: the port has no
planner).  The θ ≡ 1 fused engine (`gra`) makes the same decisions on both
sides, so its iteration and A-pass counts must be equal.  The backtracking
engines test ``f⁺ ≤ rhs`` on values that agree only to float32 rounding, so
they may take other paths to the optimum; there x and the objective are
compared at convergence.  The port counts A-passes at run time, so a
CountingLinop's total equals ``info["a_passes"]``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core.optim.first_order import \
    minimize_first_order as j_minimize
from repro.core.tfocs import linop as jlinop
from repro.core.tfocs import prox as jprox
from repro.core.tfocs import smooth as jsmooth
from repro.core.tfocs import solver as jsolver
from repro_torch import convert
from repro_torch.core.optim import METHODS, minimize_first_order
from repro_torch.core.tfocs import (CountingLinop, LinopIdentity,
                                    LinopMatrix, ProxBox, ProxL1, ProxL2Sq,
                                    ProxNonneg, ProxZero, SmoothHuber,
                                    SmoothLogLoss, SmoothPoisson, SmoothQuad,
                                    TfocsOptions, fused_gradient_enabled,
                                    tfocs)
from repro_torch.core.tfocs import solver as tsolver
from repro_torch.core.distmat import RowMatrix

M, N = 160, 20

SMOOTH = {
    "quad": (lambda b, w: SmoothQuad(b, weights=w),
             lambda b, w: jsmooth.SmoothQuad(b, weights=w)),
    "logistic": (lambda b, w: SmoothLogLoss(b, weights=w),
                 lambda b, w: jsmooth.SmoothLogLoss(b, weights=w)),
    "huber": (lambda b, w: SmoothHuber(b, delta=0.5, weights=w),
              lambda b, w: jsmooth.SmoothHuber(b, delta=0.5, weights=w)),
    "poisson": (lambda b, w: SmoothPoisson(b, weights=w),
                lambda b, w: jsmooth.SmoothPoisson(b, weights=w)),
}


def _problem(loss, seed=0):
    """(A, b, Lipschitz bound of the smooth part) with a finite optimum:
    noisy labels for logistic, counts for poisson."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(M, N)) / np.sqrt(N)).astype(np.float32)
    xt = rng.normal(size=N).astype(np.float32)
    z = a @ xt
    if loss == "logistic":
        b = np.where(z + rng.normal(size=M) > 0, 1.0, -1.0)
    elif loss == "poisson":
        b = rng.poisson(np.exp(0.3 * z))
    else:
        b = z + 0.3 * rng.normal(size=M)
    L = float(np.linalg.norm(a, 2) ** 2)
    return a, b.astype(np.float32), {"logistic": 0.25 * L,
                                     "poisson": 2.0 * L}.get(loss, L)


def _both(loss, seed=0):
    """Reference and port (linop, smooth) over the same problem."""
    a, b, L = _problem(loss, seed)
    ref_A = JRowMatrix.create(jnp.asarray(a))
    port_A = convert.rowmatrix_from_numpy(np.asarray(ref_A.rows),
                                          ref_A.n_rows, device="cpu")
    mk, jmk = SMOOTH[loss]
    ref_lin = jlinop.LinopMatrix(ref_A)
    port_lin = LinopMatrix(port_A)
    ref_s = jmk(ref_lin.pad_data(jnp.asarray(b)), ref_lin.row_weights())
    port_s = mk(port_lin.pad_data(convert.vector_from_numpy(b,
                                                            device="cpu")),
                port_lin.row_weights())
    return (ref_lin, ref_s), (port_lin, port_s), L


def _run(method, loss, *, fused, tol, max_iters=400, seed=0, prox=None):
    (rl, rs), (pl, ps), L = _both(loss, seed)
    kw = dict(max_iters=max_iters, tol=tol, L0=L, fused=fused,
              precision="f32")
    counting = CountingLinop(pl)
    jp, tp = prox if prox is not None else (jprox.ProxZero(), ProxZero())
    jx, jinfo = j_minimize(method, rs, rl, jp,
                           x0=jnp.zeros(N, jnp.float32),
                           opts=jsolver.TfocsOptions(**kw))
    x, info = minimize_first_order(method, ps, counting, tp,
                                   x0=torch.zeros(N),
                                   opts=TfocsOptions(**kw))
    assert info["a_passes"] == counting.total()
    return (np.asarray(jx), jinfo), (x.numpy(), info)


def _same_answer(ref, port, *, x_tol, f_tol=1e-5):
    (jx, jinfo), (x, info) = ref, port
    assert info["plan"] == jinfo["plan"]
    np.testing.assert_allclose(info["objective"].item(),
                               float(jinfo["objective"]), rtol=f_tol)
    scale = max(1.0, float(np.linalg.norm(jx)))
    assert np.linalg.norm(x - jx) / scale <= x_tol


@pytest.mark.parametrize("loss", sorted(SMOOTH))
def test_gra_fused_matches_reference_step_for_step(loss):
    ref, port = _run("gra", loss, fused=True, tol=1e-5)
    (jx, jinfo), (x, info) = ref, port
    assert info["plan"] == "fused"
    assert info["iterations"] == int(jinfo["iterations"])
    assert info["a_passes"] == int(jinfo["a_passes"]) == info["iterations"] + 1
    assert info["converged"] == bool(jinfo["converged"])
    k = info["iterations"]
    np.testing.assert_allclose(info["history"][:k].numpy(),
                               np.asarray(jinfo["history"])[:k], rtol=1e-5)
    _same_answer(ref, port, x_tol=1e-5)


@pytest.mark.parametrize("method", ["acc", "acc_r", "acc_b", "acc_rb"])
def test_accelerated_quad_takes_the_affine_engine(method):
    ref, port = _run(method, "quad", fused=True, tol=1e-7)
    _, info = port
    assert info["plan"] == "fused_affine"
    assert info["a_passes"] == (2 + info["iterations"]
                                + info["n_backtracks"])
    _same_answer(ref, port, x_tol=1e-4)


@pytest.mark.parametrize("method,loss", [("gra", "quad"), ("acc", "quad"),
                                         ("acc_rb", "quad"),
                                         ("acc_rb", "logistic"),
                                         ("acc_b", "huber")])
def test_cached_engine_matches_reference(method, loss):
    fused = False if loss == "quad" else "auto"
    ref, port = _run(method, loss, fused=fused, tol=1e-7, max_iters=600)
    _, info = port
    assert info["plan"] == "cached"
    assert info["a_passes"] == 1 + 2 * (info["iterations"]
                                        + info["n_backtracks"])
    _same_answer(ref, port, x_tol=1e-3)


def test_gra_with_l1_prox_matches_reference():
    prox = (jprox.ProxL1(2.0), ProxL1(2.0))
    ref, port = _run("gra", "quad", fused=True, tol=1e-5, prox=prox)
    assert port[1]["iterations"] == int(ref[1]["iterations"])
    _same_answer(ref, port, x_tol=1e-5)
    assert (port[0] == 0).sum() == (ref[0] == 0).sum() > 0


def test_local_matrix_linop_matches_rowmatrix():
    a, b, L = _problem("quad", seed=3)
    bt = torch.from_numpy(b)
    opts = TfocsOptions(max_iters=200, tol=1e-6, L0=L, accel=False,
                        backtracking=False, Lexact=L, fused=True,
                        precision="f32")
    x1, i1 = tfocs(SmoothQuad(bt), LinopMatrix(torch.from_numpy(a)),
                   ProxZero(), torch.zeros(N), opts)
    rm = convert.rowmatrix_from_numpy(a, M, device="cpu")
    x2, i2 = tfocs(SmoothQuad(bt), LinopMatrix(rm), ProxZero(),
                   torch.zeros(N), opts)
    assert i1["iterations"] == i2["iterations"]
    torch.testing.assert_close(x1, x2, rtol=1e-6, atol=1e-6)


def test_fused_gate_and_precision():
    _, (lin, s), _ = _both("quad")
    assert fused_gradient_enabled(s, lin, "auto")
    assert not fused_gradient_enabled(s, lin, False)
    assert not fused_gradient_enabled(s, lin, "auto", needs_theta_one=True,
                                      accel=True)
    assert not fused_gradient_enabled(s, LinopIdentity(4, "cpu"), "auto")
    with pytest.raises(ValueError, match="row-separable"):
        fused_gradient_enabled(object(), lin, True)
    with pytest.raises(ValueError, match="fused must be"):
        fused_gradient_enabled(s, lin, "yes")
    # "auto" asks the planner: a small operand stays f32 at any tol (the
    # savings floor); explicit values pass through; bf16 runs
    # (tests/test_torch_precision.py), and psum8 on a RowMatrix gives the
    # θ ≡ 1 engine the zeroed residual of its int8 wire (f32 elsewhere and
    # on a local operand, as in the reference).
    for prec in ("auto", "f32"):
        assert tsolver.resolve_precision(
            lin, TfocsOptions(precision=prec, tol=1e-3)) == "f32"
    for prec in ("bf16", "psum8"):
        assert tsolver.resolve_precision(
            lin, TfocsOptions(precision=prec)) == prec
    rm_lin = LinopMatrix(RowMatrix.create(torch.zeros(4, 2), device="cpu"))
    op, prec, res = tsolver.store_precision(rm_lin, "psum8", wire=True)
    assert op is rm_lin and prec == "psum8"
    assert res.shape == (1, 2) and not res.any()
    assert tsolver.store_precision(rm_lin, "psum8", wire=False)[1:] == \
        ("f32", None)
    assert tsolver.store_precision(LinopMatrix(torch.zeros(4, 2)), "psum8",
                                   wire=True)[1:] == ("f32", None)
    assert jsolver.resolve_precision(
        jlinop.LinopMatrix(JRowMatrix.create(jnp.zeros((4, 2)))),
        jsolver.TfocsOptions(precision="psum8")) == "psum8"
    with pytest.raises(ValueError, match="precision must be"):
        tsolver.resolve_precision(lin, TfocsOptions(precision="f16"))


def test_methods_and_lbfgs():
    assert METHODS == ("gra", "acc", "acc_r", "acc_b", "acc_rb", "lbfgs")
    _, (lin, s), _ = _both("quad")
    # lbfgs runs core/optim/lbfgs (tests/test_torch_lbfgs.py).
    _, info = minimize_first_order("lbfgs", s, lin,
                                   opts=TfocsOptions(max_iters=3))
    assert info["plan"] == "fused" and info["iterations"] == 3
    with pytest.raises(ValueError, match="method must be"):
        minimize_first_order("sgd", s, lin)
    # x0 defaults to zeros on the operator's device.
    x, info = minimize_first_order("gra", s, lin,
                                   opts=TfocsOptions(max_iters=3, L0=10.0))
    assert x.shape == (N,) and info["iterations"] == 3


@pytest.mark.parametrize("loss", sorted(SMOOTH))
def test_smooth_value_and_grad_match_reference(loss):
    rng = np.random.default_rng(11)
    z = rng.normal(size=50).astype(np.float32)
    b = _problem(loss)[1][:50]
    w = rng.random(50).astype(np.float32)
    mk, jmk = SMOOTH[loss]
    for weights in (None, w):
        s = mk(torch.from_numpy(b),
               None if weights is None else torch.from_numpy(weights))
        js = jmk(jnp.asarray(b), None if weights is None
                 else jnp.asarray(weights))
        np.testing.assert_allclose(s.value(torch.from_numpy(z)).item(),
                                   float(js.value(jnp.asarray(z))),
                                   rtol=1e-6)
        np.testing.assert_allclose(s.grad(torch.from_numpy(z)).numpy(),
                                   np.asarray(js.grad(jnp.asarray(z))),
                                   rtol=1e-6, atol=1e-7)
        assert s.as_row_separable().kind == js.as_row_separable().kind


PROX = [(ProxZero(), jprox.ProxZero()), (ProxL1(0.3), jprox.ProxL1(0.3)),
        (ProxL2Sq(0.7), jprox.ProxL2Sq(0.7)),
        (ProxNonneg(), jprox.ProxNonneg()),
        (ProxBox(-0.5, 0.25), jprox.ProxBox(-0.5, 0.25))]


@pytest.mark.parametrize("i", range(len(PROX)))
def test_prox_matches_reference(i):
    port, ref = PROX[i]
    x = np.random.default_rng(i).normal(size=40).astype(np.float32)
    np.testing.assert_allclose(port.prox(torch.from_numpy(x), 0.4).numpy(),
                               np.asarray(ref.prox(jnp.asarray(x), 0.4)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.value(torch.from_numpy(x)).item(),
                               float(ref.value(jnp.asarray(x))), rtol=1e-6)


def test_counting_linop_counts_every_pass():
    _, (lin, s), _ = _both("quad")
    c = CountingLinop(lin)
    c.apply(torch.zeros(N))
    c.adjoint(torch.zeros(M))
    c.fused_grad(torch.zeros(N), s.as_row_separable())
    c.fused_grad_multi(torch.zeros(2, N), [s.as_row_separable()] * 2)
    assert c.counts == {"apply": 1, "adjoint": 1, "fused_grad": 1,
                        "fused_grad_multi": 1}
    assert c.total() == 4
    assert c.in_shape == (N,) and c.out_shape == (M,)
