"""The port's L-BFGS (core/optim/lbfgs) against the reference's, on the CPU.

Problems are made with numpy from a seed and cross through
``repro_torch.convert``.  The Armijo line search tests values that agree
only to float32 rounding, so the two sides may take other paths near the
optimum; x is compared at convergence, to 1e-4 normwise relative.  The port
counts A-passes at run time: a CountingLinop's total equals
``info["a_passes"]``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core.tfocs import linop as jlinop
from repro.core.tfocs import smooth as jsmooth
from repro.core.tfocs import solver as jsolver
from repro_torch import api, convert
from repro_torch.core.optim import minimize_first_order
from repro_torch.core.tfocs import (CountingLinop, LinopMatrix, ProxL1,
                                    SmoothHuber, SmoothLogLoss,
                                    SmoothPoisson, SmoothQuad, TfocsOptions)

# The packages export a function named like the module; take the modules.
jlbfgs = importlib.import_module("repro.core.optim.lbfgs")
lbfgs = importlib.import_module("repro_torch.core.optim.lbfgs")

M, N = 131, 17
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


def _data(loss, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(M, N)) / np.sqrt(N)).astype(np.float32)
    z = a @ rng.normal(size=N)
    if loss == "logistic":
        b = np.where(z + rng.normal(size=M) > 0, 1.0, -1.0)
    elif loss == "poisson":
        b = rng.poisson(np.exp(0.3 * z))
    else:
        b = z + 0.3 * rng.normal(size=M)
    return a, b.astype(np.float32)


def _both(loss, seed=0):
    a, b = _data(loss, seed)
    ref_A = JRowMatrix.create(jnp.asarray(a))
    port_A = convert.rowmatrix_from_numpy(np.asarray(ref_A.rows),
                                          ref_A.n_rows, device="cpu")
    mk, jmk = SMOOTH[loss]
    rl, pl = jlinop.LinopMatrix(ref_A), LinopMatrix(port_A)
    rs = jmk(rl.pad_data(jnp.asarray(b)), rl.row_weights())
    ps = mk(pl.pad_data(convert.vector_from_numpy(b, device="cpu")),
            pl.row_weights())
    return (rl, rs), (pl, ps)


def _rel(x, ref):
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(np.asarray(x, np.float64) - ref) / max(
        1.0, np.linalg.norm(ref))


@pytest.mark.parametrize("loss", sorted(SMOOTH))
def test_lbfgs_composite_matches_reference(loss):
    (rl, rs), (pl, ps) = _both(loss, seed=len(loss))
    kw = dict(max_iters=300, tol=1e-5, fused=True, precision="f32")
    jx, jinfo = jlbfgs.lbfgs_composite(rs, rl, None, jnp.zeros(N),
                                       jsolver.TfocsOptions(**kw))
    counting = CountingLinop(pl)
    x, info = lbfgs.lbfgs_composite(ps, counting, None, torch.zeros(N),
                                    TfocsOptions(**kw))
    assert info["plan"] == jinfo["plan"] == "fused"
    assert info["a_passes"] == info["n_evals"] == counting.total() \
        == counting.counts["fused_grad"]
    assert info["converged"] and bool(jinfo["converged"])
    assert info["precision"] == "f32"
    assert _rel(x.numpy(), jx) <= 1e-4
    np.testing.assert_allclose(float(info["objective"]),
                               float(jinfo["objective"]), rtol=1e-5)


def test_lbfgs_unfused_takes_two_passes_per_evaluation():
    (rl, rs), (pl, ps) = _both("logistic", seed=3)
    counting = CountingLinop(pl)
    opts = TfocsOptions(max_iters=300, tol=1e-6, fused=False)
    x, info = lbfgs.lbfgs_composite(ps, counting, opts=opts)
    assert info["plan"] == "two-pass"
    assert info["a_passes"] == 2 * info["n_evals"] == counting.total()
    assert counting.counts["apply"] == counting.counts["adjoint"] \
        == info["n_evals"]
    jx, _ = jlbfgs.lbfgs_composite(
        rs, rl, opts=jsolver.TfocsOptions(max_iters=300, tol=1e-6,
                                          fused=False, precision="f32"))
    assert _rel(x.numpy(), jx) <= 1e-4


def test_two_loop_matches_reference():
    rng = np.random.default_rng(4)
    mem = 5
    S = rng.normal(size=(mem, N)).astype(np.float32)
    Y = (S + 0.3 * rng.normal(size=(mem, N))).astype(np.float32)
    rho = (1.0 / np.sum(S * Y, axis=1)).astype(np.float32)
    g = rng.normal(size=N).astype(np.float32)
    for idx, filled in ((0, 0), (2, 2), (3, 5), (1, 5)):
        want = jlbfgs._two_loop(jnp.asarray(g), jnp.asarray(S),
                                jnp.asarray(Y), jnp.asarray(rho),
                                jnp.int32(idx), jnp.int32(filled))
        got = lbfgs._two_loop(torch.from_numpy(g), torch.from_numpy(S),
                              torch.from_numpy(Y), torch.from_numpy(rho),
                              idx, filled)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_lbfgs_needs_a_smooth_objective():
    _, (pl, ps) = _both("quad")
    with pytest.raises(ValueError, match="smooth objective"):
        lbfgs.lbfgs_composite(ps, pl, ProxL1(0.1))
    with pytest.raises(ValueError, match="smooth objective"):
        minimize_first_order("lbfgs", ps, pl, ProxL1(0.1))


def test_minimize_first_order_routes_lbfgs():
    (rl, rs), (pl, ps) = _both("huber", seed=5)
    x, info = minimize_first_order("lbfgs", ps, pl,
                                   opts=TfocsOptions(max_iters=200, tol=1e-6))
    assert info["plan"] == "fused" and info["iterations"] > 0
    k = info["iterations"]
    hist = info["history"][:k].numpy()
    assert np.all(np.isfinite(hist)) and hist[-1] <= hist[0]
    assert np.all(np.isnan(info["history"][k:].numpy()))


@pytest.mark.parametrize("loss", ["quad", "logistic"])
def test_api_solve_lbfgs_matches_reference(loss):
    a, b = _data(loss, seed=7)
    kw = dict(A=a, b=b, loss=loss, method="lbfgs", tol=1e-6, max_iters=300,
              precision="f32")
    want = japi.solve(japi.SolveRequest(**kw), fused=True)
    got = api.solve(api.SolveRequest(device="cpu", **kw), fused=True)
    assert got.info["plan"] == "fused" and got.info["degraded"] is None
    assert _rel(got.x.numpy(), want.x) <= 1e-4
    for key in ("iterations", "a_passes", "converged", "plan"):
        assert key in got.info
    with pytest.raises(ValueError, match="needs reg='none'"):
        api.solve(api.SolveRequest(device="cpu", reg="l1", lam=0.1,
                                   **dict(kw, precision="auto")))
