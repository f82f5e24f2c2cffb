"""The port's request-batched pieces against the JAX reference, on the CPU:
the fused_grad_multi dispatch, the batch input resolution, the linops, and
the gra / acc / acc_rb / lbfgs group engines of core/optim/batched.

Inputs come from numpy seeds at small ragged sizes (m = 131, n = 17).  The
kernel parity runs the reference through its Pallas kernel in interpret
mode (``force_pallas=True``) at tests/test_fusedgrad.py's tolerances:
1e-5 for f, 1e-4 for g and z.  Each engine runs its seed and ten steps from
the same numpy state through both packages; the iterates agree to 1e-5, the
carried values and gradients to 1e-4 (normwise, relative to max(1, ‖·‖)),
and every step takes the same number of group A-passes.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core.distmat import types as jtypes
from repro.core.optim import batched as jbatched
from repro.core.tfocs import linop as jlinop
from repro.core.tfocs import smooth as jsmooth
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core.distmat import types as ttypes
from repro_torch.core.optim import batched
from repro_torch.core.tfocs import (CountingLinop, LinopMatrix, SmoothHuber,
                                    SmoothQuad)
from repro_torch.kernels import fusedgrad, ops

M, N = 131, 17
DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}


def _t(arr):
    return convert.tensor_from_numpy(arr, device="cpu")


def _targets(rng, loss, shape):
    if loss == "logistic":
        return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)
    if loss == "poisson":
        return rng.poisson(1.0, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# -- the kernel dispatch ------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 8, 40])
@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_grad_multi_matches_pallas(dtype, loss, k):
    rng = np.random.default_rng(k * 10 + len(loss))
    a = (rng.normal(size=(M, N)) / np.sqrt(N)).astype(DTYPES[dtype])
    x = rng.normal(size=(k, N)).astype(np.float32)
    t = _targets(rng, loss, (k, M))
    w = rng.random((k, M)).astype(np.float32)
    w[-1, -(M // 4):] = 0.0
    jf, jg, jz = jops.fused_grad_multi(jnp.asarray(a), jnp.asarray(x),
                                       jnp.asarray(t), jnp.asarray(w),
                                       loss=loss, param=0.5,
                                       force_pallas=True)
    f, g, z = ops.fused_grad_multi(_t(a), _t(x), _t(t), _t(w), loss=loss,
                                   param=0.5)
    assert f.shape == (k,) and g.shape == (k, N) and z.shape == (k, M)
    assert f.dtype == g.dtype == z.dtype == torch.float32
    _close(f, jf, 1e-5)
    _close(g, jg, 1e-4)
    _close(z, jz, 1e-4)


def test_fused_grad_multi_rows_are_single_rhs_gradients():
    """Slot s of the batched call is the single-request fused_grad of slot
    s; a zero-weight slot gives exactly zero f and g."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(M, N)).astype(np.float32)
    x, t = rng.normal(size=(4, N)), rng.normal(size=(4, M))
    w = rng.random((4, M))
    w[3] = 0.0
    x, t, w = (_t(v.astype(np.float32)) for v in (x, t, w))
    f, g, z = ops.fused_grad_multi(_t(a), x, t, w, loss="huber", param=0.3)
    for s in range(4):
        fs, gs, zs = ops.fused_grad(_t(a), x[s], t[s], w[s], loss="huber",
                                    param=0.3)
        _close(f[s], fs, 1e-5)
        _close(g[s], gs, 1e-5)
        _close(z[s], zs, 1e-5)
    assert float(f[3]) == 0.0 and bool((g[3] == 0).all())
    assert ops.fused_grad_multi(_t(a), x.double(), t, w,
                                loss="quad")[1].dtype == torch.float64
    with pytest.raises(ValueError, match="loss must be one of"):
        ops.fused_grad_multi(_t(a), x, t, w, loss="hinge")


# -- batch input resolution and the linops ------------------------------------

def test_row_separable_batch_inputs_match_reference():
    rng = np.random.default_rng(5)
    bs = [rng.normal(size=M - 3).astype(np.float32) for _ in range(3)]
    w = rng.random(M - 3).astype(np.float32)
    mask = np.ones(M, np.float32)
    mask[-3:] = 0.0
    jseps = [jsmooth.SmoothQuad(jnp.asarray(b)) for b in bs[:2]] \
        + [jsmooth.SmoothQuad(jnp.asarray(bs[2]), weights=jnp.asarray(w))]
    tseps = [SmoothQuad(_t(b)) for b in bs[:2]] \
        + [SmoothQuad(_t(bs[2]), weights=_t(w))]
    want = jtypes.row_separable_batch_inputs(jseps, M,
                                             lambda: jnp.asarray(mask))
    got = ttypes.row_separable_batch_inputs(tseps, M, lambda: _t(mask))
    assert got[0] == want[0] == "quad" and got[3] == want[3] == 1.0
    _close(got[1], want[1], 0)
    _close(got[2], want[2], 0)
    # One smooth with stacked 2-D targets and no weights: the mask per row.
    stacked = ttypes.row_separable_batch_inputs(
        SmoothQuad(_t(np.stack(bs))), M, lambda: _t(mask))
    _close(stacked[1], want[1], 0)
    _close(stacked[2], np.stack([mask] * 3), 0)
    with pytest.raises(ValueError, match="one loss kind/param"):
        ttypes.row_separable_batch_inputs(
            [SmoothQuad(_t(bs[0])), SmoothHuber(_t(bs[1]), delta=0.5)], M,
            lambda: _t(mask))
    with pytest.raises(ValueError, match="one loss kind/param"):
        ttypes.row_separable_batch_inputs(
            [SmoothHuber(_t(bs[0]), delta=0.2),
             SmoothHuber(_t(bs[1]), delta=0.5)], M, lambda: _t(mask))


def test_rowmatrix_and_linop_fused_grad_multi_match_reference():
    """A RowMatrix carried over with padding rows: the padding takes the
    row mask on both sides; the CountingLinop counts one pass a call."""
    rng = np.random.default_rng(6)
    a = rng.normal(size=(M, N)).astype(np.float32)
    ref = JRowMatrix.create(jnp.asarray(a))
    rows = np.concatenate([np.asarray(ref.rows), np.zeros((5, N), np.float32)])
    port = convert.rowmatrix_from_numpy(rows, M, device="cpu")
    ref = JRowMatrix(rows=jnp.asarray(rows), n_rows=M, mesh=ref.mesh,
                     row_axes=ref.row_axes)
    x = rng.normal(size=(3, N)).astype(np.float32)
    bs = [rng.normal(size=M).astype(np.float32) for _ in range(3)]
    jl, tl = jlinop.LinopMatrix(ref), CountingLinop(LinopMatrix(port))
    jseps = [jsmooth.SmoothQuad(jl.pad_data(jnp.asarray(b))) for b in bs]
    tseps = [SmoothQuad(tl.pad_data(_t(b))) for b in bs]
    jf, jg, jz = jl.fused_grad_multi(jnp.asarray(x), jseps)
    f, g, z = tl.fused_grad_multi(_t(x), tseps)
    assert z.shape == (3, M + 5) and tl.counts["fused_grad_multi"] == 1
    _close(f, jf, 1e-5)
    _close(g, jg, 1e-4)
    _close(z, jz, 1e-4)
    # A plain local matrix through LinopMatrix gives the same numbers.
    f2, g2, _ = LinopMatrix(_t(a)).fused_grad_multi(
        _t(x), [SmoothQuad(_t(b)) for b in bs])
    _close(f2, f, 1e-5)
    _close(g2, g, 1e-5)


@pytest.mark.parametrize("reg", batched.REGS)
def test_prox_batch_matches_reference(reg):
    rng = np.random.default_rng(7)
    X = rng.normal(size=(4, N)).astype(np.float32)
    step = rng.random(4).astype(np.float32)
    lam = (3 * rng.random(4)).astype(np.float32)
    _close(batched.prox_batch(reg, _t(X), _t(step), _t(lam)),
           jbatched.prox_batch(reg, jnp.asarray(X), jnp.asarray(step),
                               jnp.asarray(lam)), 1e-6)
    _close(batched.prox_value_batch(reg, _t(X), _t(lam)),
           jbatched.prox_value_batch(reg, jnp.asarray(X), jnp.asarray(lam)),
           1e-5)
    with pytest.raises(ValueError, match="reg must be one of"):
        batched.prox_batch("l3", _t(X), _t(step), _t(lam))


# -- the group engines, step for step -----------------------------------------

SLOTS = 3


def _group_problem(loss, seed):
    """(a, T, W, lam, tol, active, L0 per slot): slot 2 inactive with zero
    weights; the L0s make the first steps backtrack.  The columns are
    scaled over a factor of 3.3, so ten steps stay well above the float32
    floor where an Armijo or backtracking test could fall either way."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(M, N)) / np.sqrt(N)
         * np.geomspace(1.0, 0.3, N)).astype(np.float32)
    xs = rng.normal(size=(SLOTS, N))
    z = xs @ a.T
    if loss == "logistic":
        T = np.where(z + rng.normal(size=z.shape) > 0, 1.0, -1.0)
    else:
        T = z + 0.3 * rng.normal(size=z.shape)
    W = np.ones((SLOTS, M))
    W[2] = 0.0
    L = float(np.linalg.norm(a, 2) ** 2)
    return (a, T.astype(np.float32), W.astype(np.float32),
            np.array([0.05, 0.02, 0.0], np.float32),
            np.full(SLOTS, 1e-7, np.float32), np.array([True, True, False]),
            np.array([0.3 * L, 2.0 * L, L], np.float32))


def _engines(method, loss, reg, seed):
    a, T, W, lam, tol, active, L0 = _group_problem(loss, seed)
    jl, tl = jlinop.LinopMatrix(jnp.asarray(a)), LinopMatrix(_t(a))
    if method == "gra":
        js, jst = jbatched.make_gra_group(jl, loss, reg=reg)
        ts, tst = batched.make_gra_group(tl, loss, reg=reg)
        jstate = jbatched.gra_group_init(SLOTS, N, jnp.asarray(L0))
        tstate = batched.gra_group_init(SLOTS, N, _t(L0), device="cpu")
    elif method in ("acc", "acc_rb"):
        rb = method == "acc_rb"
        js, jst = jbatched.make_acc_group(jl, loss, reg=reg,
                                          backtracking=rb, restart=rb)
        ts, tst = batched.make_acc_group(tl, loss, reg=reg,
                                         backtracking=rb, restart=rb)
        jstate = jbatched.acc_group_init(SLOTS, N, M, jnp.asarray(L0))
        tstate = batched.acc_group_init(SLOTS, N, M, _t(L0), device="cpu")
    else:
        js, jst = jbatched.make_lbfgs_group(jl, loss)
        ts, tst = batched.make_lbfgs_group(tl, loss)
        jstate = jbatched.lbfgs_group_init(SLOTS, N)
        tstate = batched.lbfgs_group_init(SLOTS, N, device="cpu")
    data = (T, W) if method == "lbfgs" else (T, W, lam)
    jargs = tuple(jnp.asarray(v) for v in data)
    targs = tuple(_t(v) for v in data)
    return ((js, jst, jstate, jargs), (ts, tst, tstate, targs),
            (tol, active))


def _same_state(tstate, jstate, fields):
    """Iterates (X, Z) agree to 1e-5 and the carried values and gradients
    to the kernel's 1e-4, normwise and relative to max(1, ‖ref‖)."""
    for name in fields:
        got = np.asarray(getattr(tstate, name), np.float64)
        want = np.asarray(getattr(jstate, name), np.float64)
        err = np.linalg.norm(got - want) / max(1.0, np.linalg.norm(want))
        assert err <= (1e-5 if name in ("X", "Z", "L") else 1e-4), (name, err)


@pytest.mark.parametrize("init,args", [
    ("gra_group_init", (2, 5, 2.0)), ("acc_group_init", (2, 5, 7, 3.0)),
    ("gra_group_init", (3, 4)), ("acc_group_init", (3, 4, 6))])
def test_group_init_takes_L0_as_the_reference_does(init, args):
    """The group-state constructors take the initial Lipschitz estimate L0
    (a float, 1.0 by default) positionally after the shapes, as the
    reference's do; every field matches the reference's."""
    want = getattr(jbatched, init)(*args)
    got = getattr(batched, init)(*args, device="cpu")
    assert got._fields == want._fields
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name


@pytest.mark.parametrize("method,loss,reg", [
    ("gra", "quad", "none"), ("gra", "quad", "l1"), ("gra", "logistic", "l2"),
    ("acc", "quad", "none"), ("acc_rb", "quad", "l1"),
    ("lbfgs", "quad", "none"), ("lbfgs", "logistic", "none")])
def test_group_engine_matches_reference_step_for_step(method, loss, reg):
    (js, jst, jstate, jargs), (ts, tst, tstate, targs), (tol, act) = \
        _engines(method, loss, reg, seed=len(method) + len(loss))
    jstate, jp = js(jstate, *jargs)
    tstate, tp = ts(tstate, *targs)
    assert tp == int(jp) == (3 if method.startswith("acc") else 1)
    fields = ["X", "F"] + (["UX", "Z", "UZ", "UB"]
                           if method.startswith("acc") else ["G"])
    _same_state(tstate, jstate, fields)
    for _ in range(10):
        jstate, jp = jst(jstate, *jargs, jnp.asarray(tol), jnp.asarray(act))
        tstate, tp = tst(tstate, *targs, _t(tol), torch.from_numpy(act))
        assert tp == int(jp)
        _same_state(tstate, jstate, fields + ["L"] * (method != "lbfgs"))
        np.testing.assert_array_equal(tstate.k.numpy(), np.asarray(jstate.k))
        np.testing.assert_array_equal(tstate.done.numpy(),
                                      np.asarray(jstate.done))
    # The inactive slot never moved.
    assert int(tstate.k[2]) == 0 and bool((tstate.X[2] == 0).all())


def test_two_loop_batch_matches_single_slot_recursion():
    from repro_torch.core.optim.lbfgs import _two_loop
    rng = np.random.default_rng(9)
    mem = 4
    S = _t(rng.normal(size=(3, mem, N)).astype(np.float32))
    Y = _t(rng.normal(size=(3, mem, N)).astype(np.float32))
    rho = _t(rng.random((3, mem)).astype(np.float32))
    G = _t(rng.normal(size=(3, N)).astype(np.float32))
    idx, filled = [1, 0, 3], [2, 0, 4]
    got = batched.two_loop_batch(G, S, Y, rho, torch.tensor(idx),
                                 torch.tensor(filled))
    for s in range(3):
        want = _two_loop(G[s], S[s], Y[s], rho[s], idx[s], filled[s])
        _close(got[s], want, 1e-5)
    _close(got[1], G[1], 0)                      # no history: H = I
