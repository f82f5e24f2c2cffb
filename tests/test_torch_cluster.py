"""The port's row-sharded cluster path on four gloo ranks, against the JAX
reference on one device.

One spawned group a mesh, (4, 1) and (2, 2), runs every case of
tests/torch_cluster_cases.py on the same numpy inputs (rows over "data";
on (2, 2) the two "model" ranks of a shard hold the same rows) and
returns each rank's results; the parametrised tests below assert them one
case at a time.  Tolerances are the reference tests' own: rtol/atol 1e-5
for f and 1e-4 for g and z (tests/test_fusedgrad.py), 1e-3 for the Gram,
the SVD and TSQR (tests/test_multidevice.py), solves compared at
convergence (ROADMAP queue 3), chunked bodies against eager within
tolerance, not bit for bit.  Replicated results must be the same bits on
every rank.  Each group has a 60 s process-group timeout and a deadline,
so a collective some rank never joins fails the run instead of hanging.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cluster_cases as C
from repro import api as japi
from repro.core import tfocs as jt
from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core.distmat import SparseRowMatrix as JSparseRowMatrix
from repro.core.linalg import compute_svd as jcompute_svd
from repro.core.linalg import tsqr as jtsqr
from repro.core.optim import make_problem as jmake_problem
from repro.core.tfocs.smooth import (SmoothHuber, SmoothLogLoss,
                                     SmoothPoisson, SmoothQuad)
from repro_torch.launch import mesh as tmesh

DATA = C.make_data()
MESHES = tuple(C.MESHES)


def _jsmooth(loss, t):
    t = jnp.asarray(t)
    return {"quad": lambda: SmoothQuad(t), "logistic": lambda: SmoothLogLoss(t),
            "huber": lambda: SmoothHuber(t, delta=0.5),
            "poisson": lambda: SmoothPoisson(t)}[loss]()


@pytest.fixture(scope="module")
def ranks():
    """{mesh name: [rank results]}: one gloo group of four CPU ranks a
    mesh (about 15 s each)."""
    return {name: tmesh.spawn(C.cluster_rank, 4, args=(name, DATA),
                              backend="gloo", device="cpu", timeout_s=60,
                              deadline_s=300)
            for name in MESHES}


@pytest.fixture(scope="module")
def ref():
    """The reference's answers on one device."""
    d, out = DATA, {}
    A = JRowMatrix.create(jnp.asarray(d["A"]))
    out["gram"] = A.gram()
    u = A.matvec(jnp.asarray(d["v"]))
    out["matvec"] = np.asarray(u)[:37]
    out["rmatvec"] = A.rmatvec(u)
    out["rmatvec_global"] = A.rmatvec(jnp.asarray(d["u"]))
    for key, val in A.column_stats().items():
        out[f"stats_{key}"] = val
    out["frobenius"] = A.frobenius_norm()
    for loss in C.LOSSES:
        f, g, z = A.fused_grad(jnp.asarray(d["x"]), _jsmooth(
            loss, C.targets(loss, d["b"], d["y"])))
        out[f"fg_{loss}_f"], out[f"fg_{loss}_g"] = f, g
        out[f"fg_{loss}_z"] = np.asarray(z)[:37]
    f, g, z = A.fused_grad_multi(jnp.asarray(d["X"]),
                                 [SmoothQuad(jnp.asarray(t)) for t in d["B"]])
    out["fgm_f"], out["fgm_g"] = f, g
    out["fgm_z"] = np.asarray(z)[:, :37]
    for mode, k in (("gram", 4), ("randomized", 3), ("lanczos", 3)):
        res = jcompute_svd(A, k, mode=mode)
        out[f"svd_{mode}"] = res
    out["tsqr"] = jtsqr(A)
    As = JRowMatrix.create(jnp.asarray(d["As"]))
    for method in C.SOLVE_METHODS:
        out[f"solve_{method}"] = japi.solve(japi.SolveRequest(
            A=As, b=d["bsol"], method=method, tol=C.SOLVE_TOL[method],
            max_iters=C.SOLVE_ITERS, L0=d["L"]))
    for prec in ("f32", "psum8"):
        out[f"prec_{prec}"] = japi.solve(japi.SolveRequest(
            A=As, b=d["bsol"], method="gra", tol=C.PSUM8_TOL,
            max_iters=C.PSUM8_ITERS, L0=d["L"], precision=prec))
    S = JSparseRowMatrix.from_dense(d["D"], bs=8)
    out["sp_ell"] = S.ell
    for loss in ("quad", "logistic"):
        f, g, z = S.fused_grad(jnp.asarray(d["xs"]), _jsmooth(
            loss, C.targets(loss, d["bs"], d["ys"])), dispatch="bsr")
        out[f"sp_{loss}"] = (f, g, np.asarray(z)[:150])
    out["sp_gram"] = S.gram()
    out["sp_rmatvec"] = S.rmatvec(jnp.asarray(d["bs"]))
    out["sp_norms"] = S.column_norms()
    out["sp_solve"] = japi.solve(japi.SolveRequest(
        A=S, b=d["bs"], method="gra", tol=C.SOLVE_TOL["gra"],
        max_iters=C.SOLVE_ITERS, L0=d["Ls"]))
    p = jmake_problem("linear", **C.PROBLEM)
    out["problem_L"] = p.L
    out["problem_x"] = japi.minimize(p, "acc_rb", max_iters=C.PROBLEM_ITERS,
                                     tol=1e-6)[0]

    class Op:
        in_shape = (d["Ac"].shape[1],)
        out_shape = (d["Ac"].shape[0],)
        apply = staticmethod(lambda x: jnp.asarray(d["Ac"]) @ x)
        adjoint = staticmethod(lambda u: jnp.asarray(d["Ac"]).T @ u)

    out["lp_x"] = jt.solve_smoothed_lp(
        jnp.asarray(d["c"]), Op, jnp.asarray(d["bc"]),
        opts=jt.TfocsOptions(max_iters=500, backtracking=True,
                             restart=True), **C.LP)[0]
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=tol, atol=tol)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _rank0(ranks, name):
    return ranks[name][0]


# -- the shards --------------------------------------------------------------

@pytest.mark.parametrize("name", MESHES)
def test_each_rank_holds_its_strip(ranks, name):
    """37 rows over the row axes: 10 a shard on (4, 1), 19 on (2, 2), where
    the two model ranks of a data shard hold the same strip."""
    nsh = C.MESHES[name][0]
    for rank, r in enumerate(ranks[name]):
        assert int(r["shard_rows"]) == -(-37 // nsh)
        assert int(r["shard"]) == rank // C.MESHES[name][1]


# -- RowMatrix methods against the reference ---------------------------------

DENSE = [("gram", 1e-3), ("gram_chunked", 1e-3), ("gram_auto", 1e-3),
         ("matvec", 1e-4), ("rmatvec", 1e-3), ("rmatvec_global", 1e-4),
         ("stats_mean", 1e-5), ("stats_variance", 1e-5),
         ("stats_min", 1e-6), ("stats_max", 1e-6),
         ("stats_num_nonzeros", 0), ("stats_norm_l2", 1e-5),
         ("frobenius", 1e-5)]


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("key,tol", DENSE)
def test_rowmatrix_method_matches_reference(ranks, ref, name, key, tol):
    _close(_rank0(ranks, name)[key], ref[key.replace("_chunked", "")
                                         .replace("_auto", "")], tol)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("loss", C.LOSSES)
def test_fused_grad_matches_reference(ranks, ref, name, loss):
    r = _rank0(ranks, name)
    _close(r[f"fg_{loss}_f"], ref[f"fg_{loss}_f"], 1e-5)
    _close(r[f"fg_{loss}_g"], ref[f"fg_{loss}_g"], 1e-4)
    _close(r[f"fg_{loss}_z"], ref[f"fg_{loss}_z"], 1e-4)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("loss", C.LOSSES)
def test_chunked_fused_grad_matches_eager(ranks, ref, name, loss):
    """chunks=4: f from the same fused pass (all_reduced alone, where
    eager sends it with g, so its sum may round apart), g a column segment
    at a time, within tolerance of eager and of the reference."""
    r = _rank0(ranks, name)
    _close(r[f"fgc_{loss}_f"], r[f"fg_{loss}_f"], 1e-6)
    _close(r[f"fgc_{loss}_g"], r[f"fg_{loss}_g"], 1e-5)
    _close(r[f"fgc_{loss}_g"], ref[f"fg_{loss}_g"], 1e-4)


@pytest.mark.parametrize("name", MESHES)
def test_fused_grad_multi_matches_reference(ranks, ref, name):
    r = _rank0(ranks, name)
    _close(r["fgm_f"], ref["fgm_f"], 1e-5)
    _close(r["fgm_g"], ref["fgm_g"], 1e-4)
    _close(r["fgm_z"], ref["fgm_z"], 1e-4)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("mode", ["gram", "randomized", "lanczos"])
def test_compute_svd_matches_reference(ranks, ref, name, mode):
    """σ within 1e-3 (tests/test_multidevice.py), the rank-k factors'
    product U Σ Vᵀ within 1e-3 of the reference's (signs and Ω differ),
    and the reference's A-pass count."""
    r, res = _rank0(ranks, name), ref[f"svd_{mode}"]
    _close(r[f"svd_{mode}_s"], res.s, 1e-3)
    got = (r[f"svd_{mode}_U"] * r[f"svd_{mode}_s"]) @ r[f"svd_{mode}_V"].T
    want = (np.asarray(res.U.to_local()) * np.asarray(res.s)) \
        @ np.asarray(res.V).T
    _close(got, want, 1e-3)
    assert int(r[f"svd_{mode}_passes"]) == int(res.info["a_passes"])


@pytest.mark.parametrize("name", MESHES)
def test_tsqr_matches_reference(ranks, ref, name):
    r = _rank0(ranks, name)
    Q, R = ref["tsqr"]
    _close(r["tsqr_R"], R, 1e-3)
    _close(r["tsqr_Q"], Q.to_local(), 1e-3)
    _close(r["tsqr_Q"] @ r["tsqr_R"], DATA["A"], 1e-3)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("method", C.SOLVE_METHODS)
def test_solve_matches_reference_at_convergence(ranks, ref, name, method):
    r, want = _rank0(ranks, name), ref[f"solve_{method}"]
    assert int(r[f"solve_{method}_iters"]) < C.SOLVE_ITERS
    assert _rel(r[f"solve_{method}_x"], want.x) < 1e-4


@pytest.mark.parametrize("name", MESHES)
def test_psum8_solve_takes_the_int8_wire(ranks, ref, name):
    """gra with precision="psum8" reports it on every rank, and lands
    within 100 × tol of the f32 solve (tests/test_precision.py's bound)
    and of the reference's psum8 solve."""
    for r in ranks[name]:
        assert r["prec_psum8_reported"] == "psum8"
        assert r["prec_f32_reported"] == "f32"
    r = _rank0(ranks, name)
    assert _rel(r["prec_psum8_x"], r["prec_f32_x"]) < 100 * C.PSUM8_TOL
    assert _rel(r["prec_psum8_x"], ref["prec_psum8"].x) < 100 * C.PSUM8_TOL
    assert ref["prec_psum8"].info["precision"] == "psum8"


# -- SparseRowMatrix ----------------------------------------------------------

@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("dispatch", ["bsr", "dense"])
@pytest.mark.parametrize("loss", ["quad", "logistic"])
def test_sparse_fused_grad_matches_reference(ranks, ref, name, dispatch,
                                             loss):
    r = _rank0(ranks, name)
    f, g, z = ref[f"sp_{loss}"]
    _close(r[f"sp_{dispatch}_{loss}_f"], f, 1e-5)
    _close(r[f"sp_{dispatch}_{loss}_g"], g, 1e-4)
    _close(r[f"sp_{dispatch}_{loss}_z"], z, 1e-4)
    _close(r[f"spc_{dispatch}_{loss}_f"], r[f"sp_{dispatch}_{loss}_f"], 1e-6)
    _close(r[f"spc_{dispatch}_{loss}_g"], r[f"sp_{dispatch}_{loss}_g"], 1e-5)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("key,tol", [("sp_gram", 1e-3),
                                     ("sp_rmatvec", 1e-4),
                                     ("sp_norms", 1e-5)])
def test_sparse_method_matches_reference(ranks, ref, name, key, tol):
    r = _rank0(ranks, name)
    assert int(r["sp_ell"]) == ref["sp_ell"]
    _close(r[key], ref[key], tol)


@pytest.mark.parametrize("name", MESHES)
def test_sparse_remesh_to_two_shards(ranks, ref, name):
    """remesh onto (2, 2): 10 block-rows a strip (19 padded to 20), the
    same matrix, and its fused pass within tolerance of the reference."""
    r = _rank0(ranks, name)
    assert int(r["sp_remesh_strip"]) == 10
    np.testing.assert_array_equal(r["sp_remesh_dense"].numpy(), DATA["D"])
    f, g, _ = ref["sp_quad"]
    _close(r["sp_remesh_f"], f, 1e-5)
    _close(r["sp_remesh_g"], g, 1e-4)


@pytest.mark.parametrize("name", MESHES)
def test_sparse_solve_matches_reference(ranks, ref, name):
    r = _rank0(ranks, name)
    assert r["sp_solve_plan"] == "fused"
    assert _rel(r["sp_solve_x"], ref["sp_solve"].x) < 1e-4


@pytest.mark.parametrize("name", MESHES)
def test_rowmatrix_remesh_to_two_shards(ranks, ref, name):
    r = _rank0(ranks, name)
    assert int(r["remesh_rows"]) == 19
    np.testing.assert_array_equal(r["remesh_local"].numpy(), DATA["A"])
    _close(r["remesh_gram"], ref["gram"], 1e-3)


# -- the front doors ------------------------------------------------------------

@pytest.mark.parametrize("name", MESHES)
def test_make_problem_on_a_mesh(ranks, ref, name):
    """make_problem(mesh=): L within 1e-6 of the reference's
    (tests/test_torch_problems.py), and api.minimize's acc_rb answer at
    convergence."""
    r = _rank0(ranks, name)
    assert float(r["problem_L"]) == pytest.approx(ref["problem_L"], rel=1e-6)
    assert int(r["problem_iters"]) < C.PROBLEM_ITERS
    assert _rel(r["problem_x"], ref["problem_x"]) < 1e-4


@pytest.mark.parametrize("name", MESHES)
def test_smoothed_lp_on_a_sharded_constraint_matrix(ranks, ref, name):
    """tests/test_torch_tfocs_extras.py's bounds: x within 0.05 of x* and
    of the reference's, feasibility under 1e-2."""
    r = _rank0(ranks, name)
    np.testing.assert_allclose(r["lp_x"].numpy(), DATA["xstar"], atol=0.05)
    np.testing.assert_allclose(r["lp_x"].numpy(), np.asarray(ref["lp_x"]),
                               atol=0.05)
    assert float(r["lp_feasibility"]) < 1e-2
    nsh = C.MESHES[name][0]                # 6 constraints, padded
    assert r["lp_lam"].shape == (-(-6 // nsh) * nsh,)


@pytest.mark.parametrize("name", MESHES)
def test_collectives_have_spans_and_plan_actual_records(ranks, name):
    """Under a recorder each collective op has its span and a
    plan-vs-actual record of its psum, with its chunk count and wire."""
    r = _rank0(ranks, name)
    assert r["tel_spans"] == ["collective.fused_grad", "collective.gram",
                              "collective.rmatvec"]
    assert r["tel_plan_actual"] == [("gram", 2, None, "psum"),
                                    ("matvec", None, None, "psum"),
                                    ("grad", 1, "f32", "psum")]


@pytest.mark.parametrize("name", MESHES)
def test_indexed_row_matrix_on_a_mesh(ranks, ref, name):
    """IndexedRowMatrix shards its indices with its rows: to_local places
    the gathered rows at their indices, as the reference's does."""
    from repro.core.distmat import IndexedRowMatrix as JIndexed
    r = _rank0(ranks, name)
    want = JIndexed.create(jnp.arange(37) * 2, jnp.asarray(DATA["A"]))
    np.testing.assert_array_equal(r["irm_local"].numpy(),
                                  np.asarray(want.to_local()))
    _close(r["irm_rmatvec"], ref["rmatvec_global"], 1e-4)


@pytest.mark.parametrize("name", MESHES)
def test_multi_pod_mesh_shards_rows_over_pod_and_data(ranks, ref, name):
    """A (pod=2, data=2, model=1) mesh: rows shard over the flattened
    ("pod", "data") group, rank r owning strip r; the Gram over that group
    against the reference, the gathered rows the input."""
    for rank, r in enumerate(ranks[name]):
        assert r["pod_axes"] == ["pod", "data"]
        assert int(r["pod_shard"]) == rank
    r = _rank0(ranks, name)
    _close(r["pod_gram"], ref["gram"], 1e-3)
    np.testing.assert_array_equal(r["pod_local"].numpy(), DATA["A"])


@pytest.mark.parametrize("name", MESHES)
def test_auto_chunks_asks_the_planner_with_the_row_axes(ranks, name):
    """chunks="auto" resolves through plan("grad") priced over the mesh's
    row axes (their sizes in the plan's notes); at these tiny shards the
    eager body wins."""
    r = _rank0(ranks, name)
    assert f"axes=({C.MESHES[name][0]},)" in r["auto_notes"][0]
    assert r["auto_chunks"] == 1


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("what", ["block", "coordinate", "server"])
def test_what_waits_for_the_rest_of_item_13_raises(ranks, name, what):
    """BlockMatrix and CoordinateMatrix on a mesh, and a server over a
    sharded matrix, raise and name ROADMAP queue 1 item 13."""
    assert "item 13" in _rank0(ranks, name)[f"later_{what}"]


# -- across ranks -----------------------------------------------------------------

SHARDED = {"shard", "shard_rows", "pod_shard"}
REPLICATED = sorted(k for k in C.cluster_rank_keys() if k not in SHARDED)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("key", REPLICATED)
def test_replicated_results_have_the_same_bits_on_every_rank(ranks, name,
                                                              key):
    vals = [r[key] for r in ranks[name]]
    for v in vals[1:]:
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, vals[0]), key
        else:
            assert v == vals[0], key
