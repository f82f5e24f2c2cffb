"""The port's cluster path on four gloo ranks, against the JAX reference on
one device.

One spawned group a mesh, (4, 1) and (2, 2), runs every case of
tests/torch_cluster_cases.py on the same numpy inputs (rows over "data";
on (2, 2) the two "model" ranks of a shard hold the same rows) and
returns each rank's results; the parametrised tests below assert them one
case at a time.  Beside the row-sharded RowMatrix and SparseRowMatrix:
BlockMatrix on the R × C grid (SUMMA), CoordinateMatrix sharded by entry,
SolverServer over the sharded matrices (the first rank's clock and budget
decisions followed by every rank) and accelerated ElasticGroups, clean
and through a device loss.  Tolerances are the reference tests' own: rtol/atol 1e-5
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
from repro.core.distmat import BlockMatrix as JBlockMatrix
from repro.core.distmat import CoordinateMatrix as JCoordinateMatrix
from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core.distmat import SparseRowMatrix as JSparseRowMatrix
from repro.core.linalg import compute_svd as jcompute_svd
from repro.core.linalg import tsqr as jtsqr
from repro.core.optim import elastic as jelastic
from repro.core.optim import make_problem as jmake_problem
from repro.core.tfocs.linop import LinopMatrix as JLinopMatrix
from repro.core.tfocs.smooth import (SmoothHuber, SmoothLogLoss,
                                     SmoothPoisson, SmoothQuad)
from repro.launch import serve as jserve
from repro_torch.core.distmat import (BlockMatrix, CoordinateMatrix,
                                      RowMatrix, SparseRowMatrix)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.serve import SolverServer

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
    out.update(_ref_block(d))
    out.update(_ref_coordinate(d))
    out.update(_ref_served(d))
    for method in C.ELASTIC_METHODS:
        out[f"el_{method}"] = jelastic.solve_elastic(
            JLinopMatrix(jnp.asarray(d["As"])), "quad", d["bsol"],
            method=method, L0=d["L"], **C.ELASTIC_SOLVE)
    return out


def _ref_block(d) -> dict:
    """The reference's BlockMatrix on one device: every method the rank
    bodies call, the vectors cut to their true lengths."""
    A = JBlockMatrix.create(jnp.asarray(d["Ab"]))
    B = JBlockMatrix.create(jnp.asarray(d["Bb"]))
    v, u = jnp.asarray(d["vb"]), jnp.asarray(d["ub"])
    w = jnp.pad(v, (0, A.data.shape[1] - v.shape[0]))
    return {"blk_add": A.add(A).to_local(),
            "blk_multiply": A.multiply(B).to_local(),
            "blk_transpose": A.transpose().to_local(),
            "blk_local": A.to_local(),
            "blk_matvec": np.asarray(A.matvec(v))[:20],
            "blk_rmatvec": np.asarray(A.rmatvec(u))[:11],
            "blk_matvec_model_sharded": np.asarray(
                A.matvec_model_sharded(w))[:20],
            "blk_rmatvec_model_sharded": np.asarray(
                A.rmatvec_model_sharded(u))[:11],
            "blk_frobenius": A.frobenius_norm(),
            "blk_svd_s": jcompute_svd(A, C.SVD_K).s}


def _ref_coordinate(d) -> dict:
    """The reference's CoordinateMatrix on one device."""
    cm = JCoordinateMatrix.create(jnp.asarray(d["ri"]), jnp.asarray(d["ci"]),
                                  jnp.asarray(d["va"]), (20, 13))
    srm = cm.to_sparse_row_matrix(bs=8)
    return {"coo_matvec": cm.matvec(jnp.asarray(d["xc"])),
            "coo_rmatvec": cm.rmatvec(jnp.asarray(d["yc"])),
            "coo_frobenius": cm.frobenius_norm(),
            "coo_local": cm.to_local(),
            "coo_transpose": cm.transpose().to_local(),
            "coo_irm_local": np.asarray(
                cm.to_indexed_row_matrix().to_local()),
            "coo_srm_local": srm.to_local(), "coo_srm_ell": srm.ell,
            "coo_block_local": cm.to_block_matrix(4, 4).to_local(),
            "coo_svd_s": jcompute_svd(cm, C.SVD_K).s,
            "coo_wide_svd_s": jcompute_svd(cm.transpose(), C.SVD_K).s}


def _ref_served(d) -> dict:
    """The reference's server on one device, one group a method: the
    served x of each request (gra, acc and acc_rb on As, gra on D)."""
    out = {}
    for name, A, method, sparse in (
            *((m, JRowMatrix.create(jnp.asarray(d["As"])), m, False)
              for m in C.SERVE_METHODS),
            ("sparse", JSparseRowMatrix.from_dense(d["D"], bs=8), "gra",
             True)):
        B, L = (d["Bsparse"], d["Ls"]) if sparse else (d["Bserve"], d["L"])
        srv = jserve.SolverServer(slots=len(B))
        ids = [srv.submit(japi.SolveRequest(
            A=A, b=b, method=method, tol=C.SERVE_TOL,
            max_iters=C.SERVE_ITERS, L0=L)) for b in B]
        srv.run()
        out[f"serve_{name}"] = np.stack([np.asarray(srv.result(i).x)
                                         for i in ids])
    return out


@pytest.fixture(scope="module")
def one_rank():
    """The port on one device (no mesh): the BlockMatrix product and the
    served answers the meshes are held to."""
    d, out = DATA, {}
    blk = BlockMatrix.create(d["Ab"], device="cpu")
    out["blk_multiply"] = blk.multiply(
        BlockMatrix.create(d["Bb"], device="cpu")).to_local()
    out["blk_matvec"] = blk.matvec(torch.as_tensor(d["vb"]))
    out["blk_rmatvec"] = blk.rmatvec(torch.as_tensor(d["ub"]))
    coo = CoordinateMatrix.create(d["ri"], d["ci"], d["va"], (20, 13),
                                  device="cpu")
    out["coo_matvec"] = coo.matvec(torch.as_tensor(d["xc"]))
    out["coo_rmatvec"] = coo.rmatvec(torch.as_tensor(d["yc"]))
    rm = RowMatrix.create(d["As"], device="cpu")
    S = SparseRowMatrix.from_dense(d["D"], bs=8, device="cpu")
    for name, A, method, sparse in (
            *((m, rm, m, False) for m in C.SERVE_METHODS),
            ("sparse", S, "gra", True)):
        srv = SolverServer(slots=C.SERVE_K)
        ids = [srv.submit(r) for r in C.serve_requests(A, d, method, sparse)]
        srv.run()
        out[f"serve_{name}"] = torch.stack([srv.result(i).x for i in ids])
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


def _maxabs(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


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


# -- BlockMatrix by SUMMA, CoordinateMatrix over the ranks -----------------------

@pytest.mark.parametrize("name", MESHES)
def test_block_matrix_tiles_the_grid(ranks, name):
    """20 × 11 and 11 × 6 on an R × C grid: each rank holds its
    (⌈m/R⌉, ⌈n/C⌉) tile, both axes padded where they do not divide
    (validate passed on every rank)."""
    R, Cm = C.MESHES[name]
    want = [-(-20 // R), -(-11 // Cm), -(-11 // R), -(-6 // Cm)]
    for r in ranks[name]:
        assert r["blk_tile"] == want


BLOCK = [("blk_add", 1e-6), ("blk_multiply", 1e-3), ("blk_transpose", 0),
         ("blk_local", 0), ("blk_matvec", 1e-4), ("blk_rmatvec", 1e-4),
         ("blk_matvec_model_sharded", 1e-4),
         ("blk_rmatvec_model_sharded", 1e-4), ("blk_frobenius", 1e-5),
         ("blk_svd_s", 1e-3)]


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("key,tol", BLOCK)
def test_block_matrix_matches_reference(ranks, ref, name, key, tol):
    """Each BlockMatrix method on the mesh (its vectors gathered whole)
    against the reference's on one device: the product within
    tests/test_multidevice.py's 1e-3, the vector products within
    tests/test_torch_distmat_types.py's 1e-4, σ of the Lanczos SVD within
    1e-3."""
    _close(_rank0(ranks, name)[key], ref[key], tol)
    if key == "blk_svd_s":
        assert _rank0(ranks, name)["blk_svd_plan"] == "lanczos"


@pytest.mark.parametrize("name", MESHES)
def test_block_multiply_matches_one_rank(ranks, one_rank, name):
    """SUMMA's product on the mesh within 1e-5 of the port's one-rank
    gemm (the same sums, the panels gathered first)."""
    _close(_rank0(ranks, name)["blk_multiply"], one_rank["blk_multiply"],
           1e-5)


COORDINATE = [("coo_matvec", 1e-3), ("coo_rmatvec", 1e-3),
              ("coo_frobenius", 1e-5), ("coo_local", 1e-6),
              ("coo_transpose", 1e-6), ("coo_irm_local", 1e-6),
              ("coo_srm_local", 1e-6), ("coo_block_local", 1e-6),
              ("coo_svd_s", 1e-3), ("coo_wide_svd_s", 1e-3)]


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("key,tol", COORDINATE)
def test_coordinate_matrix_matches_reference(ranks, ref, name, key, tol):
    """The CoordinateMatrix's entries sharded by position: products (rtol
    1e-3, atol 1e-4, tests/test_multidevice.py), the norm, the dense,
    transposed and converted forms, and σ of its Lanczos SVD and of its
    wide transpose's, against the reference on one device."""
    got, want = _rank0(ranks, name)[key], ref[key]
    if key in ("coo_matvec", "coo_rmatvec"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-4)
    elif key == "coo_irm_local":
        _close(got, np.asarray(want)[: got.shape[0]], tol)
    else:
        _close(got, want, tol)


@pytest.mark.parametrize("name", MESHES)
def test_coordinate_matrix_shards_its_entries(ranks, ref, name):
    """60 entries over the row axes: 60/R a rank (padding none here);
    the conversions land on the same mesh: the block-sparse type's strips
    over the row shards (its ELL width the reference's), the BlockMatrix
    on the (R, C) grid; the wide SVD runs through the transpose."""
    R, Cm = C.MESHES[name]
    for r in ranks[name]:
        assert int(r["coo_local_nnz"]) == 60 // R
    r = _rank0(ranks, name)
    assert int(r["coo_srm_shards"]) == R
    assert int(r["coo_srm_ell"]) == ref["coo_srm_ell"]
    assert r["coo_block_grid"] == [R, Cm]
    assert r["coo_svd_plan"] == "lanczos" and r["coo_wide_transposed"]
    D = r["coo_local"].numpy().T
    u, s, vt = np.linalg.svd(D)
    k = C.SVD_K
    got = (r["coo_wide_svd_U"] * r["coo_wide_svd_s"]) @ r["coo_wide_svd_V"].T
    _close(got, (u[:, :k] * s[:k]) @ vt[:k], 1e-3)


# The survivors of each mesh once row shard 1 is dropped: (4, 1) leaves
# ranks 0, 2 and 3 on a (3, 1) grid, (2, 2) ranks 0 and 1 on (1, 2).
SURVIVORS = {"4x1": ([[0], [2], [3]], [3, 1]), "2x2": ([[0, 1]], [1, 2])}


@pytest.mark.parametrize("name", MESHES)
def test_survivor_mesh_keeps_the_other_row_shards(ranks, name):
    """survivor_mesh drops row shard 1's ranks: the rest make the
    survivor grid and are its members, the dropped ranks are not."""
    grid, shape = SURVIVORS[name]
    for rank, r in enumerate(ranks[name]):
        assert r["surv_grid"] == grid
        member = any(rank in row for row in grid)
        assert r["surv_member"] == member
        if member:
            assert r["surv_shape"] == shape


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("key,tol", BLOCK + COORDINATE)
def test_types_on_a_survivor_mesh_match_reference(ranks, ref, name, key,
                                                  tol):
    """BlockMatrix (SUMMA, the vector products, transpose, the norm,
    to_local, Lanczos) and CoordinateMatrix (products, conversions,
    Lanczos of it and of its transpose) on the survivor mesh, within the
    tolerances the full mesh is held to, against the reference on one
    device; the same bits on every surviving rank."""
    grid, _ = SURVIVORS[name]
    members = [ranks[name][rk] for row in grid for rk in row]
    got, want = members[0][f"surv_{key}"], ref[key]
    if key in ("coo_matvec", "coo_rmatvec"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-4)
    elif key == "coo_irm_local":
        _close(got, np.asarray(want)[: got.shape[0]], tol)
    else:
        _close(got, want, tol)
    for r in members[1:]:
        assert torch.equal(r[f"surv_{key}"], got), key


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("key", ["blk_multiply", "blk_matvec", "blk_rmatvec",
                                 "coo_matvec", "coo_rmatvec"])
def test_types_on_a_survivor_mesh_match_one_rank(ranks, one_rank, name,
                                                 key):
    """The survivor mesh's SUMMA product and vector products within 1e-5
    of the port's one-device matrices (the same sums, in other groups)."""
    _close(_rank0(ranks, name)[f"surv_{key}"], one_rank[key], 1e-5)


# -- the server over row-sharded matrices ---------------------------------------

@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("served", [*C.SERVE_METHODS, "sparse"])
def test_served_groups_match_reference_and_one_rank(ranks, ref, one_rank,
                                                    name, served):
    """gra, acc and acc_rb groups on the sharded As and a gra group on
    the sharded D: every request converged, x within 1e-4 of the
    reference's server on one device and of the port's one-rank server
    (phase 11's limit), the same bits on every rank."""
    r = _rank0(ranks, name)
    info = r[f"serve_{served}_info"]
    assert all(info["converged"]) and max(info["iterations"]) \
        < C.SERVE_ITERS
    for got, want, mine in zip(r[f"serve_{served}_x"], ref[f"serve_{served}"],
                               one_rank[f"serve_{served}"]):
        assert _rel(got, want) < 1e-4
        assert _rel(got, mine) < 1e-4
    for other in ranks[name][1:]:
        assert torch.equal(other[f"serve_{served}_x"],
                           r[f"serve_{served}_x"])


@pytest.mark.parametrize("name", MESHES)
def test_deadline_taken_by_the_first_rank_retires_everywhere(ranks, name):
    """Only the first rank's request carries a deadline: every rank
    retires it at the same step with degraded="deadline", the same
    iterate and the same group passes, and its co-resident converges."""
    infos = [r["serve_deadline_info"] for r in ranks[name]]
    for info in infos:
        assert info == infos[0]
        assert info["degraded"] == ["deadline", None]
        assert info["converged"] == [False, True]
        assert 0 < info["iterations"][0] < 10 ** 6


@pytest.mark.parametrize("name", MESHES)
def test_budget_taken_by_the_first_rank_applies_everywhere(ranks, one_rank,
                                                          name):
    """Only the first rank has a budget (one group's pass and a half):
    the second group waits for the first on every rank alike, and every
    answer converges to the one-rank server's."""
    infos = [r["serve_budget_info"] for r in ranks[name]]
    assert all(info == infos[0] for info in infos)
    assert infos[0]["stats"]["deferred_steps"] > 0
    assert all(infos[0]["converged"])
    r = _rank0(ranks, name)
    want = torch.cat([one_rank["serve_gra"][:2], one_rank["serve_acc_rb"][:2]])
    for got, mine in zip(r["serve_budget_x"], want):
        assert _rel(got, mine) < 1e-4


@pytest.mark.parametrize("name", MESHES)
def test_first_rank_alone_exports_telemetry(ranks, name):
    """export_telemetry writes the server's events on the mesh's first
    rank and nothing on the others."""
    counts = [r["serve_exported"] for r in ranks[name]]
    assert counts[0] > 0 and not any(counts[1:])


# -- accelerated elastic groups on row-sharded A ---------------------------------

@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("method", C.ELASTIC_METHODS)
def test_accelerated_elastic_group_matches_reference(ranks, ref, name,
                                                     method):
    """acc and acc_rb ElasticGroups on the sharded As: x within
    tests/test_fault_tolerance.py's 5e-4 of the reference's clean solve,
    converged, the seed's three passes and one a try; acc takes the
    reference's passes an iteration (one)."""
    r = _rank0(ranks, name)
    jx, jinfo = ref[f"el_{method}"]
    info = r[f"el_{method}_info"]
    assert info["converged"] and info["remeshes"] == 0
    assert _maxabs(r[f"el_{method}_x"], jx) < 5e-4
    if method == "acc":
        assert info["a_passes"] - info["iterations"] \
            == jinfo["a_passes"] - jinfo["iterations"] == 3
    else:
        assert info["a_passes"] >= info["iterations"] + 3


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("method", C.ELASTIC_METHODS)
def test_accelerated_elastic_group_survives_device_loss(ranks, ref, name,
                                                        method):
    """Shard 1's device lost at iteration 3: every rank re-meshes once,
    the lost shard's ranks stop (dropped), the survivors finish with the
    same bits, within 5e-4 of the reference's clean solve."""
    R, Cm = C.MESHES[name]
    lost = {i for i in range(R * Cm) if i // Cm == 1}
    jx, _ = ref[f"el_{method}"]
    rs = ranks[name]
    surv = [r for i, r in enumerate(rs) if i not in lost]
    for i, r in enumerate(rs):
        info = r[f"el_{method}_loss_info"]
        assert r[f"el_{method}_loss_casualties"] == [1]
        assert info["remeshes"] == 1
        assert bool(info["dropped"]) == (i in lost)
    for r in surv:
        assert torch.equal(r[f"el_{method}_loss_x"],
                           surv[0][f"el_{method}_loss_x"])
        assert r[f"el_{method}_loss_info"]["converged"]
    assert _maxabs(surv[0][f"el_{method}_loss_x"], jx) < 5e-4


# -- across ranks -----------------------------------------------------------------

SHARDED = {"shard", "shard_rows", "pod_shard", "serve_exported",
           *(f"el_{m}_loss_{p}" for m in C.ELASTIC_METHODS
             for p in ("x", "info"))}
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
