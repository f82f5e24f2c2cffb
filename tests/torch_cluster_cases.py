"""Rank bodies of the port's multi-rank CPU tests (tests/test_torch_cluster.py,
tests/test_torch_compression.py and tests/test_torch_fp8.py).

Each function runs on every rank of a gloo group started by
``repro_torch.launch.mesh.spawn`` and returns a dict of tensors that the
test process compares against the JAX reference on one device.  This
module imports torch and the port only (the spawned ranks never import
jax), and is not a test module itself.
"""
from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch import api, compat
from repro_torch.core.distmat import RowMatrix, SparseRowMatrix
from repro_torch.core.distmat import types as T
from repro_torch.core.tfocs.linop import LinopMatrix
from repro_torch.core.tfocs.smooth import (SmoothHuber, SmoothLogLoss,
                                           SmoothPoisson, SmoothQuad,
                                           row_separable)

LOSSES = ("quad", "logistic", "huber", "poisson")
MESHES = {"4x1": (4, 1), "2x2": (2, 2)}
SOLVE_METHODS = ("gra", "acc_rb", "lbfgs")
# gra and acc_rb stop at a relative step below 1e-9; lbfgs at
# ||g|| < tol |f|, which f32 reaches near 1e-5 on this problem.
SOLVE_TOL = {"gra": 1e-9, "acc_rb": 1e-9, "lbfgs": 1e-4}
SOLVE_ITERS = 3000
PSUM8_TOL = 1e-5
PSUM8_ITERS = 600              # tests/test_precision.py's cap
PROBLEM = dict(m=200, n=16)
PROBLEM_ITERS = 300
LP = dict(mu=1e-2, continuations=6)
# The served groups on As (quad, SERVE_K requests a method) and on D (gra,
# two requests), each to a relative step below SERVE_TOL.
SERVE_METHODS = ("gra", "acc", "acc_rb")
SERVE_K = 4
SERVE_TOL = 1e-8
SERVE_ITERS = 2000
# A deadline rank 0 alone sets (the other ranks' request has none): every
# rank retires it at the step rank 0's clock says.
DEADLINE_S = 0.05
# The accelerated elastic groups on As: clean, and shard 1's device lost
# at iteration 3 (a re-mesh onto the survivors).
ELASTIC_METHODS = ("acc", "acc_rb")
ELASTIC_SOLVE = dict(tol=1e-7, max_iters=400)
ELASTIC_LOSS = dict(lose_shard_at=3, lost_shard=1)
# Lanczos SVDs of the BlockMatrix and CoordinateMatrix cases.
SVD_K = 3


def make_data(seed: int = 0) -> dict:
    """The numpy inputs every rank and the reference share: A (37 × 11,
    tests/test_multidevice.py's shape) with its vectors, a least-squares
    problem (90 × 8), a block-sparse D (150 × 44 in 8 × 8 blocks, two a
    block-row) with its vectors, and tests/test_tfocs.py's LP."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    def labels(m):
        return np.where(rng.normal(size=m) > 0, 1.0, -1.0).astype(np.float32)

    d = dict(A=f32(37, 11), v=f32(11), b=f32(37), y=labels(37),
             x=f32(11, scale=0.3), u=f32(37), X=f32(3, 11, scale=0.3),
             B=f32(3, 37))
    As = f32(90, 8)
    d.update(As=As, bsol=(As @ rng.normal(size=8)
                          + 0.1 * rng.normal(size=90)).astype(np.float32),
             L=float(np.linalg.norm(As, 2) ** 2))
    D = np.zeros((150, 44), np.float32)
    for i in range(0, 150, 8):
        for j in rng.choice(6, 2, replace=False):
            blk = D[i:i + 8, 8 * j:8 * j + 8]
            blk[...] = rng.normal(size=blk.shape)
    d.update(D=D, xs=f32(44, scale=0.3), bs=f32(150), ys=labels(150),
             Ls=float(np.linalg.norm(D, 2) ** 2))
    lp = np.random.default_rng(7)
    mc, nc = 6, 14
    Ac = lp.normal(size=(mc, nc)).astype(np.float32)
    xstar = np.zeros(nc, np.float32)
    xstar[:3] = lp.random(3).astype(np.float32) + 0.5
    yl = lp.normal(size=mc).astype(np.float32)
    sl = np.zeros(nc, np.float32)
    sl[3:] = lp.random(nc - 3).astype(np.float32) + 0.1
    d.update(Ac=Ac, bc=Ac @ xstar, c=Ac.T @ yl + sl, xstar=xstar)
    d["Bserve"] = np.stack([
        (As @ rng.normal(size=8) + 0.1 * rng.normal(size=90))
        .astype(np.float32) for _ in range(SERVE_K)])
    d["Bsparse"] = np.stack([
        (D @ rng.normal(size=44) + 0.01 * rng.normal(size=150))
        .astype(np.float32) for _ in range(2)])
    # tests/test_multidevice.py's BlockMatrix shapes (both axes padded on
    # either mesh) and its CoordinateMatrix (60 entries on 20 × 13).
    d.update(Ab=f32(20, 11), Bb=f32(11, 6), vb=f32(11), ub=f32(20))
    blk = np.random.default_rng(3)
    d.update(ri=blk.integers(0, 20, 60), ci=blk.integers(0, 13, 60),
             va=blk.normal(size=60).astype(np.float32),
             xc=blk.normal(size=13).astype(np.float32),
             yc=blk.normal(size=20).astype(np.float32))
    return d


def smooth_for(loss: str, t, w=None):
    if loss == "quad":
        return SmoothQuad(b=t, weights=w)
    if loss == "logistic":
        return SmoothLogLoss(y=t, weights=w)
    if loss == "huber":
        return SmoothHuber(b=t, delta=0.5, weights=w)
    return SmoothPoisson(y=t, weights=w)


def targets(loss: str, b: np.ndarray, y: np.ndarray) -> np.ndarray:
    return {"quad": b, "huber": b, "logistic": y,
            "poisson": np.abs(np.round(b))}[loss]


def _whole(rm: RowMatrix, v: torch.Tensor) -> torch.Tensor:
    """A shard-sized data-space vector (or (k, m_local) stack) gathered
    to the global rows, padding cut."""
    parts = compat.all_gather(v, rm.mesh, rm.row_axes)
    if v.dim() == 1:
        return parts.reshape(-1)[: rm.n_rows]
    return parts.permute(1, 0, 2).reshape(v.shape[0], -1)[:, : rm.n_rows]


def _dense_cases(rm: RowMatrix, data: dict) -> dict:
    out = {}
    v, b, y, x = data["v"], data["b"], data["y"], data["x"]
    out["gram"] = rm.gram(chunks=1)
    out["gram_chunked"] = rm.gram(chunks=4)
    out["gram_auto"] = rm.gram()
    u = rm.matvec(torch.as_tensor(v))
    out["matvec"] = _whole(rm, u)
    out["rmatvec"] = rm.rmatvec(u)
    out["rmatvec_global"] = rm.rmatvec(torch.as_tensor(data["u"]))
    for key, val in rm.column_stats().items():
        out[f"stats_{key}"] = val
    out["frobenius"] = rm.frobenius_norm()
    xt = torch.as_tensor(x)
    for loss in LOSSES:
        sep = row_separable(smooth_for(loss, torch.as_tensor(
            targets(loss, b, y))))
        f, g, z = rm.fused_grad(xt, sep, chunks=1)
        out[f"fg_{loss}_f"], out[f"fg_{loss}_g"] = f, g
        out[f"fg_{loss}_z"] = _whole(rm, z)
        f, g, z = rm.fused_grad(xt, sep, chunks=4)
        out[f"fgc_{loss}_f"], out[f"fgc_{loss}_g"] = f, g
    X = torch.as_tensor(data["X"])
    seps = [row_separable(SmoothQuad(b=torch.as_tensor(t)))
            for t in data["B"]]
    f, g, z = rm.fused_grad_multi(X, seps)
    out["fgm_f"], out["fgm_g"], out["fgm_z"] = f, g, _whole(rm, z)
    return out


def _svd_cases(rm: RowMatrix) -> dict:
    out = {}
    for mode, k in (("gram", 4), ("randomized", 3), ("lanczos", 3)):
        U, s, V, info = api.compute_svd(rm, k, mode=mode, device="cpu")
        out[f"svd_{mode}_s"], out[f"svd_{mode}_V"] = s, V
        out[f"svd_{mode}_U"] = U.to_local()
        out[f"svd_{mode}_passes"] = torch.tensor(info["a_passes"])
    Q, R = rm.tall_skinny_qr()
    out["tsqr_Q"], out["tsqr_R"] = Q.to_local(), R
    return out


def _solve_cases(mesh, A: np.ndarray, b: np.ndarray, L: float) -> dict:
    out = {}
    rm = RowMatrix.create(A, mesh=mesh)
    for method in SOLVE_METHODS:
        r = api.solve(api.SolveRequest(
            A=rm, b=b, method=method, tol=SOLVE_TOL[method],
            max_iters=SOLVE_ITERS, L0=L, device="cpu"))
        out[f"solve_{method}_x"] = r.x
        out[f"solve_{method}_iters"] = torch.tensor(r.info["iterations"])
        out[f"solve_{method}_passes"] = torch.tensor(r.info["a_passes"])
    for prec in ("f32", "psum8"):
        r = api.solve(api.SolveRequest(
            A=rm, b=b, method="gra", tol=PSUM8_TOL, max_iters=PSUM8_ITERS,
            L0=L, precision=prec, device="cpu"))
        out[f"prec_{prec}_iters"] = torch.tensor(r.info["iterations"])
        out[f"prec_{prec}_x"] = r.x
        out[f"prec_{prec}_reported"] = r.info["precision"]
    return out


def _sparse_cases(mesh, D: np.ndarray, data: dict, L: float) -> dict:
    out = {}
    S = SparseRowMatrix.from_dense(D, bs=8, mesh=mesh)
    out["sp_ell"] = torch.tensor(S.ell)
    xt = torch.as_tensor(data["xs"])
    for dispatch in ("bsr", "dense"):
        for loss in ("quad", "logistic"):
            sep = row_separable(smooth_for(loss, torch.as_tensor(
                targets(loss, data["bs"], data["ys"]))))
            f, g, z = S.fused_grad(xt, sep, dispatch=dispatch, chunks=1)
            out[f"sp_{dispatch}_{loss}_f"] = f
            out[f"sp_{dispatch}_{loss}_g"] = g
            parts = compat.all_gather(z, S.mesh, S.row_axes)
            out[f"sp_{dispatch}_{loss}_z"] = parts.reshape(-1)[: D.shape[0]]
            f, g, _ = S.fused_grad(xt, sep, dispatch=dispatch, chunks=4)
            out[f"spc_{dispatch}_{loss}_f"] = f
            out[f"spc_{dispatch}_{loss}_g"] = g
    out["sp_gram"] = S.gram()
    out["sp_rmatvec"] = S.rmatvec(torch.as_tensor(data["bs"]))
    out["sp_norms"] = S.column_norms()
    half = S.remesh(T.make_mesh((2, 2), ("data", "model"), device="cpu"))
    out["sp_remesh_strip"] = torch.tensor(half.data.shape[0])
    out["sp_remesh_dense"] = half.to_local()
    sep = row_separable(SmoothQuad(b=torch.as_tensor(data["bs"])))
    f, g, _ = half.fused_grad(xt, sep, dispatch="bsr")
    out["sp_remesh_f"], out["sp_remesh_g"] = f, g
    r = api.solve(api.SolveRequest(A=S, b=data["bs"], method="gra",
                                   tol=SOLVE_TOL["gra"],
                                   max_iters=SOLVE_ITERS, L0=L, device="cpu"))
    out["sp_solve_x"] = r.x
    out["sp_solve_plan"] = r.info["plan"]
    return out


def _front_door_cases(mesh, data: dict) -> dict:
    """make_problem(mesh=) through api.minimize, and the smoothed LP on a
    row-sharded constraint matrix."""
    from repro_torch.core.optim import make_problem
    from repro_torch.core.tfocs import TfocsOptions, solve_smoothed_lp
    out = {}
    p = make_problem("linear", mesh=mesh, **PROBLEM)
    out["problem_L"] = torch.tensor(p.L, dtype=torch.float64)
    x, info = api.minimize(p, "acc_rb", max_iters=PROBLEM_ITERS, tol=1e-6)
    out["problem_x"] = x
    out["problem_iters"] = torch.tensor(info["iterations"])
    lp = LinopMatrix(RowMatrix.create(data["Ac"], mesh=mesh))
    x, lam, info = solve_smoothed_lp(
        data["c"], lp, data["bc"], opts=TfocsOptions(
            max_iters=500, backtracking=True, restart=True), **LP)
    out["lp_x"], out["lp_lam"] = x, lam
    out["lp_feasibility"] = torch.tensor(
        info["kkt"]["primal_feasibility"])
    return out


def _telemetry_cases(rm: RowMatrix, data: dict) -> dict:
    """The collectives' spans and plan-vs-actual records under a
    recorder."""
    from repro_torch.launch import telemetry as tel
    sep = row_separable(SmoothQuad(b=torch.as_tensor(data["b"])))
    with tel.recording() as rec:
        rm.gram(chunks=2)
        rm.rmatvec(torch.as_tensor(data["u"]))
        rm.fused_grad(torch.as_tensor(data["x"]), sep)
    spans = sorted({e["name"] for e in rec.events() if e["type"] == "span"})
    acts = [(r["op"], r.get("chunks"), r.get("wire"),
             r.get("collective")) for r in rec.plan_actual()]
    return {"tel_spans": spans, "tel_plan_actual": acts}


def _rows_whole(v: torch.Tensor, mesh, row_axes, m: int) -> torch.Tensor:
    """A row strip (the same on the ranks of one row panel) gathered over
    the row axes to the global (m,) vector."""
    return compat.all_gather(v, mesh, row_axes).reshape(-1)[:m]


def _block_cases(mesh, data: dict) -> dict:
    """BlockMatrix on the mesh: create/validate (both axes padded), add,
    SUMMA multiply, transpose, the four vector products, the norm,
    to_local and its Lanczos SVD, every result gathered whole."""
    from repro_torch.core.distmat import BlockMatrix
    out = {}
    A = BlockMatrix.create(data["Ab"], mesh=mesh)
    B = BlockMatrix.create(data["Bb"], mesh=mesh)
    A.validate()
    B.validate()
    out["blk_tile"] = list(A.block_shape) + list(B.block_shape)
    out["blk_add"] = A.add(A).to_local()
    out["blk_multiply"] = A.multiply(B).to_local()
    out["blk_transpose"] = A.transpose().to_local()
    out["blk_local"] = A.to_local()
    v, u = torch.as_tensor(data["vb"]), torch.as_tensor(data["ub"])
    rows, m, n = A.row_axes, A.shape[0], A.shape[1]
    out["blk_matvec"] = _rows_whole(A.matvec(v), mesh, rows, m)
    out["blk_rmatvec"] = A.rmatvec(u)
    w = A._model_strip(v)                          # the rank's "model" strip
    out["blk_matvec_model_sharded"] = _rows_whole(
        A.matvec_model_sharded(w), mesh, rows, m)
    g = A.rmatvec_model_sharded(A._row_strip(u))
    out["blk_rmatvec_model_sharded"] = compat.all_gather(
        g, mesh, A.col_axis).reshape(-1)[:n]
    out["blk_frobenius"] = A.frobenius_norm()
    _, s, _, info = api.compute_svd(A, SVD_K, device="cpu")
    out["blk_svd_s"], out["blk_svd_plan"] = s, info["plan"]
    return out


def _coordinate_cases(mesh, data: dict) -> dict:
    """CoordinateMatrix on the mesh: the entries sharded by position,
    matvec, rmatvec, norm, transpose, the conversions and the Lanczos SVD
    of it and of its (wide) transpose."""
    from repro_torch.core.distmat import CoordinateMatrix
    out = {}
    C = CoordinateMatrix.create(data["ri"], data["ci"], data["va"], (20, 13),
                                mesh=mesh)
    out["coo_local_nnz"] = torch.tensor(C.values.shape[0])
    out["coo_matvec"] = C.matvec(torch.as_tensor(data["xc"]))
    out["coo_rmatvec"] = C.rmatvec(torch.as_tensor(data["yc"]))
    out["coo_frobenius"] = C.frobenius_norm()
    out["coo_local"] = C.to_local()
    out["coo_transpose"] = C.transpose().to_local()
    irm = C.to_indexed_row_matrix()
    out["coo_irm_local"] = irm.to_local()
    srm = C.to_sparse_row_matrix(bs=8)
    out["coo_srm_local"] = srm.to_local()
    out["coo_srm_ell"] = torch.tensor(srm.ell)
    out["coo_srm_shards"] = torch.tensor(srm.nshards)
    blk = C.to_block_matrix(4, 4)
    out["coo_block_local"] = blk.to_local()
    out["coo_block_grid"] = list(blk.grid)
    _, s, _, info = api.compute_svd(C, SVD_K, device="cpu")
    out["coo_svd_s"], out["coo_svd_plan"] = s, info["plan"]
    U, s, V, info = api.compute_svd(C.transpose(), SVD_K, device="cpu")
    out["coo_wide_svd_s"], out["coo_wide_svd_V"] = s, V
    out["coo_wide_svd_U"] = U.to_local()
    out["coo_wide_transposed"] = bool(info.get("transposed"))
    return out


SURVIVOR_DROP = 1               # the row shard the survivor mesh drops


def _survivor_mesh_cases(mesh, data: dict) -> dict:
    """BlockMatrix and CoordinateMatrix on the survivors of `mesh` once
    row shard SURVIVOR_DROP is dropped (train/elastic.survivor_mesh, whose
    process groups every rank makes): on each surviving rank every case
    of _block_cases and _coordinate_cases, keyed "surv_"; the dropped
    ranks take part in nothing after the mesh is made."""
    from repro_torch.train.elastic import survivor_mesh
    surv = survivor_mesh(mesh, SURVIVOR_DROP)
    out = {"surv_grid": surv.grid.tolist(), "surv_member": surv.member}
    if surv.member:
        out["surv_shape"] = [surv.shape["data"], surv.shape["model"]]
        for key, val in {**_block_cases(surv, data),
                         **_coordinate_cases(surv, data)}.items():
            out[f"surv_{key}"] = val
    return out


def _served(name: str, server, requests) -> dict:
    """Submit `requests` in order, run the server dry and read each
    answer: {name_x: the stacked x, name_info: iterations, converged,
    degraded and the server's stats}."""
    ids = [server.submit(r) for r in requests]
    server.run()
    res = [server.result(i) for i in ids]
    return {f"{name}_x": torch.stack([r.x for r in res]),
            f"{name}_info": {
                "iterations": [int(r.info["iterations"]) for r in res],
                "converged": [bool(r.info["converged"]) for r in res],
                "degraded": [r.info["degraded"] for r in res],
                "stats": {k: v for k, v in server.stats.items()
                          if k != "degraded"}}}


def serve_requests(A, data: dict, method: str, sparse: bool = False
                   ) -> list:
    """The served requests of one group: quad on As (each b of Bserve) or
    gra on D (each b of Bsparse), to SERVE_TOL."""
    B, L = (data["Bsparse"], data["Ls"]) if sparse \
        else (data["Bserve"], data["L"])
    return [api.SolveRequest(A=A, b=b, method=method, tol=SERVE_TOL,
                             max_iters=SERVE_ITERS, L0=L, device="cpu")
            for b in B]


def _serve_cases(mesh, data: dict) -> dict:
    """SolverServer over the row-sharded As (gra, acc and acc_rb groups)
    and D (gra); a deadline and a budget that the first rank alone sets,
    which every rank follows."""
    from repro_torch.launch.serve import SolverServer
    out = {}
    rm = RowMatrix.create(data["As"], mesh=mesh)
    S = SparseRowMatrix.from_dense(data["D"], bs=8, mesh=mesh)
    for method in SERVE_METHODS:
        out.update(_served(f"serve_{method}", SolverServer(slots=SERVE_K),
                           serve_requests(rm, data, method)))
    out.update(_served("serve_sparse", SolverServer(slots=2),
                       serve_requests(S, data, "gra", True)))
    first = compat.axis_index(mesh, mesh.axis_names) == 0
    slow = api.SolveRequest(A=rm, b=data["Bserve"][0], tol=0.0,
                            max_iters=10 ** 6, L0=data["L"], device="cpu",
                            deadline_s=DEADLINE_S if first else None)
    out.update(_served("serve_deadline", SolverServer(slots=2),
                       [slow] + serve_requests(rm, data, "gra")[1:2]))
    # Two groups, and on the first rank a budget of one group's pass: the
    # second waits for the first on every rank.
    srv = SolverServer(slots=SERVE_K, backend="cpu")
    if first:
        srv.budget_s = 1.5 * srv._price_pass(rm)
    out.update(_served("serve_budget", srv,
                       serve_requests(rm, data, "gra")[:2]
                       + serve_requests(rm, data, "acc_rb")[:2]))
    with tempfile.TemporaryDirectory() as d:
        out["serve_exported"] = srv.export_telemetry(Path(d) / "t.jsonl")
    return out


def _elastic_cases(mesh, data: dict) -> dict:
    """solve_elastic's accelerated groups on the row-sharded As, clean
    and with shard 1's device lost at iteration 3 (every rank re-meshes
    onto the survivors; the ranks of the lost shard stop)."""
    from repro_torch.core.optim.elastic import ElasticConfig, solve_elastic
    from repro_torch.train.faults import FaultPlan, FaultyLinop, FaultyMesh
    out = {}
    b = data["bsol"]
    for method in ELASTIC_METHODS:
        rm = RowMatrix.create(data["As"], mesh=mesh)
        x, info = solve_elastic(LinopMatrix(rm), "quad", b, method=method,
                                L0=data["L"], **ELASTIC_SOLVE)
        out[f"el_{method}_x"] = x
        out[f"el_{method}_info"] = {k: info[k] for k in (
            "iterations", "a_passes", "converged", "remeshes")}
        fm = FaultyMesh(mesh)
        lin = FaultyLinop(LinopMatrix(rm), FaultPlan(**ELASTIC_LOSS),
                          sleep=lambda _dt: None)
        x, info = solve_elastic(lin, "quad", b, method=method, L0=data["L"],
                                elastic=ElasticConfig(remesh_to=fm.drop),
                                **ELASTIC_SOLVE)
        out[f"el_{method}_loss_x"] = x
        out[f"el_{method}_loss_info"] = {k: info.get(k) for k in (
            "iterations", "converged", "remeshes", "dropped")}
        out[f"el_{method}_loss_casualties"] = fm.casualties
    return out


def cluster_rank(rank: int, name: str, data: dict) -> dict:
    """Every case of one mesh on this rank."""
    torch.manual_seed(0)
    mesh = T.make_mesh(MESHES[name], ("data", "model"), device="cpu")
    rm = RowMatrix.create(data["A"], mesh=mesh)
    out = {"shard_rows": torch.tensor(rm.rows.shape[0]),
           "shard": torch.tensor(rm.shard)}
    out.update(_dense_cases(rm, data))
    out.update(_svd_cases(rm))
    out.update(_solve_cases(mesh, data["As"], data["bsol"], data["L"]))
    out.update(_sparse_cases(mesh, data["D"], data, data["Ls"]))
    out.update(_front_door_cases(mesh, data))
    out.update(_telemetry_cases(rm, data))
    out.update(_block_cases(mesh, data))
    out.update(_coordinate_cases(mesh, data))
    out.update(_survivor_mesh_cases(mesh, data))
    out.update(_serve_cases(mesh, data))
    out.update(_elastic_cases(mesh, data))
    from repro_torch.core.distmat import IndexedRowMatrix
    irm = IndexedRowMatrix.create(np.arange(37) * 2, data["A"], mesh=mesh)
    out["irm_local"] = irm.to_local()
    out["irm_rmatvec"] = irm.rmatvec(torch.as_tensor(data["u"]))
    pod = T.make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    on_pod = RowMatrix.create(data["A"], mesh=pod)
    out["pod_shard"] = torch.tensor(on_pod.shard)
    out["pod_axes"] = list(on_pod.row_axes)
    out["pod_gram"] = on_pod.gram()
    out["pod_local"] = on_pod.to_local()
    c, plan = rm._resolve_chunks("grad", "auto", {"m": rm.rows.shape[0],
                                                  "n": rm.shape[1]},
                                 rm.rows.dtype)
    out["auto_chunks"], out["auto_notes"] = c, list(plan.notes)
    half = rm.remesh(T.make_mesh((2, 2), ("data", "model"), device="cpu"))
    out["remesh_rows"] = torch.tensor(half.rows.shape[0])
    out["remesh_gram"] = half.gram()
    out["remesh_local"] = half.to_local()
    return out


def psum8_rank(rank: int, data: dict) -> dict:
    """psum_int8 on each rank's own partial, a psum8 fused pass and its
    error-feedback identity on a (4, 1) mesh, and a psum8 gra solve."""
    from repro_torch.train.compression import psum_int8
    mesh = T.make_mesh((4, 1), ("data", "model"), device="cpu")
    out = {}
    tot, res = psum_int8(torch.as_tensor(data["parts"][rank]),
                         torch.as_tensor(data["res"][rank]), mesh,
                         ("data",), 4)
    out["psum_total"], out["psum_res"] = tot, res
    rm = RowMatrix.create(data["A"], mesh=mesh)
    lin = LinopMatrix(rm)
    sep = row_separable(SmoothQuad(lin.pad_data(torch.as_tensor(data["b"])),
                                   lin.row_weights()))
    x = torch.as_tensor(data["x"])
    f32 = rm.fused_grad(x, sep)
    res0 = rm.init_psum_residual()
    f8, g8, _, res1 = rm.fused_grad(x, sep, residual=res0)
    # The shard's exact partial: the f32 pass on this shard alone.
    from repro_torch.kernels import ops
    kind, t, w, prm = T.row_separable_inputs(sep, rm.rows.shape[0],
                                             rm._row_mask, rm._local_data)
    _, g_local, _ = ops.fused_grad(rm.rows, x, t, w, loss=kind, param=prm)
    out.update(f32_f=f32[0], f32_g=f32[1], f8=f8, g8=g8, res1=res1[0],
               g_local=g_local)
    for prec in ("f32", "psum8"):
        r = api.solve(api.SolveRequest(
            A=rm, b=data["b"], method="gra", tol=PSUM8_TOL,
            max_iters=PSUM8_ITERS, L0=data["L"], precision=prec,
            device="cpu"))
        out[f"solve_{prec}_x"] = r.x
        out[f"solve_{prec}_reported"] = r.info["precision"]
    return out


def cluster_rank_keys() -> list[str]:
    """The keys of cluster_rank's results (every one but "shard" and
    "shard_rows" the same on every rank)."""
    keys = ["shard", "shard_rows", "pod_shard", "gram", "gram_chunked", "gram_auto",
            "matvec", "rmatvec", "rmatvec_global", "frobenius", "fgm_f",
            "fgm_g", "fgm_z", "tsqr_Q", "tsqr_R", "sp_ell", "sp_gram",
            "sp_rmatvec", "sp_norms", "sp_remesh_strip", "sp_remesh_dense",
            "sp_remesh_f", "sp_remesh_g", "sp_solve_x", "sp_solve_plan",
            "problem_L", "problem_x", "problem_iters", "lp_x", "lp_lam",
            "lp_feasibility", "remesh_rows", "remesh_gram", "remesh_local",
            "tel_spans", "tel_plan_actual", "auto_chunks", "auto_notes",
            "pod_axes", "pod_gram", "pod_local", "irm_local",
            "irm_rmatvec"]
    keys += [f"blk_{k}" for k in (
        "tile", "add", "multiply", "transpose", "local", "matvec",
        "rmatvec", "matvec_model_sharded", "rmatvec_model_sharded",
        "frobenius", "svd_s", "svd_plan")]
    keys += [f"coo_{k}" for k in (
        "local_nnz", "matvec", "rmatvec", "frobenius", "local", "transpose",
        "irm_local", "srm_local", "srm_ell", "srm_shards", "block_local",
        "block_grid", "svd_s", "svd_plan", "wide_svd_s", "wide_svd_V",
        "wide_svd_U", "wide_transposed")]
    for name in (*SERVE_METHODS, "sparse", "deadline", "budget"):
        keys += [f"serve_{name}_x", f"serve_{name}_info"]
    keys += ["serve_exported", "surv_grid"]
    for method in ELASTIC_METHODS:
        keys += [f"el_{method}_{p}" for p in (
            "x", "info", "loss_x", "loss_info", "loss_casualties")]
    keys += [f"stats_{k}" for k in ("mean", "variance", "num_nonzeros",
                                    "min", "max", "norm_l2")]
    for loss in LOSSES:
        keys += [f"fg_{loss}_{p}" for p in "fgz"]
        keys += [f"fgc_{loss}_{p}" for p in "fg"]
    for mode in ("gram", "randomized", "lanczos"):
        keys += [f"svd_{mode}_{p}" for p in ("s", "V", "U", "passes")]
    for method in SOLVE_METHODS:
        keys += [f"solve_{method}_{p}" for p in ("x", "iters", "passes")]
    for prec in ("f32", "psum8"):
        keys += [f"prec_{prec}_{p}" for p in ("x", "reported", "iters")]
    for dispatch in ("bsr", "dense"):
        for loss in ("quad", "logistic"):
            keys += [f"sp_{dispatch}_{loss}_{p}" for p in "fgz"]
            keys += [f"spc_{dispatch}_{loss}_{p}" for p in "fg"]
    return keys


def fp8_rank(rank: int, A, b, x, name: str) -> dict:
    """tests/test_torch_fp8.py's mesh case: A's rows in the fp8 type
    `name` over a (2, 1) mesh, each rank casting its own strip; the
    strip's codes, the fused pass at x against the quad smooth of b, and
    the Gram."""
    mesh = T.make_mesh((2, 1), ("data", "model"), device="cpu")
    rm = RowMatrix.create(A, mesh=mesh, store_dtype=getattr(torch, name))
    f, g, z = rm.fused_grad(torch.as_tensor(x),
                            SmoothQuad(torch.as_tensor(b)))
    return {"strip": rm.rows.view(torch.uint8).clone(),
            "dtype": str(rm.rows.dtype), "f": f, "g": g, "z": z,
            "gram": rm.gram()}


CHUNKED_STORE = ("bfloat16", "float8_e4m3fn", "float8_e5m2")
CHUNKED_LOSSES = ("quad", "logistic")


def chunked_rank(rank: int, A, b, y, x, F, bF, xF) -> dict:
    """tests/test_torch_sketch_fp8.py's mesh cases on a (2, 1) mesh: for
    each storage type of CHUNKED_STORE, A's rows cast on each rank, the
    Gram and the fused gradient (quad on b, logistic on y) at chunks=2 and
    eager; then the bf16 fault case: F's rows in bf16, quad on bF at xF,
    chunks=2 and eager."""
    mesh = T.make_mesh((2, 1), ("data", "model"), device="cpu")
    out = {}
    for name in CHUNKED_STORE:
        rm = RowMatrix.create(A, mesh=mesh, store_dtype=getattr(torch, name))
        out[f"{name}_dtype"] = str(rm.rows.dtype)
        for c in (1, 2):
            out[f"{name}_gram_{c}"] = rm.gram(chunks=c)
            for loss in CHUNKED_LOSSES:
                sep = smooth_for(loss, torch.as_tensor(
                    targets(loss, b, y)))
                f, g, z = rm.fused_grad(torch.as_tensor(x), sep, chunks=c)
                out[f"{name}_{loss}_{c}"] = (f, g, z)
    rm = RowMatrix.create(F, mesh=mesh, store_dtype=torch.bfloat16)
    for c in (1, 2):
        out[f"fault_{c}"] = rm.fused_grad(
            torch.as_tensor(xF), SmoothQuad(torch.as_tensor(bF)), chunks=c)
    return out
