#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (src/repro_torch) on one card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from src/repro_torch/kernels/csrc
with nvcc, then:

  1. card:    prints the device name and nvidia-smi's name and power limit;
  2. kernels: holds fused_grad (all four losses), tsgram and gemm against
              their plain torch versions at the main path's shapes, A of
              2^21 x 1024 in f32 and again in bf16 storage, and times each
              (CUDA events, warmed, median of REPS launches) beside its
              plain version, one PyTorch library call where there is one,
              and the card's bound for the same work;
  3. svd:     api.svd in Gram mode, k = 16, on the f32 A; singular values
              against the float64 Gram's eigenvalues, U's orthogonality, and
              the A-pass count;
  4. solves:  api.solve for quad/gra, quad/acc_rb and logistic/gra on the
              same A with L0 = sigma_1^2 from phase 3; the quad objectives
              against the float64 normal-equations optimum, the logistic
              history for descent, and every solve's A-passes against the
              fused_grad launches it made.

Phases 3 and 4 are the main path: every launch count is set to 0 just
before them and read just after, and each kernel must have launched there.
The last lines are a JSON object with the SVD's and the solves' numbers,
the card's name and power limit, a JSON object with each kernel's numbers,
and {"ok": true, "device": {...}}.  Any failed check exits non-zero
before those lines.  Exits non-zero at once when there is no CUDA device or
when the port's sources are not beside this script.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
M, N = 1 << 21, 1024           # A: rows x columns, the paper's tall-skinny
K_SVD = 16                     # singular triplets asked of the SVD
K_GEMM = 16                    # columns of B in the gemm check
SEED = 0
REPS = 10                      # timed launches per kernel (median taken)
ROWS64 = 1 << 18               # row chunk of the float64 reference sums

# Published H100 SXM peaks (NVIDIA data sheet), the bound's denominators.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,       # f32 FMA on the CUDA cores
              torch.bfloat16: 989e12}     # bf16 tensor cores, dense

# Normwise relative tolerances, kernel against plain: g and the Gram sum
# over 2^21 rows in another order than cuBLAS does.
TOL = {"f": 1e-4, "z": 1e-4, "g": 5e-4, "tsgram": 5e-4, "gemm": 1e-4}
SOURCES = {
    "fused_grad": ("src/repro_torch/kernels/csrc/fused_grad.cu",
                   "src/repro/kernels/fusedgrad.py:130"),
    "tsgram": ("src/repro_torch/kernels/csrc/tsgram.cu",
               "src/repro/kernels/tsgram.py:44"),
    "gemm": ("src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/gemm.py:53"),
}


class CheckFailed(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-300))


def max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max())


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of `fn` over `reps` launches, after two warm
    runs; CUDA events around each launch."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least time the card could take (ms) and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(f"[card] torch.cuda.get_device_name(0) = {name}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    return {"name": name, "nvidia_smi": line}


# -- phase 2: each kernel against its plain version -------------------------

def targets(loss: str, z: torch.Tensor, gen) -> torch.Tensor:
    if loss == "logistic":
        return torch.where(z + torch.randn(z.shape, generator=gen,
                                           device=z.device) > 0, 1.0, -1.0)
    if loss == "poisson":
        return torch.poisson(torch.exp(0.3 * z), generator=gen)
    return z + 0.5 * torch.randn(z.shape, generator=gen, device=z.device)


def check_kernels(A: torch.Tensor, gen) -> dict:
    """Every kernel at the main path's shapes in f32 and bf16 storage;
    returns {kernel: {dtype name: numbers}}."""
    from repro_torch.kernels import fusedgrad, gemm, tsgram

    dev = A.device
    out = {"fused_grad": {}, "tsgram": {}, "gemm": {}}
    x = torch.randn(N, generator=gen, device=dev)
    w = torch.rand(M, generator=gen, device=dev)
    w[-(M // 64):] = 0.0           # the zero-weight tail of padding rows
    B = torch.randn(N, K_GEMM, generator=gen, device=dev)
    z0 = fusedgrad.fused_grad_plain(A, x, torch.zeros(M, device=dev),
                                    w, loss="quad")[2]
    tgt = {loss: targets(loss, z0, gen) for loss in fusedgrad.LOSSES}
    del z0
    for dt in ("f32", "bf16"):
        a = A if dt == "f32" else A.to(torch.bfloat16)
        isz = a.element_size()

        # fused_grad, each loss.
        for loss in fusedgrad.LOSSES:
            t = tgt[loss]
            got = fusedgrad.fused_grad(a, x, t, w, loss=loss, param=0.5)
            want = fusedgrad.fused_grad_plain(a, x, t, w, loss=loss,
                                              param=0.5)
            torch.cuda.synchronize()
            errs = {k: rel_err(g, p) for k, g, p in zip("fgz", got, want)}
            for k, e in errs.items():
                require(e <= TOL[k], f"fused_grad {dt} {loss}: {k} "
                        f"relative error {e:.3e} > {TOL[k]}")
            again = fusedgrad.fused_grad(a, x, t, w, loss=loss, param=0.5)
            require(torch.equal(got[1], again[1])
                    and torch.equal(got[0], again[0]),
                    f"fused_grad {dt} {loss}: two runs differ")
            rec = {"rel_err": errs,
                   "max_abs_err": max(max_abs(g, p)
                                      for g, p in zip(got, want))}
            if loss == "quad":
                rec["ms"] = time_ms(lambda: fusedgrad.fused_grad(
                    a, x, t, w, loss=loss))
                rec["plain_ms"] = time_ms(lambda: fusedgrad.fused_grad_plain(
                    a, x, t, w, loss=loss))
                rec["library_ms"] = None     # no one torch call fuses these
                rec["bound_ms"], rec["bound_by"] = bound(
                    M * N * isz + 4 * (N + 2 * M) + 4 * (M + N + 1),
                    4.0 * M * N, a.dtype)
            out["fused_grad"].setdefault(dt, {})[loss] = rec
            del got, want, again

        # tsgram.
        got = tsgram.tsgram(a, out_dtype=torch.float32)
        want = tsgram.tsgram_plain(a, torch.float32)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        require(e <= TOL["tsgram"], f"tsgram {dt}: relative error {e:.3e}")
        require(torch.equal(got, got.T), f"tsgram {dt}: not symmetric")
        require(torch.equal(got, tsgram.tsgram(a, out_dtype=torch.float32)),
                f"tsgram {dt}: two runs differ")
        b_ms, b_by = bound(M * N * isz + N * N * 4, float(M) * N * (N + 1),
                           a.dtype)
        out["tsgram"][dt] = {
            "rel_err": e, "max_abs_err": max_abs(got, want),
            "ms": time_ms(lambda: tsgram.tsgram(a, out_dtype=torch.float32),
                          reps=REPS),
            "plain_ms": time_ms(lambda: tsgram.tsgram_plain(
                a, torch.float32)),
            "library_ms": time_ms(lambda: torch.mm(a.T, a)),
            "bound_ms": b_ms, "bound_by": b_by}
        del got, want

        # gemm, the skinny product of U recovery.
        got = gemm.gemm(a, B, out_dtype=torch.float32)
        want = gemm.gemm_plain(a, B, torch.float32)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        require(e <= TOL["gemm"], f"gemm {dt}: relative error {e:.3e}")
        b_ms, b_by = bound(M * N * isz + N * K_GEMM * 4 + M * K_GEMM * 4,
                           2.0 * M * N * K_GEMM, a.dtype)
        Bc = B.to(a.dtype)
        out["gemm"][dt] = {
            "rel_err": e, "max_abs_err": max_abs(got, want),
            "ms": time_ms(lambda: gemm.gemm(a, B, out_dtype=torch.float32)),
            "plain_ms": time_ms(lambda: gemm.gemm_plain(a, B,
                                                        torch.float32)),
            "library_ms": time_ms(lambda: torch.mm(a, Bc)),
            "bound_ms": b_ms, "bound_by": b_by}
        del got, want, Bc, a
        torch.cuda.empty_cache()
    for name, by_dtype in out.items():
        for dt, rec in by_dtype.items():
            r = rec["quad"] if name == "fused_grad" else rec
            print(f"[kernels] {name:10s} {dt:4s} kernel {r['ms']:9.3f} ms | "
                  f"plain {r['plain_ms']:9.3f} ms | library "
                  + ("     n/a" if r["library_ms"] is None
                     else f"{r['library_ms']:9.3f} ms")
                  + f" | bound {r['bound_ms']:8.3f} ms ({r['bound_by']}), "
                  f"share {r['bound_ms'] / r['ms']:.3f}")
    return out


# -- float64 references for phases 3 and 4 ----------------------------------

def chunks(A: torch.Tensor):
    for i in range(0, A.shape[0], ROWS64):
        yield i, A[i:i + ROWS64].double()


def gram64(A: torch.Tensor) -> torch.Tensor:
    return sum(c.T @ c for _, c in chunks(A))


def quad_objective64(A, b, x) -> float:
    x = x.double()
    return 0.5 * sum(float(torch.sum((c @ x - b[i:i + ROWS64].double())
                                     ** 2)) for i, c in chunks(A))


def quad_optimum64(A, b, G) -> float:
    atb = sum(c.T @ b[i:i + ROWS64].double() for i, c in chunks(A))
    return quad_objective64(A, b, torch.linalg.solve(G, atb))


# -- phases 3 and 4: the main path -------------------------------------------

def run_svd(api, RowMatrix, A, G64) -> tuple[dict, float]:
    rm = RowMatrix.create(A, device=A.device)     # no copy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.svd(api.SvdRequest(A=rm, k=K_SVD, mode="gram",
                                 device=A.device))
    U, s, V = res.factors
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    w64 = torch.linalg.eigvalsh(G64).flip(0)[:K_SVD]
    s64 = torch.sqrt(w64.clamp_min(0))
    err_s = float(((s.double() - s64).abs() / s64).max())
    u = U.to_local().double()
    err_u = float(torch.linalg.matrix_norm(
        u.T @ u - torch.eye(K_SVD, dtype=torch.float64, device=A.device)))
    print(f"[svd] k={K_SVD}: {wall:.1f} ms, sigma_1 {float(s[0]):.6f}, "
          f"max relative error of sigma {err_s:.3e}, "
          f"||U^T U - I||_F {err_u:.3e}, a_passes {res.info['a_passes']}, "
          f"plan {res.info['plan']}")
    require(U.rows.shape == (M, K_SVD) and V.shape == (N, K_SVD),
            "svd: factor shapes")
    require(bool(torch.isfinite(s).all()), "svd: non-finite values")
    require(err_s <= 1e-4, f"svd: sigma relative error {err_s:.3e}")
    require(err_u <= 1e-3, f"svd: ||U^T U - I|| = {err_u:.3e}")
    require(res.info["a_passes"] == 2, "svd: a_passes != 2")
    require(res.info["plan"] == "gram", "svd: plan != gram")
    return {"ms": wall, "sigma_rel_err": err_s, "orth_err": err_u,
            "a_passes": res.info["a_passes"]}, float(s[0]) ** 2


def run_solve(api, ops, rm, b, **kw) -> tuple[dict, object]:
    before = ops.launch_counts()["fused_grad"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.solve(api.SolveRequest(A=rm, b=b, precision="f32",
                                     device=rm.device, **kw), fused=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    info = res.info
    k, bt = info["iterations"], info["n_backtracks"]
    seed_passes = {"fused": 1, "fused_affine": 2}[info["plan"]]
    launched = ops.launch_counts()["fused_grad"] - before
    require(info["a_passes"] == seed_passes + k + bt,
            f"solve {kw}: a_passes {info['a_passes']} != formula")
    require(info["a_passes"] == launched,
            f"solve {kw}: a_passes {info['a_passes']} != {launched} "
            "fused_grad launches")
    require(bool(torch.isfinite(res.x).all()), f"solve {kw}: non-finite x")
    rec = {"loss": kw["loss"], "method": kw["method"], "plan": info["plan"],
           "iterations": k, "a_passes": info["a_passes"],
           "ms": wall, "ms_per_iteration": wall / max(k, 1)}
    return rec, res


def smoke(dev: torch.device) -> dict:
    """Phases 2 to 4 on `dev`; returns the numbers to report."""
    from repro_torch import api
    from repro_torch.core.distmat import RowMatrix
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(SEED)
    # Columns scaled from 3 down to 1: a condition number near 3 and
    # separated leading singular values; rows of unit scale.
    d = 1.0 + 2.0 * 0.95 ** torch.arange(N, device=dev, dtype=torch.float32)
    A = torch.randn(M, N, generator=gen, device=dev)
    A.mul_(d / math.sqrt(N))
    kernels = check_kernels(A, gen)

    # float64 references, made before the main path's counts are zeroed.
    G64 = gram64(A)
    x_true = torch.randn(N, generator=gen, device=dev)
    z = torch.cat([c @ x_true.double() for _, c in chunks(A)])
    b_quad = (z + 0.5 * torch.randn(M, generator=gen, device=dev,
                                    dtype=torch.float64)).float()
    b_log = torch.where(z + torch.randn(M, generator=gen, device=dev,
                                        dtype=torch.float64) > 0,
                        1.0, -1.0).float()
    f_star = quad_optimum64(A, b_quad, G64)
    del z

    # -- the main path: counts zeroed just before, read just after --------
    ops.reset_launch_counts()
    svd_rec, L0 = run_svd(api, RowMatrix, A, G64)
    rm = RowMatrix.create(A, device=dev)
    solves = []
    for method, iters in (("gra", 200), ("acc_rb", 100)):
        rec, res = run_solve(api, ops, rm, b_quad, loss="quad",
                             method=method, L0=L0, tol=1e-9,
                             max_iters=iters)
        gap = (quad_objective64(A, b_quad, res.x) - f_star) / f_star
        rec["objective_gap"] = gap
        solves.append(rec)
        require(rec["plan"] == {"gra": "fused",
                                "acc_rb": "fused_affine"}[method],
                f"quad {method}: plan {rec['plan']}")
        require(gap <= 1e-5, f"quad {method}: objective gap {gap:.3e}")
    rec, res = run_solve(api, ops, rm, b_log, loss="logistic", method="gra",
                         L0=0.25 * L0, tol=1e-9, max_iters=30)
    hist = res.info["history"][:rec["iterations"]].tolist()
    rec["first_last_objective"] = [hist[0], hist[-1]]
    solves.append(rec)
    require(rec["plan"] == "fused", f"logistic gra: plan {rec['plan']}")
    require(all(b <= a * (1 + 1e-6) for a, b in zip(hist, hist[1:]))
            and hist[-1] < hist[0],
            "logistic gra: the objective does not fall monotonically")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    # ----------------------------------------------------------------------

    # Where an SVD's time goes, warm (after the counted run): the whole
    # request again, and the n x n eigh alone.
    t0 = time.perf_counter()
    api.svd(api.SvdRequest(A=rm, k=K_SVD, mode="gram", device=dev))
    torch.cuda.synchronize()
    svd_rec["warm_ms"] = (time.perf_counter() - t0) * 1e3
    G32 = G64.float()
    svd_rec["eigh_ms"] = time_ms(lambda: torch.linalg.eigh(G32), reps=3)
    print(f"[svd] warm {svd_rec['warm_ms']:.1f} ms, of which eigh "
          f"{svd_rec['eigh_ms']:.1f} ms")

    for r in solves:
        print(f"[solve] {r['loss']}/{r['method']}: plan {r['plan']}, "
              f"{r['iterations']} iterations, {r['a_passes']} A-passes, "
              f"{r['ms_per_iteration']:.3f} ms/iteration"
              + (f", objective gap {r['objective_gap']:.3e}"
                 if "objective_gap" in r else
                 f", objective {r['first_last_objective'][0]:.6e} -> "
                 f"{r['first_last_objective'][1]:.6e}"))
    print(f"[main path] launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name} never launched on the main path")

    rows = []
    for name, by_dtype in kernels.items():
        f32 = by_dtype["f32"]["quad"] if name == "fused_grad" \
            else by_dtype["f32"]
        src, replaces = SOURCES[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
            "shape": [M, N] + ([K_GEMM] if name == "gemm" else []),
            "dtype": "f32", "checks": by_dtype})
    return {"kernels": rows, "svd": svd_rec, "solves": solves}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    info = card()
    t0 = time.perf_counter()
    _build.lib()
    print(f"[build] {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s")

    summary = smoke(dev)
    print(json.dumps({"svd": summary["svd"], "solves": summary["solves"]}))
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": summary["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
