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
  5. serve:   one SolverServer(slots=8) on the same A answers 16 quad/gra
              requests (two waves through 8 slots), 8 quad/acc_rb and 8
              logistic/lbfgs requests, and one SvdRequest(k=16,
              mode="auto") of a wide A_w (2^18 x 16384, a decaying
              spectrum) that must take the randomized mode; two requests
              per group are served again one at a time (slots=1).  Quad
              answers against their float64 optima, group against serial
              answers, the SVD's sigma against a float64 subspace
              iteration, and fused_grad_multi launches against the
              server's A-passes, request by request.
  6. sparse:  S = 2^22 x 2^14 in 32 x 32 blocks, 16 a block-row, block
              columns from a Zipf(1) law, built on the card (the dense
              matrices freed first): api.svd(k=16, mode="auto") takes the
              Lanczos mode (bsr_matvec + bsr_rmatmul an operator call,
              bsr_matmul for U), checked by float64 residuals
              ||S^T S v - sigma^2 v|| and the factors' orthogonality; then
              api.solve quad/gra fused (fused_grad_bsr) and unfused
              (bsr_matvec + bsr_rmatmul), logistic/gra fused, and quad/gra
              on S's int8 copy (bsr_matvec + bsr_rmatmul), with the float64
              relative gradient of each quad answer, fused against unfused,
              and each solve's launches against its A-passes.

Phase 2 also holds fused_grad_multi (k = 1, 8, 16, all four losses, f32
and bf16 storage, slot independence of the other slots and of the slot
count, zero-weight slots) on A, and randsketch (r = 26, f32 and bf16) and
fused_grad at A_w's width (the kernel's unstaged path) on A_w, against
their plain versions, and the four block-sparse kernels (f32, bf16 and
int8 storage; bsr_matmul at nx = 16, bsr_rmatmul at nx = 1 and 16,
fused_grad_bsr for every loss) on S, just before phase 6.  fused_grad is
fused_grad_multi's kernel with one slot.
Phases 3 and 4 are one main path, phase 5 another and phase 6 a third:
every launch count is set to 0 just before each and read just after, and
each kernel of the path must have launched there.  The last lines are a
JSON object with the SVDs', the solves', the server's and phase 6's
numbers, the card's name and power limit, a JSON object with each
kernel's numbers, and {"ok": true, "device": {...}}.  Any failed check
exits non-zero before those lines.
Exits non-zero at once when there is no CUDA device or when the port's
sources are not beside this script.
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
M_W, N_W = 1 << 18, 16384      # A_w: the wide matrix of the randomized SVD
R_SKETCH = K_SVD + 10          # k + p, the randomized SVD's sketch width
K_MULTI = (1, 8, 16)           # slot counts of the fused_grad_multi check
SLOTS = 8                      # the server's slots per group
M_S, N_S = 1 << 22, 1 << 14   # S: the sparse matrix of phase 6
BS_S, ELL_S = 32, 16           # S's block size and stored blocks a block-row
K_U = 16                       # bsr_matmul's nx (U recovery) in phase 2
SPARSE_ITERS = 300             # iterations of phase 6's quad solves
# Phase 6's quad solves: the float64 ||S^T(Sx - b)|| / ||S^T b|| after
# SPARSE_ITERS gra steps at L0 = sigma_1^2.  Gradient descent from 0 leaves
# (1 - lambda/L)^k of each mode; over S's block-column spectrum that is
# about 0.006 at 300 steps (tools/sparse_spectrum.py).
REL_GRAD_LIMIT = 2e-2
SEED = 0
REPS = 10                      # timed launches per kernel (median taken)
ROWS64 = 1 << 18               # row chunk of the float64 reference sums
ROWS64_W = 1 << 14             # the same for A_w (2 GB of float64 a chunk)
BROWS64_S = 8192               # block-rows of S a float64 chunk (1 GB)

# Published H100 SXM peaks (NVIDIA data sheet), the bound's denominators.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,       # f32 FMA on the CUDA cores
              torch.bfloat16: 989e12,     # bf16 tensor cores, dense
              torch.int8: 1979e12}        # int8 tensor cores, dense

# Normwise relative tolerances, kernel against plain: g and the Gram sum
# over 2^21 rows in another order than cuBLAS does.
TOL = {"f": 1e-4, "z": 1e-4, "g": 5e-4, "tsgram": 5e-4, "gemm": 1e-4,
       "sketch": 1e-4, "bsr_matvec": 1e-4, "bsr_matmul": 1e-4,
       "bsr_rmatmul": 5e-4}
SOURCES = {
    # fused_grad is fused_grad_multi.cu's one-slot launch.
    "fused_grad": ("src/repro_torch/kernels/csrc/fused_grad_multi.cu",
                   "src/repro/kernels/fusedgrad.py:130"),
    "tsgram": ("src/repro_torch/kernels/csrc/tsgram.cu",
               "src/repro/kernels/tsgram.py:44"),
    "gemm": ("src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/gemm.py:53"),
    "fused_grad_multi": ("src/repro_torch/kernels/csrc/fused_grad_multi.cu",
                         "src/repro/kernels/fusedgrad.py:320"),
    "randsketch": ("src/repro_torch/kernels/csrc/randsketch.cu",
                   "src/repro/kernels/randsketch.py:58"),
    "bsr_matvec": ("src/repro_torch/kernels/csrc/bsr_spmv.cu",
                   "src/repro/kernels/bsr.py:251"),
    "bsr_matmul": ("src/repro_torch/kernels/csrc/bsr_spmm.cu",
                   "src/repro/kernels/bsr.py:188"),
    "bsr_rmatmul": ("src/repro_torch/kernels/csrc/bsr_rmatmul.cu",
                    "src/repro/kernels/bsr.py:335"),
    "fused_grad_bsr": ("src/repro_torch/kernels/csrc/fused_grad_bsr.cu",
                       "src/repro/kernels/fusedgrad.py:238"),
}
# The kernels each main path runs: phases 3-4 (solves and the Gram SVD),
# phase 5 (the server with its randomized-SVD one-shot) and phase 6 (the
# sparse solves and the Lanczos SVD).
PATHS = {"solve_svd": ("fused_grad", "tsgram", "gemm"),
         "serve": ("fused_grad_multi", "randsketch", "gemm"),
         "sparse": ("bsr_matvec", "bsr_rmatmul", "bsr_matmul",
                    "fused_grad_bsr")}


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


def multi_bound(k: int, isz: int) -> tuple[float, str]:
    """fused_grad_multi's bound for k slots: A once, X, T, W and Z, G, f."""
    return bound(M * N * isz + 4 * k * (2 * N + 3 * M + 1),
                 4.0 * M * N * k, torch.bfloat16 if isz == 2 else
                 torch.float32)


def check_fused_grad_multi(A: torch.Tensor, gen) -> dict:
    """fused_grad_multi against its plain version for k in K_MULTI, every
    loss, f32 and bf16 storage; slot 0's bits against changes to the other
    slots and against slot 0 served alone, and zero-weight slots' exact
    zeros.  Returns {dtype: {k: ...}}."""
    from repro_torch.kernels import fusedgrad

    dev = A.device
    out = {}
    for dt in ("f32", "bf16"):
        a = A if dt == "f32" else A.to(torch.bfloat16)
        for k in K_MULTI:
            x = torch.randn(k, N, generator=gen, device=dev)
            w = torch.rand(k, M, generator=gen, device=dev)
            w[:, -(M // 64):] = 0.0
            z0 = x @ A.T
            rec = {}
            for loss in fusedgrad.LOSSES:
                t = targets(loss, z0, gen)
                got = fusedgrad.fused_grad_multi(a, x, t, w, loss=loss,
                                                 param=0.5)
                want = fusedgrad.fused_grad_multi_plain(a, x, t, w,
                                                        loss=loss, param=0.5)
                torch.cuda.synchronize()
                errs = {q: rel_err(g, p) for q, g, p in zip("fgz", got, want)}
                for q, e in errs.items():
                    require(e <= TOL[q], f"fused_grad_multi {dt} k={k} {loss}"
                            f": {q} relative error {e:.3e} > {TOL[q]}")
                again = fusedgrad.fused_grad_multi(a, x, t, w, loss=loss,
                                                   param=0.5)
                require(all(torch.equal(u, v) for u, v in zip(got, again)),
                        f"fused_grad_multi {dt} k={k} {loss}: two runs "
                        "differ")
                rec[loss] = {"rel_err": errs, "max_abs_err": max(
                    max_abs(g, p) for g, p in zip(got, want))}
                if k > 1 and loss in ("quad", "logistic"):
                    # Slot 0 keeps its bits whatever slots 1..k-1 hold;
                    # zero-weight slots give exactly zero f and g.
                    x2, t2, w2 = x.clone(), t.clone(), w.clone()
                    x2[1:] = torch.randn(k - 1, N, generator=gen, device=dev)
                    t2[1:] = targets(loss, x2[1:] @ A.T, gen)
                    w2[1:] = torch.rand(k - 1, M, generator=gen, device=dev)
                    w2[k // 2:] = 0.0
                    f2, g2, z2 = fusedgrad.fused_grad_multi(
                        a, x2, t2, w2, loss=loss, param=0.5)
                    torch.cuda.synchronize()
                    require(torch.equal(f2[0], got[0][0])
                            and torch.equal(g2[0], got[1][0])
                            and torch.equal(z2[0], got[2][0]),
                            f"fused_grad_multi {dt} k={k} {loss}: slot 0 "
                            "changed with the other slots")
                    require(bool((f2[k // 2:] == 0).all())
                            and bool((g2[k // 2:] == 0).all()),
                            f"fused_grad_multi {dt} k={k} {loss}: a "
                            "zero-weight slot is not exactly zero")
                    # ... and the same bits as slot 0 served alone.
                    f1, g1, z1 = fusedgrad.fused_grad_multi(
                        a, x[:1], t[:1], w[:1], loss=loss, param=0.5)
                    torch.cuda.synchronize()
                    require(torch.equal(f1[0], got[0][0])
                            and torch.equal(g1[0], got[1][0])
                            and torch.equal(z1[0], got[2][0]),
                            f"fused_grad_multi {dt} k={k} {loss}: slot 0 "
                            "differs from the same request served alone")
                    del x2, t2, w2, f2, g2, z2, f1, g1, z1
                if loss == "quad":
                    rec["ms"] = time_ms(lambda: fusedgrad.fused_grad_multi(
                        a, x, t, w, loss="quad"))
                    rec["plain_ms"] = time_ms(
                        lambda: fusedgrad.fused_grad_multi_plain(
                            a, x, t, w, loss="quad"))
                    rec["library_ms"] = None   # no one torch call fuses these
                    rec["bound_ms"], rec["bound_by"] = multi_bound(
                        k, a.element_size())
                del got, want, again, t
            out.setdefault(dt, {})[k] = rec
            del x, w, z0
        del a
        torch.cuda.empty_cache()
    for dt, by_k in out.items():
        for k, r in by_k.items():
            print(f"[kernels] fused_grad_multi k={k:2d} {dt:4s} kernel "
                  f"{r['ms']:9.3f} ms | plain {r['plain_ms']:9.3f} ms | "
                  f"library      n/a | bound {r['bound_ms']:8.3f} ms "
                  f"({r['bound_by']}), share {r['bound_ms'] / r['ms']:.3f}")
    return out


def check_randsketch(A_w: torch.Tensor, gen) -> dict:
    """randsketch against its plain version on A_w, r = R_SKETCH, f32 and
    bf16 storage; returns {dtype: numbers}."""
    from repro_torch.kernels import randsketch

    m, n = A_w.shape
    q = torch.randn(m, R_SKETCH, generator=gen, device=A_w.device)
    out = {}
    for dt in ("f32", "bf16"):
        a = A_w if dt == "f32" else A_w.to(torch.bfloat16)
        got = randsketch.randsketch(a, q, out_dtype=torch.float32)
        want = randsketch.randsketch_plain(a, q, torch.float32)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        require(e <= TOL["sketch"], f"randsketch {dt}: relative error "
                f"{e:.3e} > {TOL['sketch']}")
        require(torch.equal(got, randsketch.randsketch(
            a, q, out_dtype=torch.float32)), f"randsketch {dt}: two runs "
            "differ")
        qc = q.to(a.dtype)
        b_ms, b_by = bound(m * n * a.element_size() + 4 * R_SKETCH * (m + n),
                           2.0 * m * n * R_SKETCH, a.dtype)
        out[dt] = {
            "rel_err": e, "max_abs_err": max_abs(got, want),
            "ms": time_ms(lambda: randsketch.randsketch(
                a, q, out_dtype=torch.float32)),
            "plain_ms": time_ms(lambda: randsketch.randsketch_plain(
                a, q, torch.float32), reps=3),
            "library_ms": time_ms(lambda: torch.mm(a.T, qc)),
            "bound_ms": b_ms, "bound_by": b_by}
        del got, want, qc, a
        torch.cuda.empty_cache()
    for dt, r in out.items():
        print(f"[kernels] randsketch r={R_SKETCH} {dt:4s} kernel "
              f"{r['ms']:9.3f} ms | plain {r['plain_ms']:9.3f} ms | library "
              f"{r['library_ms']:9.3f} ms | bound {r['bound_ms']:8.3f} ms "
              f"({r['bound_by']}), share {r['bound_ms'] / r['ms']:.3f}")
    return out


def check_fused_grad_wide(A_w: torch.Tensor, gen) -> dict:
    """fused_grad (quad and logistic) against its plain version at A_w's
    width, where the row block is too wide to stage in shared memory, f32
    and bf16 storage; returns {dtype: numbers}."""
    from repro_torch.kernels import fusedgrad

    m, n = A_w.shape
    dev = A_w.device
    x = torch.randn(n, generator=gen, device=dev) / math.sqrt(n)
    w = torch.rand(m, generator=gen, device=dev)
    z0 = A_w @ x
    out = {}
    for dt in ("f32", "bf16"):
        a = A_w if dt == "f32" else A_w.to(torch.bfloat16)
        rec = {}
        for loss in ("quad", "logistic"):
            t = targets(loss, z0, gen)
            got = fusedgrad.fused_grad(a, x, t, w, loss=loss)
            want = fusedgrad.fused_grad_plain(a, x, t, w, loss=loss)
            torch.cuda.synchronize()
            errs = {q: rel_err(g, p) for q, g, p in zip("fgz", got, want)}
            for q, e in errs.items():
                require(e <= TOL[q], f"fused_grad {dt} {m} x {n} {loss}: {q}"
                        f" relative error {e:.3e} > {TOL[q]}")
            rec[loss] = {"rel_err": errs, "max_abs_err": max(
                max_abs(g, p) for g, p in zip(got, want))}
            if loss == "quad":
                rec["ms"] = time_ms(lambda: fusedgrad.fused_grad(
                    a, x, t, w, loss="quad"))
                rec["plain_ms"] = time_ms(lambda: fusedgrad.fused_grad_plain(
                    a, x, t, w, loss="quad"), reps=3)
                rec["bound_ms"], rec["bound_by"] = bound(
                    m * n * a.element_size() + 4 * (n + 2 * m)
                    + 4 * (m + n + 1), 4.0 * m * n, a.dtype)
            del got, want, t
        out[dt] = rec
        del a
        torch.cuda.empty_cache()
    for dt, r in out.items():
        print(f"[kernels] fused_grad {m} x {n} {dt:4s} kernel {r['ms']:9.3f} "
              f"ms | plain {r['plain_ms']:9.3f} ms | library      n/a | "
              f"bound {r['bound_ms']:8.3f} ms ({r['bound_by']}), share "
              f"{r['bound_ms'] / r['ms']:.3f}")
    return out


# -- float64 references for phases 3 and 4 ----------------------------------

def chunks(A: torch.Tensor, rows: int | None = None):
    rows = rows or ROWS64
    for i in range(0, A.shape[0], rows):
        yield i, A[i:i + rows].double()


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


# -- phase 5: the server ----------------------------------------------------

def wide_matrix(dev, gen) -> torch.Tensor:
    """A_w (M_W x N_W) with a decaying spectrum: a seeded rank-64 factor
    times a geometric decay, sigma_i ~ 100 * 0.8^i, plus small Gaussian
    noise (a flat spectrum would defeat two power iterations)."""
    rank = 64
    left = torch.randn(M_W, rank, generator=gen, device=dev) / math.sqrt(M_W)
    right = torch.randn(N_W, rank, generator=gen, device=dev) / math.sqrt(N_W)
    decay = 100.0 * 0.8 ** torch.arange(rank, device=dev, dtype=torch.float32)
    A_w = (left * decay) @ right.T
    for i in range(0, M_W, ROWS64_W):
        A_w[i:i + ROWS64_W].add_(torch.randn(
            min(ROWS64_W, M_W - i), N_W, generator=gen, device=dev),
            alpha=1e-4)
    return A_w


def sigma64(A_w: torch.Tensor, k: int, gen, block: int = 64,
            iters: int = 6) -> torch.Tensor:
    """The top-k singular values of A_w in float64 by plain block subspace
    iteration (independent of the port's randomized SVD): V spans the top
    right singular subspace after `iters` sweeps; sigma(A_w V) then."""
    n = A_w.shape[1]
    f64 = dict(dtype=torch.float64, device=A_w.device)
    V = torch.linalg.qr(torch.randn(n, block, generator=gen, **f64))[0]
    for _ in range(iters):
        Y = torch.cat([c @ V for _, c in chunks(A_w, ROWS64_W)])
        Q = torch.linalg.qr(Y)[0]
        Z = sum(c.T @ Q[i:i + ROWS64_W] for i, c in chunks(A_w, ROWS64_W))
        V = torch.linalg.qr(Z)[0]
    Y = torch.cat([c @ V for _, c in chunks(A_w, ROWS64_W)])
    return torch.linalg.svdvals(Y)[:k]


def serve_requests(api, rm, B_quad, B_log, L0, which) -> list:
    """The phase's solve requests, in submit order: 16 quad/gra, 8
    quad/acc_rb and 8 logistic/lbfgs; `which` picks rows of each block."""
    dev = rm.device
    spec = [("gra", "quad", 200, range(16)),
            ("acc_rb", "quad", 100, range(16, 24)),
            ("lbfgs", "logistic", 30, range(8))]
    reqs = []
    for method, loss, iters, rows in spec:
        for j in (r for i, r in enumerate(rows) if which(i)):
            b = B_quad[j] if loss == "quad" else B_log[j]
            reqs.append(api.SolveRequest(
                A=rm, b=b, loss=loss, method=method, L0=L0, tol=1e-9,
                max_iters=iters, device=dev))
    return reqs


def drive(server) -> dict:
    """Step `server` until it drains, synchronizing after each step, and
    watch its runners from outside: for each served request, the runner's
    passes from just before its admission step to just after its
    retirement step; for each step, its wall time, and whether one group
    ran alone at full width with no admission or retirement."""
    admitted, observed, results, full = {}, {}, {}, []
    t_start = time.perf_counter()
    while server.busy():
        runners = list(server._runners.values())
        before = {id(r): r.a_passes for r in runners}
        widths = [int(r.active.sum()) for r in runners if r.busy()]
        t0 = time.perf_counter()
        done = server.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        for r in server._runners.values():
            for meta in r.meta:
                if meta is not None:
                    admitted.setdefault(meta["req"].request_id,
                                        (r, before.get(id(r), 0)))
            if widths == [SLOTS] and id(r) in before and not done \
                    and int(r.active.sum()) == SLOTS:
                full.append((dt, r.a_passes - before[id(r)]))
        for res in done:
            results[res.request_id] = res
            if res.request_id in admitted:
                runner, start = admitted[res.request_id]
                observed[res.request_id] = runner.a_passes - start
    return {"results": results, "observed": observed, "full": full,
            "wall_s": time.perf_counter() - t_start}


def run_serve(api, ops, A, A_w, L0, G64, single_ms, gen) -> dict:
    """Phase 5 on the main path's counts (the caller zeroes them just
    before and reads them just after)."""
    from repro_torch.core.distmat import RowMatrix
    from repro_torch.launch import telemetry
    from repro_torch.launch.serve import SolverServer

    dev = A.device
    rm = RowMatrix.create(A, device=dev)                 # no copy
    rm_w = RowMatrix.create(A_w, device=dev)
    # Targets from seeded x* and noise: 24 quad rows, 8 logistic rows.
    X_true = torch.randn(32, N, generator=gen, device=dev,
                         dtype=torch.float64)
    Z = torch.cat([c @ X_true.T for _, c in chunks(A)]).T      # (32, M)
    B_quad = (Z[:24] + 0.05 * torch.randn(24, M, generator=gen, device=dev,
                                         dtype=torch.float64)).float()
    B_log = torch.where(Z[24:] + torch.randn(8, M, generator=gen, device=dev,
                                             dtype=torch.float64) > 0,
                        1.0, -1.0).float()
    del Z
    # float64 optima: one pass for A^T B, phase 3's Gram for the solve.
    AtB = sum(c.T @ B_quad[:, i:i + ROWS64].double().T
              for i, c in chunks(A))                           # (N, 24)
    X_star = torch.linalg.solve(G64, AtB)
    f_star = 0.5 * ((B_quad.double() ** 2).sum(1) - (X_star * AtB).sum(0))

    grouped = SolverServer(slots=SLOTS, telemetry=telemetry.Recorder())
    reqs = serve_requests(api, rm, B_quad, B_log, L0, lambda i: True)
    ids = [grouped.submit(r) for r in reqs]
    svd_id = grouped.submit(api.SvdRequest(A=rm_w, k=K_SVD, mode="auto",
                                           device=dev))
    run = drive(grouped)
    launched_group = ops.launch_counts()
    serial = SolverServer(slots=1)
    sreqs = serve_requests(api, rm, B_quad, B_log, L0, lambda i: i < 2)
    sids = [serial.submit(r) for r in sreqs]
    srun = drive(serial)

    # -- checks ------------------------------------------------------------
    res = {rid: run["results"][rid] for rid in ids}
    require(len(run["results"]) == len(ids) + 1, "serve: not every request "
            "was answered")
    for rid, r in res.items():
        require(r.info["plan"] == "fused-group", f"serve {rid}: plan "
                f"{r.info['plan']}")
        require(bool(torch.isfinite(r.x).all()), f"serve {rid}: non-finite x")
        require(r.info["a_passes"] == run["observed"][rid],
                f"serve {rid}: a_passes {r.info['a_passes']} != the "
                f"{run['observed'][rid]} group passes while resident")
    gaps = []
    for j, rid in enumerate(ids[:24]):
        d = res[rid].x.double() - X_star[:, j]
        gaps.append(float(0.5 * d @ G64 @ d / f_star[j]))
    require(max(gaps) <= 1e-5, f"serve: quad objective gap {max(gaps):.3e}")
    f0 = M * math.log(2.0)                   # logistic objective at x = 0
    log_obj = [res[rid].info["objective"] for rid in ids[24:]]
    require(all(math.isfinite(o) and o < f0 for o in log_obj),
            f"serve: logistic/lbfgs objectives {log_obj} do not fall below "
            f"{f0:.6e}")
    # Group against serial: the first two requests of each group.
    firsts = [ids[0], ids[1], ids[16], ids[17], ids[24], ids[25]]
    agree = []
    for rid, sid in zip(firsts, sids):
        xs = srun["results"][sid].x
        agree.append(rel_err(res[rid].x, xs))
    require(max(agree) <= 1e-4, f"serve: group and serial x differ by "
            f"{max(agree):.3e}")
    svd = run["results"][svd_id]
    s64 = sigma64(A_w, K_SVD, gen)
    err_s = float(((svd.factors[1].double() - s64).abs() / s64).max())
    require(svd.info["plan"] == "randomized", f"serve: the SVD took "
            f"{svd.info['plan']}")
    require(err_s <= 1e-3, f"serve: randomized sigma error {err_s:.3e}")
    launched = ops.launch_counts()
    a_passes = grouped.stats["a_passes"] + serial.stats["a_passes"]
    require(launched_group["fused_grad_multi"] == grouped.stats["a_passes"],
            f"serve: {launched_group['fused_grad_multi']} fused_grad_multi "
            f"launches != {grouped.stats['a_passes']} server A-passes")
    require(launched["fused_grad_multi"] == a_passes,
            "serve: fused_grad_multi launches != A-passes with the serial "
            "server")
    require(launched["fused_grad"] == 0, "serve: fused_grad launched "
            "inside group steps")
    require(launched["randsketch"] == svd.info["power_iters"] + 1,
            f"serve: {launched['randsketch']} randsketch launches for "
            f"power_iters={svd.info['power_iters']}")

    # -- numbers -------------------------------------------------------------
    lat = sorted(grouped.latencies())
    full_ms = statistics.median(dt for dt, _ in run["full"])
    per_pass = statistics.median(dt / p for dt, p in run["full"] if p)
    oneshot = [sp.dur_s for sp in grouped.tel.spans
               if sp.name == "serve.oneshot"]
    rec = {
        "requests": len(ids) + 1, "wall_s": run["wall_s"],
        "requests_per_s": (len(ids) + 1) / run["wall_s"],
        "p50_latency_s": lat[len(lat) // 2],
        "p99_latency_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "steps": grouped.stats["steps"], "a_passes": grouped.stats["a_passes"],
        "serial_a_passes": serial.stats["a_passes"],
        "ms_per_group_iteration_8": full_ms,
        "ms_per_group_pass_8": per_pass,
        "single_fused_grad_ms_x8": 8 * single_ms,
        "max_quad_gap": max(gaps), "max_group_serial_rel": max(agree),
        "logistic_objectives": log_obj,
        "svd": {"plan": svd.info["plan"], "a_passes": svd.info["a_passes"],
                "tail_ratio": svd.info["tail_ratio"],
                "sigma_rel_err": err_s, "served_ms": 1e3 * oneshot[0]},
        "launches": launched}
    print(f"[serve] {rec['requests']} requests in {run['wall_s']:.2f} s "
          f"({rec['requests_per_s']:.2f} req/s), latency p50 "
          f"{rec['p50_latency_s']:.3f} s, p99 {rec['p99_latency_s']:.3f} s, "
          f"{rec['steps']} steps, {rec['a_passes']} group A-passes")
    print(f"[serve] 8 active slots: {full_ms:.3f} ms per group iteration, "
          f"{per_pass:.3f} ms per group pass, against 8 x single-request "
          f"fused_grad {8 * single_ms:.3f} ms")
    print(f"[serve] quad gap max {max(gaps):.3e}, group vs serial "
          f"{max(agree):.3e}, logistic objectives {min(log_obj):.6e}.."
          f"{max(log_obj):.6e} (f(0) = {f0:.6e})")
    print(f"[serve] randomized SVD k={K_SVD} on {M_W} x {N_W}: "
          f"{rec['svd']['served_ms']:.1f} ms served, "
          f"{svd.info['a_passes']} A-passes, tail_ratio "
          f"{svd.info['tail_ratio']:.3e}, sigma error {err_s:.3e}")
    return rec

# -- phase 6: the sparse path ----------------------------------------------

def sparse_matrix(dev):
    """S (M_S x N_S, BS_S x BS_S blocks, ELL_S a block-row), built on the
    card: each block-row's block columns drawn without replacement from a
    Zipf(1) law over the N_S / BS_S block columns (Gumbel top-k) and sorted,
    Gaussian block entries; seed SEED + 3."""
    from repro_torch.core.distmat import SparseRowMatrix

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    nbr = M_S // BS_S
    cols = sparse_columns(nbr, gen, dev)
    data = torch.randn((nbr, ELL_S, BS_S, BS_S), generator=gen, device=dev)
    return SparseRowMatrix(data, cols, dims=(M_S, N_S), nnz=data.numel())


def sparse_columns(nbr: int, gen, dev) -> torch.Tensor:
    """S's block pattern: for each of `nbr` block-rows, ELL_S block columns
    drawn without replacement from a Zipf(1) law over N_S / BS_S (Gumbel
    top-k), sorted; int32 (nbr, ELL_S)."""
    nbc = N_S // BS_S
    logp = -torch.log(torch.arange(1, nbc + 1, device=dev,
                                   dtype=torch.float32))
    cols = torch.empty((nbr, ELL_S), dtype=torch.int32, device=dev)
    step = 1 << 14
    for i in range(0, nbr, step):
        u = torch.rand(min(step, nbr - i), nbc, generator=gen, device=dev)
        keys = logp - torch.log(-torch.log(u.clamp_min(1e-30)))
        top = keys.topk(ELL_S, dim=1).indices
        cols[i:i + step] = torch.sort(top, dim=1).values.to(torch.int32)
    return cols


def _chunks64(a):
    """(first block-row, float64 blocks, int64 cols) over chunks of a
    BlockELL's block-rows, int8 scales applied."""
    nbr = a.cols.shape[0]
    for i in range(0, nbr, BROWS64_S):
        d = a.data[i:i + BROWS64_S].double()
        if a.scales is not None:
            d = d * a.scales[i:i + BROWS64_S, :, None, None].double()
        yield i, d, a.cols[i:i + BROWS64_S].long()


def apply64(a, X: torch.Tensor) -> torch.Tensor:
    """A X in float64 for a BlockELL A and X (n, k)."""
    bs = a.bs
    Xb = X.double().reshape(a.shape[1] // bs, bs, -1)
    out = []
    for _, d, c in _chunks64(a):
        y = torch.zeros((d.shape[0], bs, Xb.shape[-1]), dtype=torch.float64,
                        device=X.device)
        for s in range(a.ell):
            y += d[:, s] @ Xb[c[:, s]]
        out.append(y.reshape(-1, Xb.shape[-1]))
    return torch.cat(out)


def rapply64(a, Y: torch.Tensor) -> torch.Tensor:
    """A^T Y in float64 for a BlockELL A and Y (m, k)."""
    bs = a.bs
    Yb = Y.double().reshape(-1, bs, Y.shape[-1])
    g = torch.zeros((a.shape[1] // bs, bs, Y.shape[-1]), dtype=torch.float64,
                    device=Y.device)
    for i, d, c in _chunks64(a):
        yc = Yb[i:i + d.shape[0]]
        for s in range(a.ell):
            g.index_add_(0, c[:, s], d[:, s].transpose(1, 2) @ yc)
    return g.reshape(a.shape[1], -1)


def bsr_library(a):
    """torch.sparse_bsr_tensor of a BlockELL whose slots are all stored
    blocks (S has no padding slots), for the library yardstick; None for
    int8 storage, which torch's BSR product does not take."""
    if a.scales is not None:
        return None
    nbr, ell = a.cols.shape
    crow = torch.arange(0, nbr * ell + 1, ell, device=a.data.device)
    return torch.sparse_bsr_tensor(crow, a.cols.reshape(-1).long(),
                                   a.data.reshape(-1, a.bs, a.bs),
                                   size=a.shape)


def library_time(fn) -> tuple[float | None, str | None]:
    """One PyTorch call's time as the yardstick, or why there is none."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        torch.cuda.synchronize()
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return time_ms(fn), None


def sparse_bound(a, nx: int, extra_bytes: float, flops_per_elem: float):
    """The bound of one pass over a BlockELL's stored blocks: the blocks,
    scales and cols read once plus `extra_bytes`, or the operations."""
    elems = a.data.numel()
    nbytes = (elems * a.data.element_size() + 4 * a.cols.numel()
              + (0 if a.scales is None else 4 * a.scales.numel())
              + extra_bytes)
    return bound(nbytes, flops_per_elem * nx * elems, a.data.dtype)


def check_sparse_kernels(mats: dict, gen) -> dict:
    """bsr_matvec, bsr_matmul (nx = K_U), bsr_rmatmul (nx = 1 and K_U) and
    fused_grad_bsr (every loss) against their plain versions on S in f32,
    bf16 and int8 storage (fused_grad_bsr: f32 and bf16; ops composes
    bsr_matvec and bsr_rmatmul for int8); each timed beside its plain
    version, its bound and, where one exists, torch's BSR product.
    Returns {kernel: {storage: numbers}}."""
    from repro_torch.kernels import bsr, fusedgrad

    dev = mats["f32"].device
    m, n = M_S, N_S
    x = torch.randn(n, generator=gen, device=dev)
    X = torch.randn(n, K_U, generator=gen, device=dev)
    U1 = torch.randn(m, 1, generator=gen, device=dev)
    U = torch.randn(m, K_U, generator=gen, device=dev)
    xs = x / math.sqrt(ELL_S * BS_S)          # unit-scale z = S xs
    w = torch.rand(m, generator=gen, device=dev)
    z0 = bsr.bsr_matvec_plain(mats["f32"]._local(), xs)
    tgt = {loss: targets(loss, z0, gen) for loss in fusedgrad.LOSSES}
    del z0
    out = {k: {} for k in PATHS["sparse"]}
    for dt, srm in mats.items():
        a = srm._local()
        lib = bsr_library(a)
        cases = (("bsr_matvec", bsr.bsr_matvec, bsr.bsr_matvec_plain, x, 1,
                  4 * (n + m), lambda: lib @ x[:, None]),
                 ("bsr_matmul", bsr.bsr_matmul, bsr.bsr_matmul_plain, X, K_U,
                  4 * K_U * (n + m), lambda: lib @ X),
                 ("bsr_rmatmul", bsr.bsr_rmatmul, bsr.bsr_rmatmul_plain, U1,
                  1, 4 * (n + m), lambda: lib.t() @ U1),
                 ("bsr_rmatmul", bsr.bsr_rmatmul, bsr.bsr_rmatmul_plain, U,
                  K_U, 4 * K_U * (n + m), lambda: lib.t() @ U))
        for name, kern, plain, arg, nx, extra, libcall in cases:
            got = kern(a, arg)
            want = plain(a, arg)
            torch.cuda.synchronize()
            e = rel_err(got, want)
            require(e <= TOL[name], f"{name} {dt} nx={nx}: relative error "
                    f"{e:.3e} > {TOL[name]}")
            require(torch.equal(got, kern(a, arg)),
                    f"{name} {dt} nx={nx}: two runs differ")
            b_ms, b_by = sparse_bound(a, nx, extra, 2.0)
            lib_ms, lib_note = ((None, "int8 blocks: torch's BSR product "
                                 "takes no int8") if lib is None
                                else library_time(libcall))
            rec = {"nx": nx, "rel_err": e, "max_abs_err": max_abs(got, want),
                   "ms": time_ms(lambda: kern(a, arg)),
                   "plain_ms": time_ms(lambda: plain(a, arg)),
                   "library_ms": lib_ms, "library_note": lib_note,
                   "bound_ms": b_ms, "bound_by": b_by}
            key = dt if name != "bsr_rmatmul" or nx == 1 else f"{dt}_nx{nx}"
            out[name][key] = rec
            del got, want
        if dt == "int8":
            continue
        recs = {}
        for loss in fusedgrad.LOSSES:
            t = tgt[loss]
            got = fusedgrad.fused_grad_bsr(a, xs, t, w, loss=loss, param=0.5)
            want = fusedgrad.fused_grad_bsr_plain(a, xs, t, w, loss=loss,
                                                  param=0.5)
            torch.cuda.synchronize()
            errs = {q: rel_err(g, p) for q, g, p in zip("fgz", got, want)}
            for q, e in errs.items():
                require(e <= TOL[q], f"fused_grad_bsr {dt} {loss}: {q} "
                        f"relative error {e:.3e} > {TOL[q]}")
            again = fusedgrad.fused_grad_bsr(a, xs, t, w, loss=loss,
                                             param=0.5)
            require(all(torch.equal(u, v) for u, v in zip(got, again)),
                    f"fused_grad_bsr {dt} {loss}: two runs differ")
            rec = {"rel_err": errs, "max_abs_err": max(
                max_abs(g, p) for g, p in zip(got, want))}
            if loss == "quad":
                rec["ms"] = time_ms(lambda: fusedgrad.fused_grad_bsr(
                    a, xs, t, w, loss="quad"))
                rec["plain_ms"] = time_ms(lambda: fusedgrad.fused_grad_bsr_plain(
                    a, xs, t, w, loss="quad"))
                rec["library_ms"] = None     # no one torch call fuses these
                rec["bound_ms"], rec["bound_by"] = sparse_bound(
                    a, 1, 4 * (2 * n + 3 * m + 1), 4.0)
            recs[loss] = rec
            del got, want, again
        out["fused_grad_bsr"][dt] = recs
        del lib
        torch.cuda.empty_cache()
    for name, by in out.items():
        for key, r in by.items():
            r = r.get("quad", r)
            lib = ("    none" if r["library_ms"] is None
                   else f"{r['library_ms']:9.3f} ms")
            print(f"[kernels] {name:14s} {key:9s} kernel {r['ms']:9.3f} ms | "
                  f"plain {r['plain_ms']:9.3f} ms | library {lib} | bound "
                  f"{r['bound_ms']:8.3f} ms ({r['bound_by']}), share "
                  f"{r['bound_ms'] / r['ms']:.3f}")
    return out


def sparse_solve(api, ops, srm, b, **kw) -> tuple[dict, object, dict]:
    """One api.solve on a SparseRowMatrix; returns its record, the result
    and the launches it made, by kernel."""
    fused = kw.pop("fused")
    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.solve(api.SolveRequest(A=srm, b=b, precision="f32",
                                     device=srm.device, **kw), fused=fused)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    after = ops.launch_counts()
    made = {k: after[k] - before[k] for k in PATHS["sparse"]}
    info = res.info
    require(bool(torch.isfinite(res.x).all()), f"sparse solve {kw}: "
            "non-finite x")
    rec = {"loss": kw["loss"], "method": kw["method"], "fused": fused,
           "storage": "int8" if srm.scales is not None else "f32",
           "plan": info["plan"], "iterations": info["iterations"],
           "a_passes": info["a_passes"], "launches": made, "ms": wall,
           "ms_per_iteration": wall / max(info["iterations"], 1)}
    return rec, res, made


def run_sparse(api, ops, S, S_i8, refs) -> dict:
    """Phase 6 on the main path's counts (the caller zeroes them just
    before and reads them just after): the Lanczos SVD of S, then quad/gra
    fused and unfused, logistic/gra and quad/gra on the int8 copy."""
    a, a_i8 = S._local(), S_i8._local()
    dev = S.device
    # -- the Lanczos SVD (mode auto) --
    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.svd(api.SvdRequest(A=S, k=K_SVD, device=dev))
    torch.cuda.synchronize()
    svd_ms = (time.perf_counter() - t0) * 1e3
    after = ops.launch_counts()
    made = {k: after[k] - before[k] for k in PATHS["sparse"]}
    U, s, V = res.factors
    info = res.info
    require(info["plan"] == "lanczos", f"sparse svd: plan {info['plan']}")
    require(U.to_local().shape == (M_S, K_SVD) and V.shape == (N_S, K_SVD),
            "sparse svd: factor shapes")
    require(bool(torch.isfinite(s).all()), "sparse svd: non-finite sigma")
    V64, s64 = V.double(), s.double()
    R = rapply64(a, apply64(a, V64)) - V64 * s64 ** 2
    resid = torch.linalg.vector_norm(R, dim=0) / s64[0] ** 2
    eye = torch.eye(K_SVD, dtype=torch.float64, device=dev)
    orth_v = float(torch.linalg.matrix_norm(V64.T @ V64 - eye))
    u = U.to_local().double()
    orth_u = float(torch.linalg.matrix_norm(u.T @ u - eye))
    op_calls = info["op_calls"]
    require(float(resid.max()) <= 1e-4, f"sparse svd: residual "
            f"{float(resid.max()):.3e} sigma_1^2 > 1e-4")
    require(orth_v <= 1e-3, f"sparse svd: ||V^T V - I|| = {orth_v:.3e}")
    require(orth_u <= 1e-3, f"sparse svd: ||U^T U - I|| = {orth_u:.3e}")
    require(info["a_passes"] == 2 * op_calls + 1,
            f"sparse svd: a_passes {info['a_passes']} != 2 x {op_calls} + 1")
    require(made == {"bsr_matvec": op_calls, "bsr_rmatmul": op_calls,
                     "bsr_matmul": 1, "fused_grad_bsr": 0},
            f"sparse svd: launches {made} for {op_calls} operator calls")
    svd_rec = {"ms": svd_ms, "restarts": info["restarts"],
               "op_calls": op_calls, "a_passes": info["a_passes"],
               "converged": info["converged"], "sigma_1": float(s[0]),
               "sigma_16": float(s[-1]),
               "max_residual_over_sigma1sq": float(resid.max()),
               "orth_v": orth_v, "orth_u": orth_u, "launches": made}
    print(f"[sparse] Lanczos SVD k={K_SVD} of {M_S} x {N_S} (bs {BS_S}, "
          f"ell {ELL_S}): {svd_ms:.1f} ms, {info['restarts']} restarts, "
          f"{op_calls} operator calls, {info['a_passes']} A-passes, "
          f"converged {info['converged']}, sigma_1 {float(s[0]):.4f}, "
          f"max residual {float(resid.max()):.3e} sigma_1^2, "
          f"||V^T V - I|| {orth_v:.3e}, ||U^T U - I|| {orth_u:.3e}")
    L0 = float(s[0]) ** 2

    # -- the solves --
    solves = []
    quad = dict(loss="quad", method="gra", L0=L0, tol=1e-12,
                max_iters=SPARSE_ITERS)
    for srm, bell, fused in ((S, a, True), (S, a, False),
                             (S_i8, a_i8, True)):
        rec, r, made = sparse_solve(api, ops, srm, refs["b_quad"],
                                    fused=fused, **quad)
        key = "f32" if bell is a else "int8"
        x64 = r.x.double()[:, None]
        resid64 = apply64(bell, x64)[:, 0] - refs["b_quad"].double()
        grad = rapply64(bell, resid64[:, None])[:, 0]
        rec["rel_grad"] = float(torch.linalg.vector_norm(grad)
                                / refs["atb"][key])
        rec["objective64"] = 0.5 * float(resid64 @ resid64)
        n_att = rec["a_passes"]
        if srm is S_i8:        # int8: bsr_matvec + bsr_rmatmul an attempt
            want = {"bsr_matvec": n_att, "bsr_rmatmul": n_att,
                    "bsr_matmul": 0, "fused_grad_bsr": 0}
        elif fused:
            want = {"bsr_matvec": 0, "bsr_rmatmul": 0, "bsr_matmul": 0,
                    "fused_grad_bsr": n_att}
        else:                  # cached: one apply to seed, then one each
            k = r.info["iterations"] + r.info["n_backtracks"]
            want = {"bsr_matvec": 1 + k, "bsr_rmatmul": k, "bsr_matmul": 0,
                    "fused_grad_bsr": 0}
            require(n_att == 1 + 2 * k, f"unfused sparse solve: a_passes "
                    f"{n_att} != 1 + 2 x {k}")
        require(rec["plan"] == ("fused" if fused else "cached"),
                f"sparse quad {key} fused={fused}: plan {rec['plan']}")
        require(made == want, f"sparse quad {key} fused={fused}: launches "
                f"{made} for {n_att} A-passes")
        require(rec["rel_grad"] <= REL_GRAD_LIMIT, f"sparse quad {key} "
                f"fused={fused}: relative gradient {rec['rel_grad']:.3e} > "
                f"{REL_GRAD_LIMIT}")
        solves.append(rec)
    fused_obj, unfused_obj = (solves[0]["objective64"],
                              solves[1]["objective64"])
    gap = abs(fused_obj - unfused_obj) / fused_obj
    require(gap <= 1e-5, f"sparse quad: fused and unfused objectives "
            f"differ by {gap:.3e}")
    rec, r, made = sparse_solve(api, ops, S, refs["b_log"], fused=True,
                                loss="logistic", method="gra", L0=0.25 * L0,
                                tol=1e-12, max_iters=30)
    hist = r.info["history"][:rec["iterations"]].tolist()
    rec["first_last_objective"] = [hist[0], hist[-1]]
    require(rec["plan"] == "fused", f"sparse logistic: plan {rec['plan']}")
    require(made["fused_grad_bsr"] == rec["a_passes"],
            f"sparse logistic: launches {made}")
    require(all(b <= a_ * (1 + 1e-6) for a_, b in zip(hist, hist[1:]))
            and hist[-1] < hist[0],
            "sparse logistic: the objective does not fall monotonically")
    solves.append(rec)
    for r_ in solves:
        print(f"[sparse] {r_['loss']}/{r_['method']} {r_['storage']} "
              f"fused={r_['fused']}: plan {r_['plan']}, {r_['iterations']} "
              f"iterations, {r_['a_passes']} A-passes, "
              f"{r_['ms_per_iteration']:.3f} ms/iteration"
              + (f", relative gradient {r_['rel_grad']:.3e}"
                 if "rel_grad" in r_ else
                 f", objective {r_['first_last_objective'][0]:.6e} -> "
                 f"{r_['first_last_objective'][1]:.6e}"))
    print(f"[sparse] fused vs unfused objective {gap:.3e}")
    return {"svd": svd_rec, "solves": solves, "fused_unfused_gap": gap}


def smoke(dev: torch.device) -> dict:
    """Phases 2 to 5 on `dev`; returns the numbers to report."""
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
    # The slice-2 pieces draw from their own generator, so phases 2-4 see
    # the same numbers as before them.
    gen5 = torch.Generator(device=dev).manual_seed(SEED + 1)
    kernels["fused_grad_multi"] = check_fused_grad_multi(A, gen5)
    A_w = wide_matrix(dev, gen5)
    kernels["randsketch"] = check_randsketch(A_w, gen5)
    kernels["fused_grad"]["wide"] = check_fused_grad_wide(
        A_w, torch.Generator(device=dev).manual_seed(SEED + 2))

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
    print(f"[main path] solves and SVD: launches {launches}")
    for name in PATHS["solve_svd"]:
        require(launches[name] > 0, f"{name} never launched on the solve "
                "and SVD path")

    # -- the serving path: counts zeroed just before, read just after -----
    ops.reset_launch_counts()
    serve_rec = run_serve(api, ops, A, A_w, L0, G64,
                          kernels["fused_grad"]["f32"]["quad"]["ms"], gen5)
    torch.cuda.synchronize()
    serve_launches = ops.launch_counts()
    # ----------------------------------------------------------------------
    print(f"[main path] serving: launches {serve_launches}")
    for name in PATHS["serve"]:
        require(serve_launches[name] > 0, f"{name} never launched on the "
                "serving path")
    # The randomized SVD again, warm and alone.
    rm_w = RowMatrix.create(A_w, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = api.svd(api.SvdRequest(A=rm_w, k=K_SVD, mode="auto", device=dev))
    torch.cuda.synchronize()
    serve_rec["svd"]["warm_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"[serve] randomized SVD warm {serve_rec['svd']['warm_ms']:.1f} ms, "
          f"{warm.info['a_passes']} A-passes")
    # The dense matrices are done with: phase 6 has the card to itself.
    del A, A_w, rm, rm_w, warm, res
    torch.cuda.empty_cache()

    # -- phase 6 set-up: S on the card, its bf16 and int8 copies, and the
    # phase-2 checks of the sparse kernels on them --------------------------
    t0 = time.perf_counter()
    S = sparse_matrix(dev)
    mats = {"f32": S, "bf16": S.astype_store(torch.bfloat16),
            "int8": S.astype_store(torch.int8)}
    torch.cuda.synchronize()
    print(f"[sparse] S: {M_S} x {N_S}, bs {BS_S}, ell {ELL_S}, block density "
          f"{S.block_density():.4f}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    gen6 = torch.Generator(device=dev).manual_seed(SEED + 4)
    kernels.update(check_sparse_kernels(mats, gen6))
    del mats["bf16"]
    torch.cuda.empty_cache()
    # float64 references, made before the path's counts are zeroed.
    a, a_i8 = S._local(), mats["int8"]._local()
    x_true = torch.randn(N_S, 1, generator=gen6, device=dev,
                         dtype=torch.float64) / math.sqrt(ELL_S * BS_S)
    z = apply64(a, x_true)[:, 0]
    b_quad = (z + 0.5 * torch.randn(M_S, generator=gen6, device=dev,
                                    dtype=torch.float64)).float()
    b_log = torch.where(z + torch.randn(M_S, generator=gen6, device=dev,
                                        dtype=torch.float64) > 0,
                        1.0, -1.0).float()
    refs = {"b_quad": b_quad, "b_log": b_log, "atb": {
        key: float(torch.linalg.vector_norm(rapply64(bell, b_quad[:, None])))
        for key, bell in (("f32", a), ("int8", a_i8))}}
    del z

    # -- the sparse path: counts zeroed just before, read just after -------
    ops.reset_launch_counts()
    sparse_rec = run_sparse(api, ops, S, mats["int8"], refs)
    torch.cuda.synchronize()
    sparse_launches = ops.launch_counts()
    # ----------------------------------------------------------------------
    print(f"[main path] sparse: launches {sparse_launches}")
    for name in PATHS["sparse"]:
        require(sparse_launches[name] > 0, f"{name} never launched on the "
                "sparse path")
    t0 = time.perf_counter()
    api.svd(api.SvdRequest(A=S, k=K_SVD, device=dev))
    torch.cuda.synchronize()
    sparse_rec["svd"]["warm_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"[sparse] Lanczos SVD warm {sparse_rec['svd']['warm_ms']:.1f} ms")
    by_path = {"solve_svd": launches, "serve": serve_launches,
               "sparse": sparse_launches}

    rows = []
    for name, by_dtype in kernels.items():
        f32 = {"fused_grad": lambda r: r["quad"],
               "fused_grad_bsr": lambda r: r["quad"],
               "fused_grad_multi": lambda r: dict(
                   r[SLOTS], max_abs_err=r[SLOTS]["quad"]["max_abs_err"])
               }.get(name, lambda r: r)(by_dtype["f32"])
        shape = {"gemm": [M, N, K_GEMM], "fused_grad_multi": [M, N, SLOTS],
                 "randsketch": [M_W, N_W, R_SKETCH],
                 "bsr_matvec": [M_S, N_S, 1], "bsr_matmul": [M_S, N_S, K_U],
                 "bsr_rmatmul": [M_S, N_S, 1],
                 "fused_grad_bsr": [M_S, N_S]}.get(name, [M, N])
        path = next(p for p, names in PATHS.items() if name in names)
        src, replaces = SOURCES[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": by_path[path][name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
            "shape": shape, "dtype": "f32", "checks": by_dtype})
    return {"kernels": rows, "svd": svd_rec, "solves": solves,
            "serve": serve_rec, "sparse": sparse_rec}


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
    print(json.dumps({"svd": summary["svd"], "solves": summary["solves"],
                      "serve": summary["serve"],
                      "sparse": summary["sparse"]}))
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": summary["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
