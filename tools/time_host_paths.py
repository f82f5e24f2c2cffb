#!/usr/bin/env python3
"""Time the port's host-bound paths on one card: the Figure-1 solves and
the per-call cost of the kernel wrappers they go through.

    PYTHONPATH=src python3 tools/time_host_paths.py [--label NAME]
        [--reps 5] [--calls 2000]

Imports ``repro_torch`` from PYTHONPATH, so one call can compare two trees
of the port on the same card: unpack the other tree (``git archive``) under
``build/`` and run this script once with each tree's ``src`` on PYTHONPATH,
in the order A, B, B, A.  Cases, every operand drawn from a seed:

  wrapper/fused_grad   ops.fused_grad on 10000 x 1024 f32 (make_problem's
                       default size, so the kernel takes microseconds and
                       the wrapper's host work shows), `--calls` calls
                       queued back to back, one sync at the end;
  wrapper/gemm         ops.gemm on 10000 x 1024 times 1024 x 16, the same;
  wrapper/bsr_matvec   SparseRowMatrix.matvec with the default dispatch on
                       8192 x 1024 with 16 x 16 blocks, two stored a
                       block-row, the same;
  distmat/METHOD       RowMatrix.fused_grad, .rmatvec and .gram on the
                       10000 x 1024 A and SparseRowMatrix.fused_grad on
                       the sparse one, on one device with their default
                       arguments: each kernel's call plus the method's
                       host work (padding, chunk and collective choices),
                       the same;
  distmat/*_kernel     the two fused_grad cases' kernel calls alone, on
                       the inputs the methods pass them (the default
                       weights made as the method makes them), so a
                       method's own host cost is its case less this one
                       within one process;
  figure1/NAME/METHOD  api.minimize on make_problem(NAME) through METHOD at
                       its defaults (cap 200), the 24 runs chip_smoke.py's
                       phase 9 makes, each timed on the host clock from a
                       sync to a sync.

Every case runs `--reps` times, the Figure-1 runs round-robin so that no run
sees only a warm or only a cold host.  A wrapper case reports microseconds
a call, a Figure-1 run milliseconds and its fused_grad launches.  One JSON
line per case, with the card's name and power limit from nvidia-smi; the
first value of a list is the first run in the process (it pays the first
planning of each shape).
"""
import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

FIG1_NAMES = ("linear", "linear_l1", "logistic", "logistic_l2")
M, N, K_U = 10000, 1024, 16
M_S, N_S, BS_S, ELL_S = 8192, 1024, 16, 2
SEED = 0


def per_call_us(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--calls", type=int, default=2000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_host_paths: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import api
    from repro_torch.core import optim
    from repro_torch.core.distmat import RowMatrix, SparseRowMatrix
    from repro_torch.core.tfocs.smooth import SmoothQuad
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randn(M, N, generator=gen, device=dev) / N ** 0.5
    x = torch.randn(N, generator=gen, device=dev)
    t = torch.randn(M, generator=gen, device=dev)
    w = torch.ones(M, device=dev)
    b = torch.randn(N, K_U, generator=gen, device=dev)
    rng = np.random.default_rng(SEED)
    dense = np.zeros((M_S, N_S), np.float32)
    for i in range(M_S // BS_S):
        for j in rng.choice(N_S // BS_S, ELL_S, replace=False):
            dense[i * BS_S:(i + 1) * BS_S, j * BS_S:(j + 1) * BS_S] = \
                rng.normal(size=(BS_S, BS_S))
    S = SparseRowMatrix.from_dense(dense, BS_S, device=dev)
    v = torch.randn(N_S, generator=gen, device=dev)
    rm = RowMatrix.create(a, device=dev)
    quad, quad_s = SmoothQuad(t), SmoothQuad(torch.randn(
        M_S, generator=gen, device=dev))
    wrappers = {
        "wrapper/fused_grad": lambda: ops.fused_grad(a, x, t, w, loss="quad"),
        "wrapper/gemm": lambda: ops.gemm(a, b, out_dtype=torch.float32),
        "wrapper/bsr_matvec": lambda: S.matvec(v),
        "distmat/rowmatrix_fused_grad": lambda: rm.fused_grad(x, quad),
        "distmat/rowmatrix_rmatvec": lambda: rm.rmatvec(t),
        "distmat/rowmatrix_gram": lambda: rm.gram(),
        "distmat/sparserow_fused_grad": lambda: S.fused_grad(v, quad_s),
        "distmat/rowmatrix_fused_grad_kernel": lambda: ops.fused_grad(
            a, x, t, rm._row_mask(), loss="quad"),
        "distmat/sparserow_fused_grad_kernel": lambda: ops.fused_grad_bsr(
            S._local(), v, quad_s.b, S._row_mask(), loss="quad"),
    }
    out = {}
    for _ in range(args.reps):
        for case, fn in wrappers.items():
            ops.reset_launch_counts()
            us = per_call_us(fn, args.calls)
            out.setdefault(case, {"us_per_call": [],
                                  "launches": ops.launch_counts()})
            out[case]["us_per_call"].append(us)
    problems = {name: optim.make_problem(name, device=dev)
                for name in FIG1_NAMES}
    for _ in range(args.reps):
        for name, p in problems.items():
            for method in optim.METHODS:
                before = ops.launch_counts()["fused_grad"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, info = api.minimize(p, method)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                rec = out.setdefault(f"figure1/{name}/{method}", {
                    "ms": [], "plan": info["plan"],
                    "iterations": info["iterations"],
                    "fused_grad_launches":
                        ops.launch_counts()["fused_grad"] - before})
                rec["ms"].append(ms)
    for case, rec in out.items():
        vals = rec.get("ms") or rec["us_per_call"]
        rec["median"] = statistics.median(vals)
        rec["rest_median"] = statistics.median(vals[1:] or vals)
        print(json.dumps({"label": args.label, "case": case, **rec,
                          "card": card}))
    fig = [r for c, r in out.items() if c.startswith("figure1/")]
    print(json.dumps({"label": args.label, "case": "figure1/total",
                      "median_ms_sum": sum(r["median"] for r in fig),
                      "fused_runs_median_ms_sum": sum(
                          r["median"] for r in fig
                          if r["fused_grad_launches"]),
                      "build_s": build_s, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
