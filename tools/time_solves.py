#!/usr/bin/env python3
"""Run the main path's three solves on one card and report each one's
iterations, A-passes and wall time.

    PYTHONPATH=src python3 tools/time_solves.py [--label NAME]

Imports ``repro_torch`` from PYTHONPATH, so one call can compare two trees
of the port on the same card: unpack the other tree (``git archive``) under
``build/`` and run this script once with each tree's ``src`` on PYTHONPATH,
in the order A, B, B, A.  The problem is the shape of chip_smoke.py's main
path, made from its own seed: A (2^21 x 1024 f32, columns scaled from 3 down
to 1), b = A x_true + noise, L0 the largest eigenvalue of the float64 Gram
matrix.  The solves are api.solve's fused plans, as chip_smoke.py runs
them: quad/gra (cap 200), quad/acc_rb (cap 100) and logistic/gra (cap 30),
tol 1e-9.  One JSON line per solve, with the card's name and power limit
from nvidia-smi; a quad solve also reports its objective gap against the
float64 optimum.  The first line is a warm-up solve, not reported.
"""
import argparse
import json
import math
import subprocess
import sys
import time

import torch

M, N, SEED, ROWS64 = 1 << 21, 1024, 7, 1 << 17
SOLVES = [("quad", "gra", 200, 1.0), ("quad", "acc_rb", 100, 1.0),
          ("logistic", "gra", 30, 0.25)]


def chunks(A):
    for i in range(0, A.shape[0], ROWS64):
        yield i, A[i:i + ROWS64].double()


def quad_objective64(A, b, x) -> float:
    x = x.double()
    return 0.5 * sum(float(torch.sum((c @ x - b[i:i + ROWS64].double()) ** 2))
                     for i, c in chunks(A))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_solves: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import api
    from repro_torch.core.distmat import RowMatrix
    from repro_torch.kernels import ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d = 1.0 + 2.0 * 0.95 ** torch.arange(N, device=dev, dtype=torch.float32)
    A = torch.randn(M, N, generator=gen, device=dev)
    A.mul_(d / math.sqrt(N))
    x_true = torch.randn(N, generator=gen, device=dev, dtype=torch.float64)
    z = torch.cat([c @ x_true for _, c in chunks(A)])
    b = {"quad": (z + 0.5 * torch.randn(M, generator=gen, device=dev,
                                        dtype=torch.float64)).float(),
         "logistic": torch.where(z + torch.randn(
             M, generator=gen, device=dev, dtype=torch.float64) > 0,
             1.0, -1.0).float()}
    G64 = sum(c.T @ c for _, c in chunks(A))
    L0 = float(torch.linalg.eigvalsh(G64)[-1])
    atb = sum(c.T @ b["quad"][i:i + ROWS64].double() for i, c in chunks(A))
    f_star = quad_objective64(A, b["quad"], torch.linalg.solve(G64, atb))
    del z, G64, atb
    rm = RowMatrix.create(A, device=dev)

    def solve(loss, method, iters, l0_scale):
        before = ops.launch_counts()["fused_grad"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = api.solve(api.SolveRequest(
            A=rm, b=b[loss], precision="f32", device=dev, loss=loss,
            method=method, L0=l0_scale * L0, tol=1e-9, max_iters=iters),
            fused=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        return res, wall, ops.launch_counts()["fused_grad"] - before

    solve("quad", "gra", 5, 1.0)   # warm-up: the build and first launches
    for loss, method, iters, l0_scale in SOLVES:
        res, wall, launched = solve(loss, method, iters, l0_scale)
        rec = {"label": args.label, "card": card, "loss": loss,
               "method": method, "plan": res.info["plan"],
               "max_iters": iters, "iterations": res.info["iterations"],
               "a_passes": res.info["a_passes"],
               "fused_grad_launches": launched, "ms": wall,
               "ms_per_iteration": wall / max(res.info["iterations"], 1)}
        if loss == "quad":
            rec["objective_gap"] = (quad_objective64(A, b[loss], res.x)
                                    - f_star) / f_star
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
