#!/usr/bin/env python3
"""Why a CoordinateMatrix's Lanczos SVD does or does not converge, on one card.

    python3 tools/diagnose_coo.py [--restarts 100]

Builds chip_smoke.py's phase-9 CoordinateMatrix C (2^18 x 2^14, 2^27
entries filling 32 x 32 blocks, Zipf(1) block columns) and multiplies it
three ways:

  scatter      gather, then `index_add_` into f32: a scatter with atomics
               on the card, each output one sequential chain of f32 adds;
  scatter_f64  the same scatter into float64, rounded to f32 at the end:
               atomics, but each sum exact to f32's rounding;
  segment      C.matvec / C.rmatvec: the entries sorted once, each output's
               run summed by `torch.segment_reduce` (a tree, the same order
               every call).

For each, on VECS random vectors: the normwise relative error of A v, Aᵀu
and AᵀA v against float64 sums, whether two calls give the same bits, and
the device time of each product (CUDA events, median of chip_smoke.REPS).
Then one Lanczos SVD of k = 16 on each normal operator (the port's
lanczos_eigsh, tol 1e-6, the restart cap given) with its restarts, operator
calls, whether it converged, the largest Ritz residual estimate over the
largest Ritz value, and its wall ms.  Prints one JSON line per form, the
longest row and column runs of C, and the card's name and power limit from
nvidia-smi.  Exits non-zero where there is no card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402

VECS = 4


def scatter(gather_idx, scatter_idx, values, n, acc_dtype):
    def product(v):
        out = torch.zeros(n, dtype=acc_dtype, device=v.device)
        out.index_add_(0, scatter_idx, (values * v.index_select(0, gather_idx))
                       .to(acc_dtype))
        return out.float()
    return product


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--restarts", type=int, default=chip_smoke.COO_RESTARTS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("diagnose_coo: no CUDA device")
    from repro_torch.core.linalg.lanczos import lanczos_eigsh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = chip_smoke.card()
    print(f"[card] {card['nvidia_smi']}")
    C, _ = chip_smoke.coordinate_matrix(dev)
    m, n = C.shape
    ri, ci, va = C.row_idx.long(), C.col_idx.long(), C.values
    va64 = va.double()
    rows_runs = C.by_row.offsets.diff()
    cols_runs = C.by_col.offsets.diff()
    print(f"[coo] {m} x {n}, {C.nnz} entries; longest row run "
          f"{int(rows_runs.max())}, longest column run {int(cols_runs.max())}"
          f" (median {float(cols_runs.float().median()):.0f})")

    def av64(v):
        return torch.zeros(m, dtype=torch.float64, device=dev).index_add_(
            0, ri, va64 * v.double().index_select(0, ci))

    def atu64(u):
        return torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, ci, va64 * u.double().index_select(0, ri))

    forms = {
        "scatter": (scatter(ci, ri, va, m, torch.float32),
                    scatter(ri, ci, va, n, torch.float32)),
        "scatter_f64": (scatter(ci, ri, va, m, torch.float64),
                        scatter(ri, ci, va, n, torch.float64)),
        "segment": (C.matvec, C.rmatvec),
    }
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 21)
    vs = [torch.randn(n, generator=gen, device=dev) for _ in range(VECS)]
    us = [torch.randn(m, generator=gen, device=dev) for _ in range(VECS)]
    want = [(av64(v), atu64(u), atu64(av64(v))) for v, u in zip(vs, us)]
    for name, (mv, rmv) in forms.items():
        err = {"matvec": 0.0, "rmatvec": 0.0, "normal": 0.0}
        same = True
        for v, u, (w_av, w_atu, w_ata) in zip(vs, us, want):
            av, atu = mv(v), rmv(u)
            same = same and torch.equal(av, mv(v)) and torch.equal(
                atu, rmv(u))
            for key, got, w in (("matvec", av, w_av), ("rmatvec", atu, w_atu),
                                ("normal", rmv(mv(v)), w_ata)):
                err[key] = max(err[key], chip_smoke.rel_err(got, w))
        rec = {"form": name, "rel_err": err, "repeat_bits": same,
               "matvec_ms": chip_smoke.time_ms(lambda: mv(vs[0])),
               "rmatvec_ms": chip_smoke.time_ms(lambda: rmv(us[0]))}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals, _, info = lanczos_eigsh(lambda v: rmv(mv(v)), n,
                                      chip_smoke.K_SVD,
                                      max_restarts=args.restarts, device=dev)
        torch.cuda.synchronize()
        rec["lanczos"] = {
            "ms": (time.perf_counter() - t0) * 1e3,
            "restarts": info["restarts"], "op_calls": info["op_calls"],
            "converged": info["converged"],
            "max_resid_over_theta1": float(info["resid"].max() / vals[0]),
            "sigma_1": float(vals[0].sqrt())}
        rec["card"] = card["nvidia_smi"]
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
