#!/usr/bin/env python3
"""Time the port's selective_scan kernel at the falcon-mamba-7b prefill's
shape on one card.

    PYTHONPATH=src python3 tools/time_selective_scan.py [--label NAME]

Imports ``repro_torch`` from PYTHONPATH, so one call can time two trees of
the port on the same card: unpack the other tree (``git archive``) under
``build/`` and run this script once with each tree's ``src`` on PYTHONPATH,
in the order A, B, B, A.  Cases: Bt = 4 prompts, d = 8192 channels (the
prefill's shape, chip_smoke.py phase 8), S = 2048 and 2049 steps, N = 16
states (falcon-mamba-7b) and 8, all f32, from a seed: x Gaussian, dt in
(0, 0.1), A in (-1.1, -0.1), B, C Gaussian, D Gaussian, from a zero state.

Each is held against ``selective_scan_plain`` (normwise relative error of
y and of the final state at most 1e-4, two runs the same bits) and timed:
the median of REPS launches by CUDA events after two warm launches, and,
as ``stream_ms``, the mean of 10 launches queued back to back.  No one
PyTorch call runs the recurrence, so there is no library time.  One JSON
line per case, with the bound (one read of x, dt, B, C, A, D and one write
of y and the state at 3.35 TB/s, or Bt S d N exponentials at 67e12 / 16 a
second, the special-function units' rate) and the card's name and power
limit from nvidia-smi.  Exits non-zero if a check fails.
"""
import argparse
import json
import statistics
import subprocess
import sys

import torch

BT, D_INNER = 4, 8192
REPS = 10
from repro_torch.launch.machine import EXP_PER_S, HBM_BYTES_PER_S
TOL = 1e-4


def time_ms(fn, reps: int = REPS) -> float:
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


def stream_ms(fn, n: int = 10) -> float:
    """Mean device time of `n` launches queued back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-300))


def bounds(bt: int, s: int, d: int, n: int) -> dict:
    t_bytes = (3 * bt * s * d + 2 * bt * s * n + d * n + d
               + bt * d * n) * 4 / HBM_BYTES_PER_S * 1e3
    t_exp = bt * s * d * n / EXP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_exp),
            "bound_by": "bytes" if t_bytes >= t_exp else "operations",
            "bytes_ms": t_bytes, "exp_ms": t_exp}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_selective_scan: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import selective_scan as ss

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for n in (16, 8):
        for s in (2048, 2049):
            x = torch.randn(BT, s, D_INNER, generator=gen, device=dev)
            dt = torch.rand(BT, s, D_INNER, generator=gen, device=dev) * 0.1
            a = -torch.rand(D_INNER, n, generator=gen, device=dev) - 0.1
            b = torch.randn(BT, s, n, generator=gen, device=dev)
            c = torch.randn(BT, s, n, generator=gen, device=dev)
            d = torch.randn(D_INNER, generator=gen, device=dev)
            args_ = (x, dt, a, b, c, d)
            y, h = ss.selective_scan(*args_)
            y0, h0 = ss.selective_scan_plain(*args_)
            e_y, e_h = rel_err(y, y0), rel_err(h, h0)
            y2, h2 = ss.selective_scan(*args_)
            same = torch.equal(y, y2) and torch.equal(h, h2)
            del y, h, y0, h0, y2, h2

            def kernel():
                return ss.selective_scan(*args_)

            ms = time_ms(kernel)
            bd = bounds(BT, s, D_INNER, n)
            print(json.dumps({
                "label": args.label, "shape": [BT, s, D_INNER, n],
                "ms": ms, "stream_ms": stream_ms(kernel),
                "library_ms": None, **bd, "bound_share": bd["bound_ms"] / ms,
                "rel_err_y": e_y, "rel_err_h": e_h, "same_bits": same,
                "card": card}), flush=True)
            ok = ok and e_y <= TOL and e_h <= TOL and same
            del x, dt, a, b, c, d, args_
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
