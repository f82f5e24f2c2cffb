#!/usr/bin/env python3
"""Time the port's tsgram kernel at the Gram SVD's and DIMSUM's shapes on one card.

    PYTHONPATH=src python3 tools/time_tsgram.py [--label NAME]

Imports ``repro_torch`` from PYTHONPATH, so one call can time two trees of
the port on the same card: unpack the other tree (``git archive``) under
``build/`` and run this script once with each tree's ``src`` on PYTHONPATH,
in the order A, B, B, A.  Cases, with A drawn from a seed:

  A         2^21 x 1024 (chip_smoke.py's A: the Gram SVD and exact DIMSUM of
            the dense path), f32 and its bf16 copy;
  ragged    2^21 x 1023 starting one element into A's storage (f32): every
            row starts at another offset from a 16-byte boundary;
  dense_sim 2^20 x 4096 (S_sim's dense copy, phase 7's exact DIMSUM), f32.

Each is held against ``tsgram_plain`` (normwise relative error at most
5e-4, symmetric, two runs the same bits) and timed beside one PyTorch call
for the same function, ``torch.mm(a.T, a)``: the median of REPS launches by
CUDA events after two warm launches, and, as ``stream_ms``, the mean of 10
launches queued back to back.  One JSON line per case, with the bound (one
read of A and one write of G at 3.35 TB/s, or the flops at the route's
peak: m n (n + 1) for the distinct entries, three TF32 products each at
495 TFLOP/s for f32, one bf16 product at 989 for bf16; for f32 also the
bound of f32 FMA on the CUDA cores at 67) and the card's name and power
limit from nvidia-smi.  Exits non-zero if a check fails.
"""
import argparse
import json
import statistics
import subprocess
import sys

import torch

M, N = 1 << 21, 1024
M_SIM, N_SIM = 1 << 20, 4096
REPS = 5
from repro_torch.launch.machine import (BF16_FLOPS, F32_FMA_FLOPS,
                                       HBM_BYTES_PER_S, TF32_FLOPS)
TOL = 5e-4


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


def bounds(m: int, n: int, dtype) -> dict:
    t_bytes = (m * n * (2 if dtype == torch.bfloat16 else 4)
               + 4 * n * n) / HBM_BYTES_PER_S * 1e3
    flops = float(m) * n * (n + 1)
    if dtype == torch.bfloat16:
        t_ops = flops / BF16_FLOPS * 1e3
        extra = {}
    else:
        t_ops = 3 * flops / TF32_FLOPS * 1e3
        extra = {"bound_cuda_core_ms": max(t_bytes,
                                           flops / F32_FMA_FLOPS * 1e3)}
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **extra}


def measure(ts, a: torch.Tensor, name: str, label: str, card: str) -> bool:
    got = ts.tsgram(a, out_dtype=torch.float32)
    err = rel_err(got, ts.tsgram_plain(a, torch.float32))
    same = torch.equal(got, ts.tsgram(a, out_dtype=torch.float32))
    sym = torch.equal(got, got.T)
    m, n = a.shape

    def kernel():
        return ts.tsgram(a, out_dtype=torch.float32)

    def library():
        return torch.mm(a.T, a)

    ms = time_ms(kernel)
    b = bounds(m, n, a.dtype)
    print(json.dumps({
        "label": label, "case": name, "shape": [m, n],
        "dtype": "bf16" if a.dtype == torch.bfloat16 else "f32",
        "ms": ms, "library_ms": time_ms(library),
        "stream_ms": stream_ms(kernel), "library_stream_ms": stream_ms(library),
        **b, "bound_share": b["bound_ms"] / ms,
        "rel_err": err, "same_bits": same, "symmetric": sym, "card": card}),
        flush=True)
    return err <= TOL and same and sym


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_tsgram: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import tsgram as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(M, N, generator=gen, device=dev)
    ok = measure(ts, a, "A", args.label, card)
    ragged = a.view(-1)[1:1 + M * (N - 1)].view(M, N - 1)
    ok = measure(ts, ragged, "ragged", args.label, card) and ok
    del ragged
    ab = a.to(torch.bfloat16)
    del a
    ok = measure(ts, ab, "A", args.label, card) and ok
    del ab
    torch.cuda.empty_cache()
    d = torch.randn(M_SIM, N_SIM, generator=gen, device=dev)
    ok = measure(ts, d, "dense_sim", args.label, card) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
