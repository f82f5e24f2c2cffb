#!/usr/bin/env python3
"""Time the port's randsketch kernel at the randomized SVD's shape on one card.

    PYTHONPATH=src python3 tools/time_randsketch.py [--label NAME]

Imports ``repro_torch`` from PYTHONPATH, so one call can time two trees of
the port on the same card: unpack the other tree (``git archive``) under
``build/`` and run this script once with each tree's ``src`` on PYTHONPATH,
in the order A, B, B, A.  The shape is chip_smoke.py's A_w, 2^18 x 16384,
sketched at r = 26 (k = 16 plus 10 oversampling columns), with A and Q
drawn from a seed.  In f32 and in bf16 (A_w's bf16 copy), four views of
the same storage, none copied:

  aligned   A_w itself;
  ragged    2^18 x 16383 starting one element into A_w's storage: every
            row starts at another offset from a 16-byte boundary;
  odd       2^18 x 16383 starting at A_w's start: the rows' offsets vary,
            the first is 0;
  shifted   2^18 x 16380 starting one element in: every row has the same
            offset, one element.

Each is held against ``randsketch_plain`` (normwise relative error at most
1e-4, and two runs the same bits) and timed beside one PyTorch call for the
same function, ``torch.mm(a.T, q)`` with q in a's type: the median of REPS
launches by CUDA events after two warm launches, and, as ``stream_ms``,
the mean of 20 launches queued back to back.  One JSON line per view and
type, with the bound (one read of A and Q and one write of B at 3.35 TB/s,
or 2mnr flops at the type's peak, whichever is larger) and the card's name
and power limit from nvidia-smi.  Exits non-zero if a check fails.
"""
import argparse
import json
import statistics
import subprocess
import sys

import torch

M, N, R = 1 << 18, 16384, 26
REPS = 10
from repro_torch.launch.machine import (BF16_FLOPS, F32_FMA_FLOPS,
                                       HBM_BYTES_PER_S)
PEAK_FLOPS = {torch.float32: F32_FMA_FLOPS, torch.bfloat16: BF16_FLOPS}
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


def stream_ms(fn, n: int = 20) -> float:
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


def views(a: torch.Tensor) -> dict:
    flat = a.view(-1)
    return {"aligned": a,
            "ragged": flat[1:1 + M * (N - 1)].view(M, N - 1),
            "odd": flat[:M * (N - 1)].view(M, N - 1),
            "shifted": flat[1:1 + M * (N - 4)].view(M, N - 4)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_randsketch: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import randsketch as rs

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    a32 = torch.randn(M, N, generator=gen, device=dev)
    q = torch.randn(M, R, generator=gen, device=dev)
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        a = a32 if dtype == torch.float32 else a32.to(dtype)
        if dtype != torch.float32:
            del a32
            torch.cuda.empty_cache()
        qc = q.to(dtype)
        for name, x in views(a).items():
            got = rs.randsketch(x, q, out_dtype=torch.float32)
            err = rel_err(got, rs.randsketch_plain(x, q, torch.float32))
            same = torch.equal(got, rs.randsketch(x, q,
                                                  out_dtype=torch.float32))
            ok = ok and err <= TOL and same
            m, n = x.shape
            t_bytes = (m * n * x.element_size() + 4 * R * (m + n)) \
                / HBM_BYTES_PER_S * 1e3
            t_ops = 2.0 * m * n * R / PEAK_FLOPS[dtype] * 1e3

            def kernel(x=x):
                return rs.randsketch(x, q, out_dtype=torch.float32)

            def library(x=x):
                return torch.mm(x.T, qc)

            ms = time_ms(kernel)
            print(json.dumps({
                "label": args.label, "view": name, "shape": [m, n, R],
                "start_offset_elements": (x.data_ptr() - a.data_ptr())
                // x.element_size(),
                "dtype": "bf16" if dtype == torch.bfloat16 else "f32",
                "ms": ms, "library_ms": time_ms(library),
                "stream_ms": stream_ms(kernel),
                "library_stream_ms": stream_ms(library),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_share": max(t_bytes, t_ops) / ms,
                "rel_err": err, "same_bits": same, "card": card}),
                flush=True)
            del got
        del a, qc
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
