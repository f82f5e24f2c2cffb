#!/usr/bin/env python3
"""Time the port's gemm kernel at the shapes its paths give it, on one card.

    PYTHONPATH=src python3 tools/time_gemm.py [--label NAME]

Imports ``repro_torch`` from PYTHONPATH, so one call can time two trees of
the port on the same card: unpack the other tree (``git archive``) under
``build/`` and run this script once with each tree's ``src`` on PYTHONPATH,
in the order A, B, B, A.  Cases, with every operand drawn from a seed and C
in f32:

  A      2^21 x 1024 times 1024 x 16 (chip_smoke.py's A: U = A (V S^-1) of
         the Gram SVD), A in f32 and in bf16, B in f32;
  A_w    2^18 x 16384 times 16384 x 26 (the randomized SVD's Y = A_w Z at
         k + p = 26), A in f32 and in bf16;
  tsqr   2^18 x 26 times 26 x 26 (TSQR's Q = Y R^-1 on that Y), f32.

Each is held against ``gemm_plain`` (normwise relative error at most 1e-4,
two runs the same bits) and timed beside one PyTorch call for the same
function, ``torch.mm(a, b)`` with b in a's dtype: the median of REPS
launches by CUDA events after two warm launches, and, as ``stream_ms``, the
mean of 10 launches queued back to back.  One JSON line per case, with the
bound (one read of A and B and one write of C at 3.35 TB/s, or the flops
on the kernel's route, 2 m K N a TF32 product at 495 TFLOP/s: three
products for f32 A, two for bf16 A against f32 B) and the card's name and
power limit from nvidia-smi.  Exits non-zero if a check fails.
"""
import argparse
import json
import statistics
import subprocess
import sys

import torch

M, N = 1 << 21, 1024
M_W, N_W = 1 << 18, 16384
K_U, K_SKETCH = 16, 26
REPS = 10
from repro_torch.launch.machine import HBM_BYTES_PER_S, TF32_FLOPS
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


def bounds(a: torch.Tensor, b: torch.Tensor) -> dict:
    (m, k), n = a.shape, b.shape[1]
    t_bytes = (m * k * a.element_size() + k * n * b.element_size()
               + 4 * m * n) / HBM_BYTES_PER_S * 1e3
    products = (3 if a.dtype == torch.float32 else 2)
    t_ops = products * 2.0 * m * k * n / TF32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def measure(gm, a: torch.Tensor, b: torch.Tensor, name: str, label: str,
            card: str) -> bool:
    got = gm.gemm(a, b, out_dtype=torch.float32)
    err = rel_err(got, gm.gemm_plain(a, b, torch.float32))
    same = torch.equal(got, gm.gemm(a, b, out_dtype=torch.float32))
    del got
    bc = b.to(a.dtype)

    def kernel():
        return gm.gemm(a, b, out_dtype=torch.float32)

    def library():
        return torch.mm(a, bc)

    ms = time_ms(kernel)
    bd = bounds(a, b)
    print(json.dumps({
        "label": label, "case": name, "shape": [*a.shape, b.shape[1]],
        "dtype": "bf16" if a.dtype == torch.bfloat16 else "f32",
        "ms": ms, "library_ms": time_ms(library),
        "stream_ms": stream_ms(kernel), "library_stream_ms": stream_ms(library),
        **bd, "bound_share": bd["bound_ms"] / ms,
        "rel_err": err, "same_bits": same, "card": card}), flush=True)
    return err <= TOL and same


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_gemm: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import gemm as gm

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for (m, k, n), name in (((M, N, K_U), "A"), ((M_W, N_W, K_SKETCH), "A_w")):
        a = torch.randn(m, k, generator=gen, device=dev)
        b = torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
        ok = measure(gm, a, b, name, args.label, card) and ok
        ab = a.to(torch.bfloat16)
        del a
        ok = measure(gm, ab, b, name, args.label, card) and ok
        del ab
        torch.cuda.empty_cache()
    y = torch.randn(M_W, K_SKETCH, generator=gen, device=dev)
    r_inv = torch.randn(K_SKETCH, K_SKETCH, generator=gen,
                        device=dev).triu() / K_SKETCH ** 0.5
    ok = measure(gm, y, r_inv, "tsqr", args.label, card) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
