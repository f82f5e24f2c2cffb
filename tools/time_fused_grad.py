#!/usr/bin/env python3
"""Time the port's fused_grad kernel at several widths on one card.

    PYTHONPATH=src python3 tools/time_fused_grad.py [--label NAME] [--slots K]

Imports ``repro_torch`` from PYTHONPATH, so one call can time two trees of
the port on the same card: unpack the other tree (``git archive``) under
``build/`` and run this script once with each tree's ``src`` on PYTHONPATH,
in the order A, B, B, A.  For each shape, in f32 and bf16 storage and the
quad loss, the kernel is held against ``fused_grad_plain`` (normwise
relative error of g at most 5e-4) and timed: the median of REPS launches by
CUDA events after two warm launches.  With ``--slots K`` the same for
``fused_grad_multi`` with K slots (against ``fused_grad_multi_plain``).
One JSON line per shape and storage, with the bound (the bytes of A, X, T,
W, Z, G and f at 3.35 TB/s, or 4mnK flops at the storage type's peak,
whichever is larger) and the card's name and power limit from nvidia-smi.
"""
import argparse
import json
import statistics
import subprocess
import sys

import torch

# (m, n): the main path's A, then wider rows at about the same bytes, up to
# the randomized SVD's A_w (2^18 x 16384).
SHAPES = [(1 << 21, 1024), (1 << 20, 2048), (1 << 19, 4096),
          (1 << 18, 8192), (1 << 18, 16384)]
REPS = 10
from repro_torch.launch.machine import (BF16_FLOPS, F32_FMA_FLOPS,
                                       HBM_BYTES_PER_S)
PEAK_FLOPS = {torch.float32: F32_FMA_FLOPS, torch.bfloat16: BF16_FLOPS}


def time_ms(fn) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-300))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="")
    parser.add_argument("--slots", type=int, default=1,
                        help="time fused_grad_multi with this many slots "
                        "(1: fused_grad)")
    args = parser.parse_args()
    k = args.slots
    if not torch.cuda.is_available():
        print("time_fused_grad: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import fusedgrad

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for m, n in SHAPES:
        A = torch.randn(m, n, generator=gen, device=dev) / n ** 0.5
        shape = (n,) if k == 1 else (k, n)
        x = torch.randn(shape, generator=gen, device=dev)
        t = torch.randn(shape[:-1] + (m,), generator=gen, device=dev)
        w = torch.rand(shape[:-1] + (m,), generator=gen, device=dev)
        kernel, plain = ((fusedgrad.fused_grad, fusedgrad.fused_grad_plain)
                         if k == 1 else (fusedgrad.fused_grad_multi,
                                         fusedgrad.fused_grad_multi_plain))
        for a in (A, A.to(torch.bfloat16)):
            got = kernel(a, x, t, w, loss="quad")
            want = plain(a, x, t, w, loss="quad")
            err = rel_err(got[1], want[1])
            ok = ok and err <= 5e-4
            nbytes = m * n * a.element_size() + 4 * k * (n + 2 * m) \
                + 4 * k * (m + n + 1)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 4.0 * m * n * k / PEAK_FLOPS[a.dtype] * 1e3
            print(json.dumps({
                "label": args.label, "m": m, "n": n, "slots": k,
                "storage": "f32" if a.dtype == torch.float32 else "bf16",
                "ms": time_ms(lambda: kernel(a, x, t, w, loss="quad")),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "g_rel_err": err, "card": card}), flush=True)
            del got, want
        del A, a
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
