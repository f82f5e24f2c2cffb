#!/usr/bin/env python3
"""Device time of each kernel that one fused_grad_multi call launches.

    PYTHONPATH=src python3 tools/profile_fused_grad.py [--label NAME]
        [--slots K ...] [--shape M N ...]

Imports ``repro_torch`` from PYTHONPATH, so one call can profile two trees
of the port on the same card (unpack the other under ``build/``).  For each
shape, storage (f32, bf16) and slot count, after two warm calls, REPS calls
run under torch.profiler; the device time of every CUDA kernel they
launched (the sweep kernel and the reduction of the per-block partials) is
averaged over the calls.  One JSON line each, with the card's name and
power limit from nvidia-smi.
"""
import argparse
import json
import subprocess
import sys

import torch

REPS = 10
SHAPES = [(1 << 20, 2048), (1 << 18, 16384)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="")
    parser.add_argument("--slots", type=int, nargs="+", default=[1, 8])
    parser.add_argument("--shape", type=int, nargs=2, action="append")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_fused_grad: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import fusedgrad

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, n in args.shape or SHAPES:
        A = torch.randn(m, n, generator=gen, device=dev) / n ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            a = A.to(dtype)
            for k in args.slots:
                x = torch.randn(k, n, generator=gen, device=dev)
                t = torch.randn(k, m, generator=gen, device=dev)
                w = torch.ones(k, m, device=dev)

                def call():
                    fusedgrad.fused_grad_multi(a, x, t, w, loss="quad")

                call()
                call()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(REPS):
                        call()
                    torch.cuda.synchronize()
                kernels = {}
                for ev in prof.key_averages():
                    us = getattr(ev, "device_time_total", None)
                    if us is None:
                        us = getattr(ev, "cuda_time_total", 0.0)
                    if us > 0 and ev.count >= REPS:
                        kernels[ev.key[:80]] = us / REPS / 1e3
                print(json.dumps({"label": args.label, "m": m, "n": n,
                                  "storage": str(dtype).split(".")[-1],
                                  "slots": k, "kernel_ms": kernels,
                                  "card": card}), flush=True)
                del x, t, w
            del a
        del A
    return 0


if __name__ == "__main__":
    sys.exit(main())
