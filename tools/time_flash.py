#!/usr/bin/env python3
"""Time the port's flash_attention kernel at the LM prefill's shape on one card.

    PYTHONPATH=src python3 tools/time_flash.py [--label NAME]

Imports ``repro_torch`` from PYTHONPATH, so one call can time two trees of
the port on the same card: unpack the other tree (``git archive``) under
``build/`` and run this script once with each tree's ``src`` on PYTHONPATH,
in the order A, B, B, A.  The shape is llama3.2-3b's prefill of 4 prompts
of 2048 tokens: q (4 · 24, 2048, 128) against k, v (4 · 8, 2048, 128),
three q heads a KV head, causal, with inputs drawn from a seed.  In bf16
(the path's type) and f32, the kernel is held against
``flash_attention_plain`` (normwise relative error at most 1e-2 in bf16,
where the kernel rounds p to bf16 before PV and the plain version does not,
and 1e-4 in f32) and timed beside the plain version and one PyTorch call
for the same function (``scaled_dot_product_attention`` with
``is_causal`` and ``enable_gqa``): the median of REPS launches by CUDA
events after two warm launches; and, as ``stream_ms``, the mean of 20
launches queued back to back, kernel and library alike, where the host's
time per call hides behind the queue.  One JSON line per dtype, with the
bound (4·D flops a live query–key pair at the dtype's peak, or one read of
q, k, v and one write of o at 3.35 TB/s, whichever is larger) and the
card's name and power limit from nvidia-smi.
"""
import argparse
import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

B, HQ, HKV, S, D = 4, 24, 8, 2048, 128
REPS = 10
from repro_torch.launch.machine import (BF16_FLOPS, F32_FMA_FLOPS,
                                       HBM_BYTES_PER_S)
PEAK_FLOPS = {torch.float32: F32_FMA_FLOPS, torch.bfloat16: BF16_FLOPS}
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


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
    """Mean device time of `n` launches queued back to back: the host's
    own time per call hides behind the queue where it is shorter."""
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    g = HQ // HKV
    q = torch.randn(B * HQ, S, D, generator=gen, device=dev)
    k = torch.randn(B * HKV, S, D, generator=gen, device=dev)
    v = torch.randn(B * HKV, S, D, generator=gen, device=dev)
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))

        def kernel():
            return fa.flash_attention(qd, kd, vd, q_heads_per_kv=g)

        def plain():
            return fa.flash_attention_plain(qd, kd, vd, q_heads_per_kv=g)

        q4, k4, v4 = (t.reshape(B, -1, S, D) for t in (qd, kd, vd))

        def library():
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                  enable_gqa=True)

        err = rel_err(kernel(), plain())
        ok = ok and err <= TOL[dtype]
        nbytes = (2 * qd.numel() + 2 * kd.numel()) * qd.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 4.0 * D * B * HQ * S * (S + 1) / 2 / PEAK_FLOPS[dtype] * 1e3
        ms = time_ms(kernel)
        print(json.dumps({
            "label": args.label, "shape": [B * HQ, S, D], "group": g,
            "dtype": "bf16" if dtype == torch.bfloat16 else "f32",
            "ms": ms, "plain_ms": time_ms(plain, reps=3),
            "library_ms": time_ms(library),
            "stream_ms": stream_ms(kernel),
            "library_stream_ms": stream_ms(library),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_share": max(t_bytes, t_ops) / ms,
            "rel_err": err, "card": card}), flush=True)
        del qd, kd, vd, q4, k4, v4
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
