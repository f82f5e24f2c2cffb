#!/usr/bin/env python3
"""Time the port's bsr_matmul kernel on the sparse path's matrix on one card.

    PYTHONPATH=src python3 tools/time_bsr_matmul.py [--label NAME]

Imports ``repro_torch`` from PYTHONPATH, so one call can time two trees of
the port on the same card: unpack the other tree (``git archive``) under
``build/`` and run this script once with each tree's ``src`` on PYTHONPATH,
in the order A, B, B, A.  The matrix is chip_smoke.py's S: 2^22 x 2^14 in
32 x 32 blocks, 16 a block-row, block columns drawn from a Zipf(1) law
(Gumbel top-k, sorted), Gaussian entries, built on the card from a seed;
in f32, bf16 and int8 storage (per-block scales).  Y = S X at nx = 16 (U
recovery of the Lanczos SVD) and nx = 8 (the int8 group pass at 8 slots).

Each case is held against ``bsr_matmul_plain`` (normwise relative error at
most 1e-4, two runs the same bits) and timed beside one PyTorch call for
the same function where there is one (``torch.sparse_bsr_tensor @ X``;
none for int8): the median of REPS launches by CUDA events after two warm
launches, and, as ``stream_ms``, the mean of 20 launches queued back to
back.  One JSON line per case, with the bound (the stored blocks, cols,
scales, X and Y once at 3.35 TB/s, or 2 nx flops a stored element at 67
TFLOP/s, whichever is larger) and the card's name and power limit from
nvidia-smi.  Exits non-zero if a check fails.
"""
import argparse
import json
import statistics
import subprocess
import sys

import torch

M, N, BS, ELL = 1 << 22, 1 << 14, 32, 16
NXS = (16, 8)
REPS = 10
from repro_torch.launch.machine import F32_FMA_FLOPS, HBM_BYTES_PER_S
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


def sparse_matrix(bsr, dev):
    """S as chip_smoke.py builds it (seed 3)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    nbr, nbc = M // BS, N // BS
    logp = -torch.log(torch.arange(1, nbc + 1, device=dev,
                                   dtype=torch.float32))
    cols = torch.empty((nbr, ELL), dtype=torch.int32, device=dev)
    step = 1 << 14
    for i in range(0, nbr, step):
        u = torch.rand(min(step, nbr - i), nbc, generator=gen, device=dev)
        keys = logp - torch.log(-torch.log(u.clamp_min(1e-30)))
        top = keys.topk(ELL, dim=1).indices
        cols[i:i + step] = torch.sort(top, dim=1).values.to(torch.int32)
    data = torch.randn((nbr, ELL, BS, BS), generator=gen, device=dev)
    return bsr.BlockELL(data, cols, (M, N))


def library_call(a, X):
    """torch's BSR product of the same blocks, or None (int8 storage)."""
    if a.scales is not None:
        return None
    nbr, ell = a.cols.shape
    crow = torch.arange(0, nbr * ell + 1, ell, device=a.data.device)
    lib = torch.sparse_bsr_tensor(crow, a.cols.reshape(-1).long(),
                                  a.data.reshape(-1, a.bs, a.bs),
                                  size=a.shape)
    Xc = X.to(a.data.dtype)
    try:
        lib @ Xc
    except (RuntimeError, NotImplementedError, TypeError):
        return None
    return lambda: lib @ Xc


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_bsr_matmul: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import bsr

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    s32 = sparse_matrix(bsr, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    ok = True
    for storage in ("f32", "bf16", "int8"):
        a = {"f32": lambda: s32,
             "bf16": lambda: bsr.BlockELL(s32.data.to(torch.bfloat16),
                                          s32.cols, s32.shape),
             "int8": s32.quantize_int8}[storage]()
        for nx in NXS:
            X = torch.randn(N, nx, generator=gen, device=dev)
            got = bsr.bsr_matmul(a, X)
            err = rel_err(got, bsr.bsr_matmul_plain(a, X))
            same = torch.equal(got, bsr.bsr_matmul(a, X))
            ok = ok and err <= TOL and same
            elems = a.data.numel()
            nbytes = (elems * a.data.element_size() + 4 * a.cols.numel()
                      + (0 if a.scales is None else 4 * a.scales.numel())
                      + 4 * nx * (M + N))
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 2.0 * nx * elems / F32_FMA_FLOPS * 1e3

            def kernel(a=a, X=X):
                return bsr.bsr_matmul(a, X)

            lib = library_call(a, X)
            ms = time_ms(kernel)
            print(json.dumps({
                "label": args.label, "storage": storage, "nx": nx,
                "shape": [M, N, BS, ELL], "ms": ms,
                "library_ms": time_ms(lib) if lib else None,
                "stream_ms": stream_ms(kernel),
                "library_stream_ms": stream_ms(lib) if lib else None,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_share": max(t_bytes, t_ops) / ms,
                "rel_err": err, "same_bits": same, "card": card}),
                flush=True)
            del got, X, lib
        if storage != "f32":
            del a
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
