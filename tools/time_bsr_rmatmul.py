#!/usr/bin/env python3
"""Time the port's bsr_rmatmul kernel (Y = AᵀX) on the sparse paths' matrices.

    PYTHONPATH=src python3 tools/time_bsr_rmatmul.py [--label NAME]

Imports ``repro_torch`` from PYTHONPATH, so one call can time two trees of
the port on the same card: unpack the other tree (``git archive``) under
``build/`` and run this script once with each tree's ``src`` on PYTHONPATH,
in the order A, B, B, A.  The matrices are chip_smoke.py's: S, 2^22 x 2^14
in 32 x 32 blocks, 16 a block-row, block columns from a Zipf(1) law over
512 (seed 3), in f32, bf16 and int8 storage, at nx = 1 (the Lanczos
operator), 8 (the int8 group pass at 8 slots) and 16; then at nx = 512 on
S in f32 and on the first 512-column strip of S_sim (2^20 x 2^12, Zipf(1)
over 128 block columns, 64 planted column pairs; seed 5), a strip of the
sparse Gram of phase 7's DIMSUM.

Each case is held against ``bsr_rmatmul_plain`` (normwise relative error at
most 5e-4, two runs the same bits) and timed: the median of REPS launches
by CUDA events after two warm launches (3 at nx = 512), and, as
``stream_ms``, the mean of launches queued back to back.  Beside it, where
there is one, one PyTorch call for the same function: torch's BSR product
``torch.sparse_bsr_tensor(Aᵀ) @ X`` on a transpose of the blocks stored
once before the timing (f32 and bf16 at nx = 1, 16 and 512; none for int8,
which torch's BSR product does not take); ``library_note`` says why a call
has no time.  One JSON line per case, with the bound (the stored blocks,
cols, scales, X and Y once at 3.35 TB/s, or 2 nx flops a stored element at
67 TFLOP/s, whichever is larger), the bound of the kernel's own route (3
TF32 products a product at 495 TFLOP/s for f32 blocks, 2 for bf16 and
int8), and the card's name and power limit from nvidia-smi.  Exits non-zero
if a check fails.
"""
import argparse
import json
import math
import statistics
import subprocess
import sys

import torch

M, N, BS, ELL = 1 << 22, 1 << 14, 32, 16
M_SIM, N_SIM, PLANTED = 1 << 20, 1 << 12, 64
NXS = (1, 8, 16)
LIBRARY_NXS = (1, 16, 512)
WIDE = 512
REPS = 10
from repro_torch.launch.machine import (F32_FMA_FLOPS, HBM_BYTES_PER_S,
                                       TF32_FLOPS)
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


def zipf_columns(nbr: int, nbc: int, gen, dev) -> torch.Tensor:
    """chip_smoke.py's block pattern: ELL block columns a block-row from a
    Zipf(1) law over nbc (Gumbel top-k), sorted."""
    logp = -torch.log(torch.arange(1, nbc + 1, device=dev,
                                   dtype=torch.float32))
    cols = torch.empty((nbr, ELL), dtype=torch.int32, device=dev)
    step = 1 << 14
    for i in range(0, nbr, step):
        u = torch.rand(min(step, nbr - i), nbc, generator=gen, device=dev)
        keys = logp - torch.log(-torch.log(u.clamp_min(1e-30)))
        top = keys.topk(ELL, dim=1).indices
        cols[i:i + step] = torch.sort(top, dim=1).values.to(torch.int32)
    return cols


def sparse_matrix(bsr, dev):
    """S as chip_smoke.py builds it (seed 3)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    cols = zipf_columns(M // BS, N // BS, gen, dev)
    data = torch.randn((M // BS, ELL, BS, BS), generator=gen, device=dev)
    return bsr.BlockELL(data, cols, (M, N))


def similarity_matrix(dev):
    """S_sim as chip_smoke.py builds it (seed 5, planted pairs), as a
    SparseRowMatrix."""
    from repro_torch.core.distmat import SparseRowMatrix

    gen = torch.Generator(device=dev).manual_seed(5)
    nbr = M_SIM // BS
    cols = zipf_columns(nbr, N_SIM // BS, gen, dev)
    data = torch.randn((nbr, ELL, BS, BS), generator=gen, device=dev)
    for p in range(PLANTED):
        c, u = 2 * p, 2 * (p % 16)
        rows, slots = torch.nonzero(cols == c, as_tuple=True)
        blk = data[rows, slots]
        blk[:, :, u + 1] = 0.9 * blk[:, :, u] \
            + math.sqrt(0.19) * blk[:, :, u + 1]
        data[rows, slots] = blk
    return SparseRowMatrix(data, cols, dims=(M_SIM, N_SIM), nnz=data.numel())


def transposed_library(a):
    """torch.sparse_bsr_tensor of Aᵀ (blocks transposed and regrouped by
    block column, stored once), or None for int8 blocks."""
    if a.scales is not None:
        return None
    flat = a.cols.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    nbc = a.shape[1] // a.bs
    crow = torch.zeros(nbc + 1, dtype=torch.long, device=flat.device)
    crow[1:] = torch.cumsum(torch.bincount(flat, minlength=nbc), 0)
    vals = a.data.reshape(-1, a.bs, a.bs)[order].transpose(1, 2).contiguous()
    return torch.sparse_bsr_tensor(crow, order // a.ell, vals,
                                   size=(a.shape[1], a.shape[0]))


def library_case(lib, X, reps):
    """(ms, stream ms, note) of lib @ X in lib's dtype."""
    if lib is None:
        return None, None, "int8 blocks: torch's BSR product takes no int8"
    Xc = X.to(lib.dtype)
    try:
        lib @ Xc
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        torch.cuda.synchronize()
        return None, None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    fn = lambda: lib @ Xc  # noqa: E731
    return time_ms(fn, reps), stream_ms(fn, 20 if reps == REPS else 3), None


def measure(bsr, a, X, label, what, card, lib):
    nx = X.shape[1]
    got = bsr.bsr_rmatmul(a, X)
    err = rel_err(got, bsr.bsr_rmatmul_plain(a, X))
    same = torch.equal(got, bsr.bsr_rmatmul(a, X))
    del got
    elems = a.data.numel()
    nbytes = (elems * a.data.element_size() + 4 * a.cols.numel()
              + (0 if a.scales is None else 4 * a.scales.numel())
              + 4 * nx * (a.shape[0] + a.shape[1]))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * nx * elems / F32_FMA_FLOPS * 1e3
    products = 3 if a.data.dtype == torch.float32 else 2
    t_route = products * 2.0 * nx * elems / TF32_FLOPS * 1e3
    reps = REPS if nx < WIDE else 3
    fn = lambda: bsr.bsr_rmatmul(a, X)  # noqa: E731
    ms = time_ms(fn, reps)
    lib_ms, lib_stream, note = (library_case(lib, X, reps)
                                if nx in LIBRARY_NXS else (None, None, None))
    print(json.dumps({
        "label": label, "case": what, "storage": str(a.data.dtype),
        "nx": nx, "shape": [a.shape[0], a.shape[1], a.bs, a.ell], "ms": ms,
        "stream_ms": stream_ms(fn, 20 if nx < WIDE else 3),
        "library_ms": lib_ms, "library_stream_ms": lib_stream,
        "library_note": note,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_share": max(t_bytes, t_ops) / ms,
        "route_bound_ms": max(t_bytes, t_route), "rel_err": err,
        "same_bits": same, "card": card}), flush=True)
    return err <= TOL and same


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_bsr_rmatmul: no CUDA device", file=sys.stderr)
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
        lib = transposed_library(a)
        for nx in NXS:
            X = torch.randn(M, nx, generator=gen, device=dev)
            ok = measure(bsr, a, X, args.label, "S", card, lib) and ok
            del X
        del lib
        if storage != "f32":
            del a
        torch.cuda.empty_cache()
    lib = transposed_library(s32)
    X = torch.randn(M, WIDE, generator=gen, device=dev)
    ok = measure(bsr, s32, X, args.label, "S", card, lib) and ok
    del X, lib, s32
    torch.cuda.empty_cache()
    sim = similarity_matrix(dev)
    a = sim._local()
    strip = sim._dense_columns(0, WIDE)
    lib = transposed_library(a)
    ok = measure(bsr, a, strip, args.label, "S_sim strip 0", card, lib) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
