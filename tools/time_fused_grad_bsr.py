#!/usr/bin/env python3
"""Time the port's fused_grad_bsr kernel on the sparse path's matrix on one card.

    PYTHONPATH=src python3 tools/time_fused_grad_bsr.py [--label NAME]

Imports ``repro_torch`` from PYTHONPATH, so one call can time two trees of
the port on the same card: unpack the other tree (``git archive``) under
``build/`` and run this script once with each tree's ``src`` on PYTHONPATH,
in the order A, B, B, A.  The matrix is chip_smoke.py's S: 2^22 x 2^14 in
32 x 32 blocks, 16 a block-row, block columns drawn from a Zipf(1) law
(Gumbel top-k, sorted), Gaussian entries, built on the card from a seed;
in f32 and bf16 storage.  For every loss, ``fused_grad_bsr`` (one request)
and ``fused_grad_bsr_multi`` with one slot (the group kernel at k = 1) on
the same x, t, w.

Each call is held against ``fused_grad_bsr_plain`` (normwise relative error
at most 1e-4 for f and z, 5e-4 for g; two runs the same bits) and timed:
the median of REPS launches by CUDA events after two warm launches, and,
as ``stream_ms``, the mean of 20 launches queued back to back.
``same_bits_as_multi`` says whether the two kernels gave the same f, g and
z.  One JSON line per storage, loss and kernel, with the bound (the stored
blocks and cols, x, t, w, z and g once at 3.35 TB/s, or 4 flops a stored
element at 67 TFLOP/s, whichever is larger) and the card's name and power
limit from nvidia-smi.

Then the int8 group pass at k = 8 and 40 slots (quad loss): what
``ops.fused_grad_bsr_multi`` runs for S's int8 copy, bsr_matmul at nx = k,
the row losses and bsr_rmatmul at nx = k, held against
``fused_grad_bsr_multi_plain`` and timed as above; and, on the same (k, m)
row losses, the two ways of summing each slot's loss, one reduction of
the whole tensor (``le.sum(dim=1)``) and one a slot
(``torch.stack([row.sum() for row in le])``).  Exits non-zero if a check
fails.
"""
import argparse
import json
import math
import statistics
import subprocess
import sys

import torch

M, N, BS, ELL = 1 << 22, 1 << 14, 32, 16
REPS = 10
from repro_torch.launch.machine import F32_FMA_FLOPS, HBM_BYTES_PER_S
TOL = {"f": 1e-4, "g": 5e-4, "z": 1e-4}
GROUP_SLOTS = (8, 40)


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


def targets(loss: str, z: torch.Tensor, gen) -> torch.Tensor:
    """Targets of the loss's kind near z (chip_smoke.py's targets)."""
    if loss == "logistic":
        return torch.where(z + torch.randn(z.shape, generator=gen,
                                           device=z.device) > 0, 1.0, -1.0)
    if loss == "poisson":
        return torch.poisson(torch.exp(0.3 * z), generator=gen)
    return z + 0.5 * torch.randn(z.shape, generator=gen, device=z.device)


def int8_group_pass(s32, label: str, card: str, gen) -> bool:
    """The int8 group pass at GROUP_SLOTS slots, beside its two ways of
    summing the slots' losses."""
    from repro_torch.kernels import fusedgrad, ops

    a = s32.quantize_int8()
    ok = True
    for k in GROUP_SLOTS:
        x = torch.randn(k, N, generator=gen, device=a.data.device) \
            / math.sqrt(ELL * BS)
        t = torch.randn(k, M, generator=gen, device=x.device)
        w = torch.rand(k, M, generator=gen, device=x.device)

        def run(x=x, t=t, w=w):
            return ops.fused_grad_bsr_multi(a, x, t, w, loss="quad")

        got = run()
        want = fusedgrad.fused_grad_bsr_multi_plain(a, x, t, w, loss="quad")
        errs = {q: rel_err(u, v) for q, u, v in zip("fgz", got, want)}
        same = all(torch.equal(u, v) for u, v in zip(got, run()))
        ok = ok and same and all(errs[q] <= TOL[q] for q in errs)
        del got, want
        z = ops.bsr_matmul(a, x.T).T
        le, _ = fusedgrad.row_loss_elem(z, t, w, "quad", 1.0)
        del z
        sums = {"sum_dim1": lambda le=le: le.sum(dim=1),
                "sum_per_slot": lambda le=le: torch.stack(
                    [row.sum() for row in le])}
        print(json.dumps({
            "label": label, "kernel": "int8_group_pass", "storage": "int8",
            "loss": "quad", "slots": k, "shape": [M, N, BS, ELL],
            "ms": time_ms(run), "stream_ms": stream_ms(run),
            **{f"{name}_ms": time_ms(fn) for name, fn in sums.items()},
            "rel_err": errs, "same_bits": same, "card": card}), flush=True)
        del x, t, w, le
        torch.cuda.empty_cache()
    return ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_fused_grad_bsr: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import bsr, fusedgrad

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    s32 = sparse_matrix(bsr, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(N, generator=gen, device=dev) / math.sqrt(ELL * BS)
    w = torch.rand(M, generator=gen, device=dev)
    z0 = bsr.bsr_matvec_plain(s32, x)
    tgt = {loss: targets(loss, z0, gen) for loss in fusedgrad.LOSSES}
    del z0
    ok = True
    for storage in ("f32", "bf16"):
        a = s32 if storage == "f32" else bsr.BlockELL(
            s32.data.to(torch.bfloat16), s32.cols, s32.shape)
        elems = a.data.numel()
        nbytes = (elems * a.data.element_size() + 4 * a.cols.numel()
                  + 4 * (2 * N + 3 * M + 1))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 4.0 * elems / F32_FMA_FLOPS * 1e3
        for loss in fusedgrad.LOSSES:
            t = tgt[loss]
            want = fusedgrad.fused_grad_bsr_plain(a, x, t, w, loss=loss,
                                                  param=0.5)

            def one(a=a, t=t, loss=loss):
                return fusedgrad.fused_grad_bsr(a, x, t, w, loss=loss,
                                                param=0.5)

            def multi(a=a, t=t, loss=loss):
                f, g, z = fusedgrad.fused_grad_bsr_multi(
                    a, x[None], t[None], w[None], loss=loss, param=0.5)
                return f[0], g[0], z[0]

            outs = {}
            for name, fn in (("fused_grad_bsr", one),
                             ("fused_grad_bsr_multi_k1", multi)):
                got = fn()
                errs = {q: rel_err(u, v) for q, u, v in zip("fgz", got, want)}
                same = all(torch.equal(u, v) for u, v in zip(got, fn()))
                ok = ok and same and all(errs[q] <= TOL[q] for q in errs)
                outs[name] = (got, errs, same, fn)
            equal = all(torch.equal(u, v) for u, v in zip(
                outs["fused_grad_bsr"][0], outs["fused_grad_bsr_multi_k1"][0]))
            for name, (_, errs, same, fn) in outs.items():
                ms = time_ms(fn)
                print(json.dumps({
                    "label": args.label, "kernel": name, "storage": storage,
                    "loss": loss, "shape": [M, N, BS, ELL], "ms": ms,
                    "stream_ms": stream_ms(fn),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bound_share": max(t_bytes, t_ops) / ms,
                    "rel_err": errs, "same_bits": same,
                    "same_bits_as_multi": equal, "card": card}), flush=True)
            del outs, want
        if storage != "f32":
            del a
        torch.cuda.empty_cache()
    ok = int8_group_pass(s32, args.label, card, gen) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
