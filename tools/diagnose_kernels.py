#!/usr/bin/env python3
"""Take one of the port's kernels apart on one card: where its time goes.

    PYTHONPATH=src python3 tools/diagnose_kernels.py --kernel tsgram [--rounds 2]
    PYTHONPATH=src python3 tools/diagnose_kernels.py --kernel bsr_matmul
    PYTHONPATH=src python3 tools/diagnose_kernels.py --kernel bsr_rmatmul
    PYTHONPATH=src python3 tools/diagnose_kernels.py --kernel gemm
    PYTHONPATH=src python3 tools/diagnose_kernels.py --kernel selective_scan

Builds patched copies of the kernel's source (``csrc/tsgram.cu``,
``csrc/bsr_spmm.cu``, ``csrc/bsr_rmatmul.cu``, ``csrc/gemm.cu`` or
``csrc/selective_scan.cu``) under ``build/diagnose/``
(nvcc, in parallel) and times each through the wrapper, the variants in
turn, ``--rounds`` times:

  kernel         the source as it is;
  copies_only    the products skipped: only the copies into the ring run;
  products_only  the copies skipped: the products run on stale stages;
  skeleton       bsr_rmatmul: both skipped, what is left of the kernel (its
                 index loads, barriers, partial writes and second pass);

and for tsgram also

  no_split_pass  f32: the pass that writes B's split K-major skipped (the
                 wgmmas read stale split buffers);
  two_products   f32: the a_lo * b_hi product dropped (two TF32 products a
                 pair, not three);
  no_split       f32: the operands' TF32 split skipped (the raw bits feed
                 all three products);
  sum_rows_128   the mma accumulators added to the f32 totals every 128
                 rows, not 64;

for gemm also

  tile128        8 warps: tiles of 128 rows, B's k-slice read once a
                 128-row tile (a ring of 4 stages fits);
  rows128        stages of 128 bytes of each row, not 256 (4 stages fit);

and for selective_scan

  kernel, no_ex2 (each exponential a plain copy of its argument, no MUFU
  op), no_xdt_copy (x's and dt's copies skipped: the walk reads stale
  stages), no_y_write (y's stores skipped) and lanes4 (4 states a lane:
  4 lanes a channel at N = 16, 2 at N = 8).

tsgram runs at chip_smoke.py's A (2^21 x 1024, from a seed) in f32 and
bf16, and on A's ragged f32 view (1023 columns starting one element into
its storage); bsr_matmul on chip_smoke.py's S (2^22 x 2^14, 32 x 32
blocks, 16 a block-row, Zipf(1) block columns) in f32, bf16 and int8 at
nx = 16; bsr_rmatmul on S in f32, bf16 and int8 at nx = 1 and in f32 at
nx = 16 and 512; gemm at A (2^21 x 1024 times 1024 x 16, f32 and bf16),
A_w (2^18 x 16384 times 16384 x 26, f32 and bf16) and TSQR's 2^18 x 26
times 26 x 26 (f32); selective_scan at 4 x 2048 x 8192, N = 16 and 8.
``kernel``, ``sum_rows_128``, ``tile128``, ``rows128`` and ``lanes4``
compute the same function and are held against the plain version
(normwise error, printed); the others
time parts of the kernel and compute nothing useful.  One JSON line per
variant, case and round, with the card's name and power limit from
nvidia-smi.  The patches are text edits of the source: a change to the
source that moves their anchors makes this script stop with the anchor it
missed.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

_TS_PRODUCTS_F32 = "  auto products = [&](int c) {\n"
_TS_PRODUCTS_BF16 = "    stage_products_bf16(rw.stage"
_TS_SPLIT_PASS = "    split_b(rw.stage"
_TS_COPY = "      for (int pc = csub; pc < pieces; pc += kRowThreads) {\n"
_TS_LO_HI = "      wgmma_tf32(acc, alo[j], dhi, j > 0 || c % kSumChunks != 0);\n"
_TS_SPLIT = ("  hi = __float_as_uint(x) & 0xffffe000u;\n"
             "  lo = __float_as_uint(x - __uint_as_float(hi));\n")
_MM_PRODUCTS = "    for (int c0 = 0; c0 < BS; c0 += 4) {\n"
_MM_COPY_A = "    for (int e = tid; e < br * L::kPieces; e += nthreads) {\n"
_MM_COPY_X = "    for (int p = 0; p < 4; ++p) {\n      const int j = col0 + 4 * jp;\n"
_RM_PRODUCTS = "    for (int ks = 0; ks < L::kKS; ++ks) {\n"
_RM_COPY_A = "        if (L::kPieces % kThreads == 0 || p < L::kPieces) {\n"
_RM_COPY_AL = "      for (int p = tid; p < L::kPieces; p += kThreads) {\n"
_RM_COPY_XV = "      for (int p = tid; p < (BS << per_row_log2); p += kThreads) {\n"
_RM_COPY_XS = "      for (int p = tid; p < (BS << nt_log2); p += kThreads) {\n"
_RM_NO_COPIES = [(_RM_COPY_A, "        if (nx < 0 && (L::kPieces % kThreads == 0 "
                              "|| p < L::kPieces)) {\n"),
                 (_RM_COPY_AL, "      for (int p = tid; nx < 0 && p < L::kPieces; "
                               "p += kThreads) {\n"),
                 (_RM_COPY_XV, "      for (int p = tid; nx < 0 && p < (BS << "
                               "per_row_log2); p += kThreads) {\n"),
                 (_RM_COPY_XS, "      for (int p = tid; nx < 0 && p < (BS << "
                               "nt_log2); p += kThreads) {\n")]
_GM_PRODUCTS = ("    const unsigned char* sa = smem + buf * S::kStageBytes;\n"
                "    const unsigned char* sb = sa + S::kABytes;\n")
_GM_COPY_A = "    for (int r = crow; r < kTileM; r += kCopyRows) {\n"
_SS_EX2 = '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
_SS_COPY_XDT = ("    for (int e = threadIdx.x; e < kSteps * kPieces; "
                "e += kThreads) {\n")
_RM_NO_PRODUCTS = [(_RM_PRODUCTS, "    for (int ks = 0; nx < 0 && ks < L::kKS; "
                                  "++ks) {\n")]

PATCHES = {
    "tsgram": {
        "source": "tsgram.cu",
        "entry": "repro_tsgram",
        "variants": {
            "kernel": [],
            "copies_only": [
                (_TS_PRODUCTS_F32, _TS_PRODUCTS_F32 + "    if (n >= 0) return;\n"),
                (_TS_PRODUCTS_BF16, "    if (n < 0) " + _TS_PRODUCTS_BF16[4:]),
                (_TS_SPLIT_PASS, "    if (n < 0) " + _TS_SPLIT_PASS[4:])],
            "products_only": [(_TS_COPY, "      for (int pc = csub; n < 0 && "
                                         "pc < pieces; pc += kRowThreads) {\n")],
            "no_split_pass": [(_TS_SPLIT_PASS, "    if (n < 0) " + _TS_SPLIT_PASS[4:])],
            "two_products": [(_TS_LO_HI, "")],
            "no_split": [(_TS_SPLIT, "  hi = lo = __float_as_uint(x);\n")],
            "sum_rows_128": [("constexpr int kSumRows = 64;",
                              "constexpr int kSumRows = 128;")],
        },
        "computes": ("kernel", "sum_rows_128"),
    },
    "bsr_matmul": {
        "source": "bsr_spmm.cu",
        "entry": "repro_bsr_spmm",
        "variants": {
            "kernel": [],
            "copies_only": [(_MM_PRODUCTS, "    for (int c0 = 0; nx < 0 && "
                                           "c0 < BS; c0 += 4) {\n")],
            "products_only": [
                (_MM_COPY_A, "    for (int e = tid; nx < 0 && e < br * "
                             "L::kPieces; e += nthreads) {\n"),
                (_MM_COPY_X, "    for (int p = 0; nx < 0 && p < 4; ++p) {\n"
                             "      const int j = col0 + 4 * jp;\n")],
        },
        "computes": ("kernel",),
    },
    "bsr_rmatmul": {
        "source": "bsr_rmatmul.cu",
        "entry": "repro_bsr_rmatmul",
        "variants": {
            "kernel": [],
            "copies_only": _RM_NO_PRODUCTS,
            "products_only": _RM_NO_COPIES,
            "skeleton": _RM_NO_PRODUCTS + _RM_NO_COPIES,
        },
        "computes": ("kernel",),
    },
    "gemm": {
        "source": "gemm.cu",
        "entry": "repro_gemm",
        "variants": {
            "kernel": [],
            "copies_only": [(_GM_PRODUCTS, "    if (K >= 0) return;\n"
                                           + _GM_PRODUCTS)],
            "products_only": [(_GM_COPY_A, "    for (int r = crow; K < 0 && "
                                           "r < kTileM; r += kCopyRows) {\n")],
            "tile128": [("constexpr int kWarps = 16;",
                         "constexpr int kWarps = 8;")],
            "rows128": [("constexpr int kRowBytes = 256;",
                         "constexpr int kRowBytes = 128;")],
        },
        "computes": ("kernel", "tile128", "rows128"),
    },
    "selective_scan": {
        "source": "selective_scan.cu",
        "entry": "repro_selective_scan",
        "variants": {
            "kernel": [],
            "no_ex2": [(_SS_EX2, "  y = x;\n")],
            "no_xdt_copy": [(_SS_COPY_XDT, "    for (int e = threadIdx.x; "
                                           "S < 0 && e < kSteps * kPieces; "
                                           "e += kThreads) {\n")],
            "no_y_write": [("    if (j > 0) write_y(j - 1);\n", ""),
                           ("  if (ntiles > 0) write_y(ntiles - 1);\n", "")],
            "lanes4": [("static constexpr int kStates = N < 8 ? N : 8;",
                        "static constexpr int kStates = 4;")],
        },
        "computes": ("kernel", "lanes4"),
    },
}
ERROR_STRING = ('\nextern "C" const char* repro_error_string(int err) {\n'
                '  return cudaGetErrorString(static_cast<cudaError_t>(err));\n}\n')


def time_ms(fn, reps: int = 10) -> float:
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


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-300))


def build(_build, spec: dict, out_dir: Path) -> dict:
    source = (_build.CSRC / spec["source"]).read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in spec["variants"].items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: anchor not in {spec['source']}: "
                                 f"{old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text if "repro_error_string" in text
                      else text + ERROR_STRING)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH, *_build.FLAGS, "-shared", "-I",
             str(_build.CSRC), "-o", str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        entry = getattr(lib, spec["entry"])
        entry.argtypes = _build._SIGNATURES[spec["entry"]]
        entry.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def tsgram_cases(dev):
    """(case, operand, call, plain) for tsgram."""
    from repro_torch.kernels import tsgram as ts

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(1 << 21, 1024, generator=gen, device=dev)
    m, n = a.shape
    cases = {"f32": a,
             "f32_ragged": a.view(-1)[1:1 + m * (n - 1)].view(m, n - 1),
             "bf16": a.to(torch.bfloat16)}
    return {name: (lambda x=x: ts.tsgram(x, out_dtype=torch.float32),
                   ts.tsgram_plain(x, torch.float32))
            for name, x in cases.items()}


def bsr_matmul_cases(dev):
    """(case, call, plain) for bsr_matmul on S."""
    from repro_torch.kernels import bsr

    M, N, BS, ELL = 1 << 22, 1 << 14, 32, 16
    gen = torch.Generator(device=dev).manual_seed(3)
    nbr, nbc = M // BS, N // BS
    logp = -torch.log(torch.arange(1, nbc + 1, device=dev,
                                   dtype=torch.float32))
    cols = torch.empty((nbr, ELL), dtype=torch.int32, device=dev)
    for i in range(0, nbr, 1 << 14):
        u = torch.rand(min(1 << 14, nbr - i), nbc, generator=gen, device=dev)
        keys = logp - torch.log(-torch.log(u.clamp_min(1e-30)))
        cols[i:i + (1 << 14)] = torch.sort(
            keys.topk(ELL, dim=1).indices, dim=1).values.to(torch.int32)
    s32 = bsr.BlockELL(torch.randn((nbr, ELL, BS, BS), generator=gen,
                                   device=dev), cols, (M, N))
    X = torch.randn(N, 16, generator=gen, device=dev)
    mats = {"f32": s32,
            "bf16": bsr.BlockELL(s32.data.to(torch.bfloat16), cols, s32.shape),
            "int8": s32.quantize_int8()}
    return {name: (lambda a=a: bsr.bsr_matmul(a, X),
                   bsr.bsr_matmul_plain(a, X)) for name, a in mats.items()}


def bsr_rmatmul_cases(dev):
    """(case, call, plain) for bsr_rmatmul on S."""
    from repro_torch.kernels import bsr

    from time_bsr_rmatmul import M, sparse_matrix

    s32 = sparse_matrix(bsr, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    U1 = torch.randn(M, 1, generator=gen, device=dev)
    mats = {"f32": s32,
            "bf16": bsr.BlockELL(s32.data.to(torch.bfloat16), s32.cols,
                                 s32.shape),
            "int8": s32.quantize_int8()}
    cases = {f"{name}_nx1": (lambda a=a: bsr.bsr_rmatmul(a, U1),
                             bsr.bsr_rmatmul_plain(a, U1))
             for name, a in mats.items()}
    for nx in (16, 512):
        U = torch.randn(M, nx, generator=gen, device=dev)
        cases[f"f32_nx{nx}"] = (lambda U=U: bsr.bsr_rmatmul(s32, U),
                                bsr.bsr_rmatmul_plain(s32, U))
    return cases


def gemm_cases(dev):
    """(case, call, plain) for gemm at A, A_w and TSQR's shape."""
    from repro_torch.kernels import gemm

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for name, (m, k, n) in (("A", (1 << 21, 1024, 16)),
                            ("A_w", (1 << 18, 16384, 26)),
                            ("tsqr", (1 << 18, 26, 26))):
        a = torch.randn(m, k, generator=gen, device=dev)
        b = torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
        dtypes = (torch.float32,) if name == "tsqr" else (torch.float32,
                                                          torch.bfloat16)
        for dt in dtypes:
            ad = a.to(dt)
            cases[f"{name}_{'f32' if dt == torch.float32 else 'bf16'}"] = (
                lambda ad=ad, b=b: gemm.gemm(ad, b, out_dtype=torch.float32),
                gemm.gemm_plain(ad, b, torch.float32))
        del a
    return cases


def selective_scan_cases(dev):
    """(case, call, plain) for selective_scan at the falcon prefill's
    shape, N = 16 and 8 (y; the card tests hold the final state)."""
    from repro_torch.kernels import selective_scan as ss

    gen = torch.Generator(device=dev).manual_seed(0)
    bt, s, d = 4, 2048, 8192
    cases = {}
    for n in (16, 8):
        args = (torch.randn(bt, s, d, generator=gen, device=dev),
                torch.rand(bt, s, d, generator=gen, device=dev) * 0.1,
                -torch.rand(d, n, generator=gen, device=dev) - 0.1,
                torch.randn(bt, s, n, generator=gen, device=dev),
                torch.randn(bt, s, n, generator=gen, device=dev),
                torch.randn(d, generator=gen, device=dev))
        cases[f"N{n}"] = (lambda args=args: ss.selective_scan(*args)[0],
                          ss.selective_scan_plain(*args)[0])
    return cases


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(PATCHES), required=True)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("diagnose_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    spec = PATCHES[args.kernel]
    libs = build(_build, spec, _build.BUILD_DIR / "diagnose" / args.kernel)
    dev = torch.device("cuda", 0)
    cases = {"tsgram": tsgram_cases, "bsr_matmul": bsr_matmul_cases,
             "bsr_rmatmul": bsr_rmatmul_cases, "gemm": gemm_cases,
             "selective_scan": selective_scan_cases}[args.kernel](dev)
    for rnd in range(args.rounds):
        order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
        for name in order:
            _build._lib = libs[name]
            for case, (call, plain) in cases.items():
                if name in ("two_products", "no_split", "no_split_pass") \
                        and "bf16" in case:
                    continue
                got = call()
                print(json.dumps({
                    "kernel": args.kernel, "variant": name, "round": rnd,
                    "case": case, "ms": time_ms(call),
                    "rel_err": (rel_err(got, plain)
                                if name in spec["computes"] else None),
                    "card": card}), flush=True)
                del got
    return 0


if __name__ == "__main__":
    sys.exit(main())
