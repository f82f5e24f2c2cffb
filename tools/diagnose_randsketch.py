#!/usr/bin/env python3
"""Take the port's randsketch kernel apart on one card: where its time goes.

    PYTHONPATH=src python3 tools/diagnose_randsketch.py [--rounds 2]

Builds patched copies of ``src/repro_torch/kernels/csrc/randsketch.cu``
under ``build/diagnose/`` (nvcc, in parallel) and times each through the
wrapper at chip_smoke.py's A_w (2^18 x 16384, r = 26, from a seed), in f32
and bf16, on A_w and on its ragged view (16383 columns starting one element
into its storage), the variants in turn, ``--rounds`` times:

  kernel         the source as it is;
  copies_only    the products skipped: only A's and Q's staging runs;
  products_only  A's copies skipped: the products run on stale stages;
  bf16_mma       bf16 A on mma.sync.m16n8k16 with Q in three bf16 parts
                 (the route the kernel does not take);
  line_copies    each row's copies handed out from the 128-byte line at
                 or below its window.

The first and last two variants compute B and are held against the plain
version (normwise error, printed); the other two time parts of the kernel
and compute nothing useful.  One JSON line per variant, view, type and
round, with the card's name and power limit from nvidia-smi.  The patches
are text edits of the source: a change to the source that moves their
anchors makes this script stop with the anchor it missed.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

M, N, R = 1 << 18, 16384, 26

_BF16_HELPERS = r'''
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(unsigned short lo,
                                              unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}
__device__ __forceinline__ void split_bf16(float x, unsigned short (&p)[3]) {
  const __nv_bfloat16 b1 = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(b1);
  const __nv_bfloat16 b2 = __float2bfloat16_rn(r1);
  const __nv_bfloat16 b3 = __float2bfloat16_rn(r1 - __bfloat162float(b2));
  p[0] = __bfloat16_as_ushort(b1);
  p[1] = __bfloat16_as_ushort(b2);
  p[2] = __bfloat16_as_ushort(b3);
}

'''

# k-step j multiplies rows d + 4 t + 16 j (d = 0 .. 3 for kk = 2t, 2t + 1,
# 2t + 8, 2t + 9); Q's parts come as two pieces a lane.
_BF16_PRODUCTS = r'''
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const unsigned short* ab = reinterpret_cast<const unsigned short*>(as);
#pragma unroll
    for (int j = 0; j < kRows / 16; ++j) {
      const unsigned short* rp[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int row = d + 4 * t + 16 * j;
        const int sh = (int)(((unsigned)p + (row0 + row) * (unsigned)lda) &
                             (S::kVec - 1));
        rp[d] = ab + slot(row) * S::kStride + sh + col;
      }
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        unsigned short e[4][2];
#pragma unroll
        for (int d = 0; d < 4; ++d)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            e[d][h] = rp[d][16 * mt + 8 * h];
            if constexpr (kEdge) {
              if (!valid[mt][h]) e[d][h] = 0;
            }
          }
        af[mt][0] = pack_bf16(e[0][0], e[1][0]);
        af[mt][1] = pack_bf16(e[0][1], e[1][1]);
        af[mt][2] = pack_bf16(e[2][0], e[3][0]);
        af[mt][3] = pack_bf16(e[2][1], e[3][1]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint4* qp = qs + ((j * kTileR + 8 * nt + g) * 4 + t) * 2;
        const uint4 u = qp[0], v = qp[1];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][nt], af[mt], v.x, v.y);
          mma_bf16(acc[mt][nt], af[mt], u.z, u.w);
          mma_bf16(acc[mt][nt], af[mt], u.x, u.y);
        }
      }
    }
    return;
  }
'''

_BF16_SPLIT = r'''
__global__ void randsketch_split_q_bf16(const float* __restrict__ q,
                                        long long m, int r, int qtiles,
                                        uint4* __restrict__ qs) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long blocks = (m + kRows - 1) / kRows;
  if (e >= blocks * qtiles * (kQPieces / 2)) return;
  const int t = (int)(e & 3);
  const int c = (int)((e >> 2) % kTileR);
  const int j = (int)((e >> 2) / kTileR % (kRows / 16));
  const long long bt = e / (kQPieces / 2);
  const int col = (int)(bt % qtiles) * kTileR + c;
  unsigned short part[4][3] = {};
  for (int d = 0; d < 4; ++d) {
    const long long row = (bt / qtiles) * kRows + 16 * j + 4 * t + d;
    if (row < m && col < r) split_bf16(q[row * r + col], part[d]);
  }
  qs[2 * e] = make_uint4(pack_bf16(part[0][0], part[1][0]),
                         pack_bf16(part[2][0], part[3][0]),
                         pack_bf16(part[0][1], part[1][1]),
                         pack_bf16(part[2][1], part[3][1]));
  qs[2 * e + 1] = make_uint4(pack_bf16(part[0][2], part[1][2]),
                             pack_bf16(part[2][2], part[3][2]), 0u, 0u);
}

cudaError_t split_q_bf16(const float* q, long long m, int r, uint4* qs,
                         cudaStream_t s) {
  const int qtiles = (r + kTileR - 1) / kTileR;
  const long long total = (m + kRows - 1) / kRows * qtiles * (kQPieces / 2);
  if (total == 0) return cudaSuccess;
  randsketch_split_q_bf16<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      q, m, r, qtiles, qs);
  return cudaGetLastError();
}

'''

_PRODUCTS_CALL = ("    if (len == kTileN)\n",
                  "    else\n      stage_products<T, true, kQExact>")
_COPY_LOOP = "      for (int pc = csub; pc < pieces; pc += kRowThreads)"
_COPY_BODY = ("      for (int pc = csub; pc < pieces; pc += kRowThreads)\n"
              "        cp_async16_zfill(dst + pc * S::kVec, live ? src + pc * S::kVec : a16,\n"
              "                         live ? 16 : 0);")

PATCHES = {
    "kernel": [],
    "copies_only": [(_PRODUCTS_CALL[0], "    if (n < 0 && len == kTileN)\n"),
                    (_PRODUCTS_CALL[1],
                     "    else if (n < 0)\n"
                     "      stage_products<T, true, kQExact>")],
    "products_only": [(_COPY_LOOP, "      for (int pc = csub; n < 0 && pc < pieces;"
                                   " pc += kRowThreads)")],
    "bf16_mma": [
        ('#include "common.cuh"\n', '#include "common.cuh"\n' + _BF16_HELPERS),
        ("  using S = Staging<T>;\n  const int g = col & 7;\n",
         "  using S = Staging<T>;\n  const int g = col & 7;\n" + _BF16_PRODUCTS),
        ("// The slices' sum, in slice order", _BF16_SPLIT
         + "// The slices' sum, in slice order"),
        ("  err = split_q(static_cast<const float*>(q), m, r, qsu, s);",
         "  err = dtype == DT_BF16\n"
         "            ? split_q_bf16(static_cast<const float*>(q), m, r, qsu, s)\n"
         "            : split_q(static_cast<const float*>(q), m, r, qsu, s);")],
    "line_copies": [(_COPY_BODY,
                     "      const int lead = (int)((reinterpret_cast<uintptr_t>(src) >> 4) & 7);\n"
                     "      for (int pc = csub - lead; pc < pieces; pc += kRowThreads)\n"
                     "        if (pc >= 0)\n"
                     "          cp_async16_zfill(dst + pc * S::kVec,\n"
                     "                           live ? src + pc * S::kVec : a16, live ? 16 : 0);")],
}
COMPUTES_B = ("kernel", "bf16_mma", "line_copies")
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


def build(_build, out_dir: Path) -> dict:
    source = (_build.CSRC / "randsketch.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in PATCHES.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: anchor not in randsketch.cu: {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text + ERROR_STRING)
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
        lib.repro_randsketch.argtypes = _build._SIGNATURES["repro_randsketch"]
        lib.repro_randsketch.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("diagnose_randsketch: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import randsketch as rs

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    libs = build(_build, _build.BUILD_DIR / "diagnose")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    a32 = torch.randn(M, N, generator=gen, device=dev)
    q = torch.randn(M, R, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        a = a32 if dtype == torch.float32 else a32.to(dtype)
        if dtype != torch.float32:
            del a32
            torch.cuda.empty_cache()
        views = {"aligned": a,
                 "ragged": a.view(-1)[1:1 + M * (N - 1)].view(M, N - 1)}
        plain = {v: rs.randsketch_plain(x, q, torch.float32)
                 for v, x in views.items()}
        for rnd in range(args.rounds):
            order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            for name in order:
                if name == "bf16_mma" and dtype != torch.bfloat16:
                    continue
                _build._lib = libs[name]
                for view, x in views.items():
                    got = rs.randsketch(x, q, out_dtype=torch.float32)
                    print(json.dumps({
                        "variant": name, "round": rnd, "view": view,
                        "dtype": "bf16" if dtype == torch.bfloat16 else "f32",
                        "ms": time_ms(lambda x=x: rs.randsketch(
                            x, q, out_dtype=torch.float32)),
                        "rel_err": (rel_err(got, plain[view])
                                    if name in COMPUTES_B else None),
                        "card": card}), flush=True)
        del a, views, plain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
