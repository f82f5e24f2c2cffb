// Y = A X for a block-ELL A (nbr block-rows of `ell` stored bs x bs blocks,
// block-column ids in cols[nbr][ell]) and a dense row-major f32 X: the
// U = A (V S^-1) product of the sparse SVD, and the int8 group pass at
// nx = k slots (kernels/ops.py).
//
// Replaces the TPU kernel src/repro/kernels/bsr.py:bsr_matmul (_bsr_kernel).
// Bound by bytes on the H100 at the path's nx = 16: every stored block is
// read once (nbr*ell*bs*bs*sizeof(storage)) for 2*nx flops an element,
// plus X's gathered rows (from L2) and Y.  Storage is f32, bf16 or int8
// with a per-block f32 scale, upcast in registers; sums in f32 FMA on the
// CUDA cores, which at nx = 16 need about 0.4 of the time the bytes take.
//
// Design.  The TPU kernel walks (block-row, slot) on a sequential grid into
// a (bs x nx) VMEM accumulator.  Here a persistent grid of blocks walks
// units of `br` consecutive block-rows by one tile of nt <= 32 output
// columns (nt the power of two >= nx, at least 4; nx <= 32 is one tile,
// so the stored blocks leave HBM once).  A block streams its units' slots
// through a ring of `stages` shared-memory stages, one slot of the unit's
// br block-rows a stage, filled by every thread with 16-byte cp.async
// pieces: the br stored blocks (rows padded by 16 bytes, so the 8 rows a
// quarter-warp reads fall on distinct banks) and the X rows each block
// gathers (bs rows of the tile's nt columns; X, in L2, is never read in
// the loop), so the next slots land while this one is multiplied.
// Thread (b, cg, rg) owns the 4 x 4 outputs of block-row b, rows
// rg + (bs/4) q and columns 4 cg .. 4 cg + 3, in registers: per 4 in-block
// indices it reads 4 A values of each of its rows and one float4 of X for
// each index, so every shared value feeds 4 FMAs.
//
// Sums.  Every output is one thread's chain of FMAs over the slots in
// order, and within a slot over the in-block index c in order; int8 sums a
// slot's chain from zero and adds it times the block's scale.  No output
// is split across threads, so its order follows from A's shape alone,
// never from nx or the tile: Y[:, j] has the same bits at any nx and
// whatever X's other columns hold (the slot-independence rule of the
// multi-slot kernels, which the int8 group pass relies on).  Each block
// writes only its own rows, so runs repeat bit for bit.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxTile = 32;      // output columns a tile
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;  // shared memory a block may use

// A stage: br stored blocks, then X's gathered rows [br][bs][nt] (f32),
// then br scales (f32, int8 storage only read), each part a whole number
// of 16-byte pieces.  A block's rows are staged in chunks of one row (two
// for int8 at bs = 8, whose rows are 8 bytes), each chunk followed by 16
// bytes, and each block by 16 more.  bsr.py:_matmul_stage_bytes mirrors
// this.
template <typename T, int BS>
struct Layout {
  static constexpr int kRowBytes = BS * (int)sizeof(T);
  static constexpr int kChunk = kRowBytes > 16 ? kRowBytes : 16;
  static constexpr int kRowsPerChunk = kChunk / kRowBytes;
  static constexpr int kChunkStride = kChunk + 16;
  static constexpr int kBlockStride =
      (BS / kRowsPerChunk) * kChunkStride + 16;
  static constexpr int kPieces = BS * kRowBytes / 16;   // a block's pieces
  static constexpr int kChunkPieces = kChunk / 16;
  static constexpr int kRG = BS / 4;                    // row groups
};

__host__ __device__ inline int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

template <typename T, int BS>
__host__ __device__ inline int stage_bytes(int br, int nt) {
  using L = Layout<T, BS>;
  return br * L::kBlockStride + br * BS * nt * 4 + round16(4 * br);
}

// Elements c0 .. c0 + 3 of staged row r of a block, as f32.
template <typename T, int BS>
__device__ __forceinline__ void load_a(const unsigned char* blk, int r, int c0,
                                       float (&v)[4]) {
  using L = Layout<T, BS>;
  const unsigned char* p = blk + (r / L::kRowsPerChunk) * L::kChunkStride +
                           (r % L::kRowsPerChunk) * L::kRowBytes +
                           c0 * (int)sizeof(T);
  if constexpr (std::is_same<T, float>::value) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // bf16 is the top half of an f32.
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(w.x << 16);
    v[1] = __uint_as_float(w.x & 0xffff0000u);
    v[2] = __uint_as_float(w.y << 16);
    v[3] = __uint_as_float(w.y & 0xffff0000u);
  } else {
    // int8: byte k + 128 placed in the low mantissa bits of 2^23 gives
    // 2^23 + 128 + x exactly.
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540 + k)) -
             8388736.f;
  }
}

template <typename T, int BS>
__global__ void __launch_bounds__(kMaxThreads)
bsr_spmm_kernel(const T* __restrict__ data, const float* __restrict__ scales,
                const int* __restrict__ cols, const float* __restrict__ x,
                long long nbr, int ell, int nx, int ldx, int ncg_log2, int br,
                int stages, int ntiles, float* __restrict__ y) {
  using L = Layout<T, BS>;
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ncg = 1 << ncg_log2, nt = 4 * ncg;
  const int sbytes = stage_bytes<T, BS>(br, nt);
  const int x_off = br * L::kBlockStride;
  const int sc_off = x_off + br * BS * nt * 4;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  // This thread's outputs: block-row b of the unit, rows rg + kRG q,
  // columns 4 cg .. 4 cg + 3 of the tile.
  const int rg = tid % L::kRG;
  const int cg = (tid / L::kRG) & (ncg - 1);
  const int b = tid / (L::kRG * ncg);

  const long long groups = (nbr + br - 1) / br;
  const long long units = groups * ntiles;
  const long long mine =
      blockIdx.x < units ? (units - blockIdx.x + gridDim.x - 1) / gridDim.x
                         : 0;
  const long long nq = mine * ell;   // stages this block multiplies

  // A unit's first block-row and first column: unit number k of this
  // block is u = blockIdx.x + k gridDim.x, tiles fastest.
  auto unit_rows = [&](long long k) {
    return ((blockIdx.x + k * gridDim.x) / ntiles) * br;
  };
  auto unit_col = [&](long long k) {
    return (int)((blockIdx.x + k * gridDim.x) % ntiles) * nt;
  };
  // The X pieces this thread copies, the same in every stage: exactly
  // four (br * BS * ncg pieces over br * (BS / 4) * ncg threads), piece p
  // being row xc[p] of block-row xb[p], columns 4 jp .. 4 jp + 3.
  const int jp = tid & (ncg - 1);
  int xb[4], xc[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int rest = (tid >> ncg_log2) + p * (nthreads >> ncg_log2);
    xc[p] = rest % BS;
    xb[p] = rest / BS;
  }
  // Their block columns at slot s of the unit starting at block-row i0
  // (-1 past the last block-row), loaded one issue ahead so that the copies
  // never wait on them.
  auto load_cols = [&](long long i0, int s, int (&col)[4]) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const long long i = i0 + xb[p];
      col[p] = i < nbr ? __ldg(cols + i * ell + s) : -1;
    }
  };

  // Copy slot s of the unit starting at block-row i0 and column col0 into
  // stage `buf`; col holds the X pieces' block columns.
  auto issue = [&](long long i0, int col0, int s, const int (&col)[4],
                   int buf) {
    unsigned char* st = smem + (size_t)buf * sbytes;
    for (int e = tid; e < br * L::kPieces; e += nthreads) {
      const int bb = e / L::kPieces, pc = e % L::kPieces;
      const long long i = i0 + bb;
      const bool live = i < nbr;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(data) +
          ((size_t)(live ? i : 0) * ell + s) * (BS * L::kRowBytes) + pc * 16;
      cp_async16_zfill(st + bb * L::kBlockStride +
                           (pc / L::kChunkPieces) * L::kChunkStride +
                           (pc % L::kChunkPieces) * 16,
                       src, live ? 16 : 0);
    }
    float* xs = reinterpret_cast<float*>(st + x_off);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int j = col0 + 4 * jp;
      const bool live = col[p] >= 0 && j < ldx;
      const float* src =
          live ? x + ((size_t)col[p] * BS + xc[p]) * ldx + j : x;
      cp_async16_zfill(xs + (xb[p] * BS + xc[p]) * nt + 4 * jp, src,
                       live ? 16 : 0);
    }
    if constexpr (kScaled) {
      float* ss = reinterpret_cast<float*>(st + sc_off);
      for (int bb = tid; bb < br; bb += nthreads) {
        const bool live = i0 + bb < nbr;
        cp_async4_zfill(ss + bb, live ? scales + (i0 + bb) * ell + s : scales,
                        live ? 4 : 0);
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[q][v] = 0.f;

  // The issue pointer runs stages - 1 slots ahead: slot is of the unit
  // starting at block-row ii0 and column icol0 (unit number ik), its
  // block columns in icols, into stage ibuf.
  long long ik = 0, ii0 = unit_rows(0);
  int is = 0, icol0 = unit_col(0), ibuf = 0;
  int icols[4];
  auto advance = [&]() {
    if (++is == ell) {
      is = 0;
      ++ik;
      ii0 = unit_rows(ik);
      icol0 = unit_col(ik);
    }
    if (++ibuf == stages) ibuf = 0;
  };
  long long issued = 0;
  for (int st = 0; st < stages - 1; ++st) {
    if (issued < nq) {
      load_cols(ii0, is, icols);
      issue(ii0, icol0, is, icols, ibuf);
      advance();
      ++issued;
    }
    cp_async_commit();
  }
  if (issued < nq) load_cols(ii0, is, icols);
  long long k = 0;
  int s = 0, buf = 0;
  for (long long q = 0; q < nq; ++q) {
    cp_async_wait_n<kMaxStages - 2>(stages - 2);
    __syncthreads();   // slot q landed; every thread is done with q - 1
    if (issued < nq) {
      issue(ii0, icol0, is, icols, ibuf);
      advance();
      if (++issued < nq) load_cols(ii0, is, icols);
    }
    cp_async_commit();

    const unsigned char* st = smem + (size_t)buf * sbytes;
    const unsigned char* blk = st + b * L::kBlockStride;
    const float* xs =
        reinterpret_cast<const float*>(st + x_off) + b * BS * nt + 4 * cg;
    float part[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int v = 0; v < 4; ++v) part[r][v] = kScaled ? 0.f : acc[r][v];
#pragma unroll
    for (int c0 = 0; c0 < BS; c0 += 4) {
      float av[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) load_a<T, BS>(blk, rg + L::kRG * r, c0, av[r]);
      float4 xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        xv[u] = *reinterpret_cast<const float4*>(xs + (c0 + u) * nt);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          part[r][0] = fmaf(av[r][u], xv[u].x, part[r][0]);
          part[r][1] = fmaf(av[r][u], xv[u].y, part[r][1]);
          part[r][2] = fmaf(av[r][u], xv[u].z, part[r][2]);
          part[r][3] = fmaf(av[r][u], xv[u].w, part[r][3]);
        }
    }
    if constexpr (kScaled) {
      const float sc = reinterpret_cast<const float*>(st + sc_off)[b];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[r][v] = fmaf(sc, part[r][v], acc[r][v]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[r][v] = part[r][v];
    }

    if (++buf == stages) buf = 0;
    if (s == ell - 1) {   // the unit's last slot: write its outputs
      const long long i = unit_rows(k) + b;
      const int j0 = unit_col(k) + 4 * cg;
      if (i < nbr) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (j0 + v < nx)
              y[((size_t)i * BS + rg + L::kRG * r) * nx + j0 + v] = acc[r][v];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[r][v] = 0.f;
      s = 0;
      ++k;
    } else {
      ++s;
    }
  }
}

template <typename T, int BS>
cudaError_t launch(const void* data, const void* scales, const void* cols,
                   const void* x, long long nbr, int ell, int nx, int ldx,
                   int nt, int br, int stages, int smem, int grid, void* y,
                   cudaStream_t s) {
  using L = Layout<T, BS>;
  int ncg_log2 = 0;
  while ((4 << ncg_log2) < nt) ++ncg_log2;
  const int threads = br * L::kRG * (nt / 4);
  if ((4 << ncg_log2) != nt || nt > kMaxTile || br < 1 ||
      threads > kMaxThreads || stages < 2 || stages > kMaxStages ||
      smem != stages * stage_bytes<T, BS>(br, nt) || smem > kSmemMax ||
      grid < 1 || ldx % 4 || ldx < nx)
    return cudaErrorInvalidValue;
  const void* fn = (const void*)&bsr_spmm_kernel<T, BS>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (nx + nt - 1) / nt;
  bsr_spmm_kernel<T, BS><<<grid, threads, smem, s>>>(
      static_cast<const T*>(data), static_cast<const float*>(scales),
      static_cast<const int*>(cols), static_cast<const float*>(x), nbr, ell,
      nx, ldx, ncg_log2, br, stages, ntiles, static_cast<float*>(y));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bs(int bs, const void* data, const void* scales,
                      const void* cols, const void* x, long long nbr, int ell,
                      int nx, int ldx, int nt, int br, int stages, int smem,
                      int grid, void* y, cudaStream_t s) {
#define REPRO_SPMM_CASE(B)                                                   \
  case B:                                                                    \
    return launch<T, B>(data, scales, cols, x, nbr, ell, nx, ldx, nt, br,    \
                        stages, smem, grid, y, s);
  switch (bs) {
    REPRO_SPMM_CASE(8)
    REPRO_SPMM_CASE(16)
    REPRO_SPMM_CASE(32)
    REPRO_SPMM_CASE(64)
    REPRO_SPMM_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_SPMM_CASE
}

}  // namespace

// data (nbr, ell, bs, bs) in `dtype`, on a 16-byte boundary; scales
// (nbr, ell) f32 for int8 data (else null); cols (nbr, ell) int32; x
// (ncols, ldx) f32 row-major on a 16-byte boundary, ldx a multiple of 4 and
// >= nx (columns past nx are read, never written); y (nbr * bs, nx) f32.
// The launch plan (tile width nt, block-rows a unit br, stages, shared
// memory bytes, grid) is bsr.py:matmul_plan's.
extern "C" int repro_bsr_spmm(int device, const void* data, int dtype,
                              const void* scales, const void* cols,
                              long long nbr, int ell, int bs, const void* x,
                              int nx, int ldx, int nt, int br, int stages,
                              int smem, int grid, void* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbr < 1 || ell < 1 || nx < 1 || nbr > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(data) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  if ((dtype == DT_I8) != (scales != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch_bs<float>(bs, data, scales, cols, x, nbr, ell, nx, ldx,
                              nt, br, stages, smem, grid, y, s);
    case DT_BF16:
      return launch_bs<__nv_bfloat16>(bs, data, scales, cols, x, nbr, ell,
                                      nx, ldx, nt, br, stages, smem, grid, y,
                                      s);
    case DT_I8:
      return launch_bs<int8_t>(bs, data, scales, cols, x, nbr, ell, nx, ldx,
                               nt, br, stages, smem, grid, y, s);
    default:
      return cudaErrorInvalidValue;
  }
}
