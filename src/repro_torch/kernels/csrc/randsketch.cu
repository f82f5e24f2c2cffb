// Streaming cross-Gram B = A^T Q for a tall A (m x n) and a thin Q (m x r),
// both row-major: the randomized SVD's projection.
//
// Replaces the TPU kernel src/repro/kernels/randsketch.py:randsketch
// (_randsketch_kernel).  On the H100 it is bound by the bytes of A at the
// main path's r = k + p <= 32: 2mnr flops against one read of A.  In f32
// FMA on the CUDA cores the products alone, padded to 32 columns of Q, take
// 80% of the bytes bound (2^18 x 16384 at r = 26: 4.1 ms against 5.1), so
// a CUDA-core kernel cannot hide them behind the loads.  Here they run on
// the tensor cores.
//
// Products: 3xTF32 with mma.sync.m16n8k8 (f32 += tf32 x tf32).  Each f32
// operand x splits into hi, x with its low 13 bits cleared (a TF32 value),
// and lo = x - hi (exact in f32; the mma reads its top 19 bits); a*q is
// a_lo*q_hi + a_hi*q_lo + a_hi*q_hi, which drops a_lo*q_lo (2^-20 of the
// product) and lo's cut bits (2^-20 of x), and keeps nearly f32's
// precision.  bf16 A is exact in TF32, so a*q = a*q_lo + a*q_hi, and so
// is fp8 A (e4m3 or e5m2: each byte converted to f16 and then f32 as its
// fragment loads, common.cuh: to_f32), which takes bf16's two products.
// A Q that the caller stored in bf16 or fp8 (kQExact: the chunked Gram's
// Q is a column segment of A) has q_lo = 0, so its a*q_lo product, which
// adds exact zeros, is skipped: one product for bf16 or fp8 A, two for
// f32 A, the same bits.  (bf16 A
// on mma.sync.m16n8k16 with Q in three bf16 parts was slower:
// tools/diagnose_randsketch.py, PERF.md, PR 22.)  Why mma.sync and not wgmma: wgmma takes .tf32 operands K-major
// only, and here both operands are MN-major (the sum runs down the rows of
// A and Q); wgmma also reads a shared-memory operand through one
// descriptor layout for the whole tile, which the per-row shift below
// rules out.  mma.sync fragments are loaded element by element from shared
// memory, so the shift costs nothing.
//
// Tiles.  A block computes a 512 x 32 tile of B (512 columns of A by 32 of
// Q; r <= 32 is one Q tile, so A is read once) over one slice of at most
// SLICE_ROWS rows (randsketch.py:slicing), one block an SM.  Sixteen warps
// each own 32 x 32 outputs: two m16 by four n8 mma tiles.  A's rows stream
// through a ring of stages of 32 rows in shared memory (3 in f32, 4 in
// bf16 and fp8), filled by every thread with 16-byte cp.async copies, so
// the next
// stages land while this one is multiplied.  A first pass splits Q once
// into its TF32 high and low parts (randsketch_split_q), in the order a
// stage holds them: a lane's four B-fragment words in one 16-byte piece.
// Every warp reads the whole Q tile, and splitting it there would repeat
// the work 16 times.  The products are bound by instruction issue, not by
// the tensor cores, so the loop spends few instructions a product: one
// load for Q's fragments, a mask and a subtract for A's split, and the
// column selects only in the tile that holds A's last column.  With that,
// f32 at A_w runs at the speed of its copies and bf16 at the speed of its
// products (tools/diagnose_randsketch.py times them apart; PERF.md,
// PR 22).  8 warps and 256-column tiles, 16-row stages, and Q split inside
// each warp were each slower in development.
//
// Any width, any start, any row stride.  Row k's segment of the tile starts
// at element p + k*lda + j0 counted from the 16-byte boundary at or below
// A's start (p is A's start in elements past that boundary, lda >= n the
// elements from one row's start to the next's: n for a contiguous A, the
// parent's width for a column segment A[:, s0:s1], which the chunked
// fused gradient passes as it is, never copied; j0 the tile's first
// column).
// The stage copies the 16-byte pieces from that element rounded down to a
// piece up to the segment's end rounded up -- at most one piece more than
// an aligned segment needs -- and keeps the row's shift
// s_k = (p + k*lda + j0) mod (16 / sizeof(T)), computed where it is needed,
// never stored.  A fragment reads element (k, j) at smem[slot(k)][s_k + j]
// (slot() keeps a fragment's loads off shared banks).  An aligned A (every
// s_k = 0) takes the same code.  Why reading the rounded-out bytes is safe:
// each piece copied holds at least one byte of the view,
// and a 16-byte-aligned piece that holds one byte of an allocation lies
// inside it, because device allocations (and the caching allocator's
// blocks) start on 256-byte boundaries and are whole multiples of 16 bytes
// (512 for the caching allocator).  Those extra bytes may belong to
// another tensor and hold anything, a NaN included, so columns past the
// tile's last are *selected* to 0 in the fragment, never multiplied by 0.
// Rows past the slice's end arrive as zeros (cp.async with src-size 0).
//
// Sums.  Each stage's products start from zero in the mma accumulators and
// are then added to a running total on the CUDA cores: Hopper's tensor
// cores lose accuracy on long f32 accumulation chains.  Each slice writes
// its own f32 partial tile; a last pass sums the slices in slice order
// and casts to the output type (the same bits on every run, no float
// atomics).  The products and the order of every sum follow from (m, n, r)
// and the card alone, so an offset or strided view gives the same bits as
// its contiguous copy.
#include "common.cuh"

namespace {

constexpr int kTileR = 32;    // columns of Q per block
constexpr int kWarps = 16;    // each 32 columns of A by the 32 of Q
constexpr int kThreads = 32 * kWarps;
constexpr int kTileN = 32 * kWarps;   // columns of A per block
constexpr int kRows = 32;     // rows of A and Q a stage
constexpr int kRowThreads = kThreads / kRows;   // threads copying a row
// A stage of Q's tile: for each k-step, column and lane row t, the four
// words a lane's B fragments take, in one 16-byte piece.
constexpr int kQPieces = (kRows / 8) * kTileR * 4;
constexpr int kSmemMax = 232448;   // shared memory a block may use
static_assert(kRows == 32, "slot(), the k-steps' rows and Q's split are "
                           "written for stages of 32 rows");

// Staging by storage type: kVec elements of A a 16-byte piece; a staged
// row of A holds kStride elements (the widest window, kTileN + kVec, and
// 16 bytes more: slots 1 apart fall 8 banks apart); as many stages as fit,
// up to 4.
template <typename T>
struct Staging {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kStride = kTileN + 32 / (int)sizeof(T);
  static constexpr int kStageBytes =
      kRows * kStride * (int)sizeof(T) + kQPieces * 16;
  static constexpr int kStages =
      kSmemMax / kStageBytes < 4 ? kSmemMax / kStageBytes : 4;
  static constexpr int kSmem = kStages * kStageBytes;
};

// Stage row k sits in slot (k % 4) (kRows / 4) + k / 4, so the 8 rows one
// k-step multiplies, 4 apart, sit in adjacent slots: rows 4 apart have the
// same shift in f32, so a fragment's loads never share a bank, whatever
// the shifts.
__device__ __forceinline__ int slot(int k) {
  return (k & 3) * (kRows / 4) + (k >> 2);
}

// One stage's products into acc (zeroed by the caller): rows row0 ..
// row0 + kRows - 1 of A's tile (staged in `as`, row k in slot slot(k),
// shifted by its s_k) against the same rows of Q's tile (`qs`, split), for
// the 32 x 32 outputs of a warp whose lane reads columns col + 16 mt + 8 h
// (`valid` where they lie inside the tile; read only where kEdge, the
// tile that holds A's last column).  k-step j multiplies rows
// j + 4 kk, kk = 0 .. 7, which sit in 8 adjacent slots; a lane reads
// kk = t and t + 4.  kQExact skips the products with Q's low parts (all
// zero).
template <typename T, bool kEdge, bool kQExact>
__device__ __forceinline__ void stage_products(
    const T* as, const uint4* qs, unsigned row0, int p, int lda, int col,
    int t, const bool (&valid)[2][2], float (&acc)[2][4][4]) {
  using S = Staging<T>;
  const int g = col & 7;
#pragma unroll
  for (int k8 = 0; k8 < kRows / 8; ++k8) {
    // The lane's rows (kk = t and t + 4) and their slots, and the rows'
    // shifts (mod 2^32 keeps the residue: kVec divides 2^32, and j0 is a
    // multiple of kVec).
    const int rowa_k = k8 + 4 * t, rowb_k = rowa_k + 16;
    const int sa = (int)(((unsigned)p + (row0 + rowa_k) * (unsigned)lda) &
                         (S::kVec - 1));
    const int sb = (int)(((unsigned)p + (row0 + rowb_k) * (unsigned)lda) &
                         (S::kVec - 1));
    const T* rowa = as + slot(rowa_k) * S::kStride + sa + col;
    const T* rowb = as + slot(rowb_k) * S::kStride + sb + col;
    // A fragment (m16 x k8, i = column of A, kk = row): a0 (g, t),
    // a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float v[4] = {to_f32(rowa[16 * mt]), to_f32(rowa[16 * mt + 8]),
                    to_f32(rowb[16 * mt]), to_f32(rowb[16 * mt + 8])};
      if constexpr (kEdge) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!valid[mt][i & 1]) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (std::is_same<T, float>::value) {
          split_tf32(v[i], ahi[mt][i], alo[mt][i]);
        } else {
          ahi[mt][i] = __float_as_uint(v[i]);   // bf16, fp8: exact in TF32
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      // B fragments (k8 x n8): b0 (row t, column g), b1 (row t + 4), high
      // and low parts, in one piece.
      const uint4 b = qs[(k8 * kTileR + 8 * nt + g) * 4 + t];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if constexpr (std::is_same<T, float>::value)
          mma_tf32(acc[mt][nt], alo[mt], b.x, b.y);
        if constexpr (!kQExact) mma_tf32(acc[mt][nt], ahi[mt], b.z, b.w);
        mma_tf32(acc[mt][nt], ahi[mt], b.x, b.y);
      }
    }
  }
}

template <typename T, bool kQExact>
__global__ void __launch_bounds__(kThreads, 1)
randsketch_tc(const T* __restrict__ a, const uint4* __restrict__ q,
              long long m, int n, int lda, int r, long long rows_per_slice,
              float* __restrict__ part) {
  using S = Staging<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int j0 = blockIdx.x * kTileN, c0 = blockIdx.y * kTileR;
  const int len = min(kTileN, n - j0);
  const long long r_begin = (long long)blockIdx.z * rows_per_slice;
  const long long r_end = min(m, r_begin + rows_per_slice);
  const int nchunks =
      r_end > r_begin ? (int)((r_end - r_begin + kRows - 1) / kRows) : 0;
  // A's start in elements past the 16-byte boundary at or below it, and
  // that boundary: element (row, j) lies at a16 + (p + row * lda + j).
  const int p = (int)((reinterpret_cast<uintptr_t>(a) & 15) / sizeof(T));
  const T* a16 = a - p;

  auto stage_a = [&](int buf) {
    return reinterpret_cast<T*>(smem + buf * S::kStageBytes);
  };
  auto stage_q = [&](int buf) {
    return reinterpret_cast<uint4*>(smem + buf * S::kStageBytes +
                                    kRows * S::kStride * sizeof(T));
  };
  // Copy chunk `chunk`'s rows of A[:, j0 : j0 + len] (each row's window,
  // by the kRowThreads threads of its group) and of Q[:, c0 : c0 + 32]
  // into stage `buf`.
  const int crow = threadIdx.x / kRowThreads;
  const int csub = threadIdx.x % kRowThreads;
  auto issue = [&](int chunk, int buf) {
    const long long row0 = r_begin + (long long)chunk * kRows;
    {
      const long long row = row0 + crow;
      const long long first = p + row * lda + j0;
      const int shift = (int)(first & (S::kVec - 1));
      const int pieces = (shift + len + S::kVec - 1) / S::kVec;
      const bool live = row < r_end;
      const T* src = a16 + (first - shift);
      T* dst = stage_a(buf) + slot(crow) * S::kStride;
      for (int pc = csub; pc < pieces; pc += kRowThreads)
        cp_async16_zfill(dst + pc * S::kVec, live ? src + pc * S::kVec : a16,
                         live ? 16 : 0);
    }
    // Q's split for these rows and this Q tile: one block of kQPieces
    // pieces (zero past m; slices start on whole stages).
    const uint4* qsrc = q + ((row0 / kRows) * gridDim.y + blockIdx.y) *
                                (long long)kQPieces;
    for (int e = threadIdx.x; e < kQPieces; e += kThreads)
      cp_async16_zfill(stage_q(buf) + e, qsrc + e, 16);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int jw = warp * 32;   // the warp's first column in the tile
  // Columns this thread reads: jw + 16 mt + g + 8 h; past len they are 0.
  bool valid[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) valid[mt][h] = jw + 16 * mt + g + 8 * h < len;

  float total[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) total[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < nchunks) issue(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<S::kStages - 2>();
    __syncthreads();   // chunk c landed; every warp is done with c - 1
    if (c + S::kStages - 1 < nchunks)
      issue(c + S::kStages - 1, (c + S::kStages - 1) % S::kStages);
    cp_async_commit();

    const T* as = stage_a(c % S::kStages);
    const uint4* qs = stage_q(c % S::kStages);
    const unsigned row0 = (unsigned)(r_begin + (long long)c * kRows);
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    if (len == kTileN)
      stage_products<T, false, kQExact>(as, qs, row0, p, lda, jw + g, t,
                                        valid, acc);
    else
      stage_products<T, true, kQExact>(as, qs, row0, p, lda, jw + g, t,
                                       valid, acc);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) total[mt][nt][i] += acc[mt][nt][i];
  }

  // Accumulator (m16 x n8): c0, c1 at (g, 2t + {0, 1}), c2, c3 at g + 8.
  float* out = part + (size_t)blockIdx.z * n * r;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jl = jw + 16 * mt + g + 8 * (i >> 1);
        const int cc = c0 + 8 * nt + 2 * t + (i & 1);
        if (jl < len && cc < r) out[(size_t)(j0 + jl) * r + cc] =
            total[mt][nt][i];
      }
}

// Q's TF32 split, once a launch, in the order the product kernel stages
// it: for each block of kRows rows b, Q tile ct, k-step j, column c and
// lane row t, the piece {hi(Q[ra][col]), hi(Q[rb][col]), lo(Q[ra][col]),
// lo(Q[rb][col])} with ra = kRows b + j + 4 t, rb = ra + 16 and
// col = 32 ct + c (stage_products' rows for R = 32), zero past m and r.
__global__ void randsketch_split_q(const float* __restrict__ q, long long m,
                                   int r, int qtiles,
                                   uint4* __restrict__ qs) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long blocks = (m + kRows - 1) / kRows;
  if (e >= blocks * qtiles * kQPieces) return;
  const int t = (int)(e & 3);
  const int c = (int)((e >> 2) % kTileR);
  const int j = (int)((e >> 2) / kTileR % (kRows / 8));
  const long long bt = e / kQPieces;   // b * qtiles + ct
  const long long ra = (bt / qtiles) * kRows + j + 4 * t, rb = ra + 16;
  const int col = (int)(bt % qtiles) * kTileR + c;
  uint32_t hi[2] = {0, 0}, lo[2] = {0, 0};
  if (col < r) {
    if (ra < m) split_tf32(q[ra * r + col], hi[0], lo[0]);
    if (rb < m) split_tf32(q[rb * r + col], hi[1], lo[1]);
  }
  qs[e] = make_uint4(hi[0], hi[1], lo[0], lo[1]);
}

// Second pass: B[j, c] = sum over slices of part[slice, j, c], in order.
template <typename TO>
__global__ void randsketch_reduce(const float* __restrict__ part, int slices,
                                  long long nr, TO* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nr) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += part[(size_t)k * nr + e];
  store_f32(out + e, s);
}

cudaError_t split_q(const float* q, long long m, int r, uint4* qs,
                    cudaStream_t s) {
  constexpr int kThreads = 256;
  const int qtiles = (r + kTileR - 1) / kTileR;
  const long long total = (m + kRows - 1) / kRows * qtiles * kQPieces;
  if (total == 0) return cudaSuccess;
  randsketch_split_q<<<(unsigned)((total + kThreads - 1) / kThreads),
                       kThreads, 0, s>>>(q, m, r, qtiles, qs);
  return cudaGetLastError();
}

template <typename T, bool kQExact>
cudaError_t launch_q(const void* a, const uint4* qs, long long m, int n,
                     int lda, int r, int slices, long long rows_per_slice,
                     float* part, cudaStream_t s) {
  constexpr int smem = Staging<T>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      randsketch_tc<T, kQExact>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTileN - 1) / kTileN, (r + kTileR - 1) / kTileR,
                  slices);
  randsketch_tc<T, kQExact><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(a), qs, m, n, lda, r, rows_per_slice, part);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* a, const uint4* qs, long long m, int n,
                   int lda, int r, int q_exact, int slices,
                   long long rows_per_slice, float* part, cudaStream_t s) {
  return q_exact ? launch_q<T, true>(a, qs, m, n, lda, r, slices,
                                     rows_per_slice, part, s)
                 : launch_q<T, false>(a, qs, m, n, lda, r, slices,
                                      rows_per_slice, part, s);
}

// The slices' sum, in slice order, cast to out_dtype.
cudaError_t reduce(const float* part, int slices, long long nr, void* out,
                   int out_dtype, cudaStream_t s) {
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((nr + kThreads - 1) / kThreads);
  if (out_dtype == DT_BF16)
    randsketch_reduce<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        part, slices, nr, static_cast<__nv_bfloat16*>(out));
  else
    randsketch_reduce<float><<<blocks, kThreads, 0, s>>>(
        part, slices, nr, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// a (m, n) f32, bf16, e4m3 or e5m2, any start, rows lda >= n elements
// apart (unit column stride); q (m, r) f32, contiguous, whose values are
// exact in TF32 where q_exact (the caller stored them in bf16 or fp8); qs
// scratch for Q's split (ceil(m / 32) ceil(r / 32) kQPieces 16-byte
// pieces, on a 16-byte boundary); part (slices, n, r) f32 scratch, slices
// of whole stages; out (n, r) in out_dtype (f32 or bf16: an fp8 B is cast
// by the wrapper, randsketch.py).
extern "C" int repro_randsketch(int device, const void* a, int dtype,
                                int lda, const void* q, int q_exact,
                                long long m, int n, int r, void* qs,
                                int slices, long long rows_per_slice,
                                void* part, void* out, int out_dtype,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows_per_slice % kRows || reinterpret_cast<uintptr_t>(qs) % 16 ||
      lda < n || (out_dtype != DT_F32 && out_dtype != DT_BF16) ||
      (dtype != DT_F32 && dtype != DT_BF16 && dtype != DT_F8 &&
       dtype != DT_F8E5))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* qsu = static_cast<uint4*>(qs);
  float* pf = static_cast<float*>(part);
  err = split_q(static_cast<const float*>(q), m, r, qsu, s);
  if (err != cudaSuccess) return err;
  switch (dtype) {
    case DT_BF16:
      err = launch<__nv_bfloat16>(a, qsu, m, n, lda, r, q_exact, slices,
                                  rows_per_slice, pf, s);
      break;
    case DT_F8:
      err = launch<fp8>(a, qsu, m, n, lda, r, q_exact, slices,
                        rows_per_slice, pf, s);
      break;
    case DT_F8E5:
      err = launch<fp8e5>(a, qsu, m, n, lda, r, q_exact, slices,
                          rows_per_slice, pf, s);
      break;
    default:
      err = launch<float>(a, qsu, m, n, lda, r, q_exact, slices,
                          rows_per_slice, pf, s);
  }
  if (err != cudaSuccess) return err;
  return reduce(pf, slices, (long long)n * r, out, out_dtype, s);
}
