// Tall-skinny Gram matrix G = A^T A for an (m x n) row-major A.
//
// Replaces the TPU kernel src/repro/kernels/tsgram.py:tsgram
// (_tsgram_kernel).  Bound by operations on the H100: m*n*(n+1) flops for
// the distinct entries against one read of A.  Products run on the tensor
// cores, f32 as 3xTF32 on wgmma, bf16 as bf16 on mma.sync, fp8 (e4m3 and
// e5m2) as f16 on mma.sync.
//
// Products.  f32: each operand x splits into hi, x with its low 13 bits
// cleared, and lo = x - hi (exact in f32), and a*b is a_lo*b_hi +
// a_hi*b_lo + a_hi*b_hi, as in randsketch.cu: one TF32 product keeps three
// decimal digits, and the Gram has to meet f32's limits.  bf16 storage is
// exact in one mma.sync.m16n8k16 (f32 += bf16 x bf16), one product.
//
// Why wgmma for f32, and how.  mma.sync.m16n8k8 at TF32 runs at about half
// the tensor cores' TF32 rate on this card, and a first version on it
// (8 warps, 64 x 32 outputs each) spent as long again on the fragments'
// loads and splits: 41 ms at 2^21 x 1024, where dropping a third of its
// mmas saved a tenth (tools/diagnose_kernels.py; PERF.md).  wgmma
// takes .tf32 operands K-major only, and both operands here are MN-major
// (the sum runs down the rows of A).  So A, the I columns (rows of G),
// comes from registers, in the mma.sync fragment layout, loaded element by
// element from the staged rows (the shift below costs nothing there); and
// B, the J columns, is written once a stage by a register pass (split_b)
// as its TF32 high and low parts, transposed to K-major, in the canonical
// layout without swizzle (8 x 16-byte core matrices), where wgmma's
// descriptors read it.  The pass for stage c runs while stage c - 1's
// wgmmas are in flight.  bf16 keeps mma.sync: its operands would need the
// same pass, and it is not the main path's type.
//
// fp8 storage takes the bf16 route's staging, K order and mma.sync
// products, with 16 values a 16-byte piece: each pair of staged bytes a
// fragment packs is converted to f16x2 as it is packed (cvt.rn.f16x2.
// e4m3x2 or .e5m2x2, exact: every fp8 value is an f16 value) and
// multiplied by mma.sync.m16n8k16 in f16 with f32 accumulators, the same
// rate and fragment layout as bf16's.  f16 rather than bf16: the conversion is one
// instruction, where bf16 would take a round trip through f32.  Not the
// fp8 tensor-core products: their accumulators keep about 14 bits on this
// card, short of the f32 sums the Gram needs over 2^21 rows, and their
// wgmma wants both operands K-major, which A^T A's rows are not.
//
// Tiles.  G is symmetric: only the upper triangle of 128 x 128 output
// tiles is computed (blockIdx.x enumerates the pairs ti <= tj), and the
// last pass mirrors it.  A block is 8 warps, one block an SM.  f32: two
// warpgroups, each a 64 x 128 wgmma accumulator (m64n128k8).  bf16: 2 x 4
// warps, each 64 x 32 outputs (four m16 by four n8 mma tiles).  A's rows
// stream through a ring of stages of 32 rows, filled by every thread with
// 16-byte cp.async copies, so the next stages land while this one is
// multiplied.  A stage holds the rows' columns I = [i0, i0 + 128) and
// J = [j0, j0 + 128); a diagonal tile (I = J) stages them once.
//
// K order.  A k-step reads its rows so that the rows one shared load of
// a warp touches (one per lane group t) lie in adjacent staging slots and
// have the same shift: f32 (k8) k-step j multiplies rows j + 4 kk,
// kk = 0..7 (rows 4 apart: 4n = 0 mod 4 elements); bf16 (m16n8k16) k-step
// j multiplies, at K index 2t + b + 8h, row 8t + b + 2h + 4j (rows 8
// apart: 8n = 0 mod 8).  slot() places those rows in adjacent slots, 8
// banks apart, so a fragment's loads never share a bank, whatever the
// shifts.  A and B take the same K order, so the sum is unchanged.  fp8
// takes bf16's order and slots (its rows 8 apart share a shift when n is
// even; each row's shift is computed apart, so any n gives the same sums).
//
// Any width, any start (as randsketch.cu).  Row k's segment of a column
// tile starts at element p + k*n + c0 counted from the 16-byte boundary at
// or below A's start (p is A's start in elements past that boundary, c0 the
// tile's first column, a multiple of 128).  The stage copies the 16-byte
// pieces from that element rounded down to a piece, as many as the tile's
// 128 columns span, and keeps the row's shift s_k = (p + k*n) mod
// (16 / sizeof(T)), computed where it is needed, never stored; a fragment
// reads element (k, c) at smem[slot(k)][s_k + c].  An aligned A (every
// s_k = 0) takes the same code.  Each piece read holds at least one byte
// of A, and device allocations start on 256-byte boundaries and are whole
// multiples of 16 bytes, so every piece lies inside A's allocation.  Its
// bytes outside the view may hold anything, a NaN included.  Fragments
// read only the tile's columns; where the tile reaches past A's last
// column, the copy of a row's last piece reads only the bytes up to that
// column (cp.async's src-size) and fills the rest with zeros, and the
// pieces past it up to the tile's width arrive as zeros, so the columns
// past A's last are zeros in every stage, never multiplied garbage, and
// the products need no select.  Rows past the slice's end arrive as zeros
// as well.
//
// Sums.  Products of kSumRows rows start from zero in the tensor cores'
// accumulators and are then added to a running f32 total on the CUDA cores
// (the tensor cores lose accuracy on long f32 accumulation chains).  The
// rows are cut into slices (tsgram.py:slicing); each slice writes its own
// f32 partial tile and a last pass sums the slices in slice order, mirrors
// the lower triangle and casts to the output type: the same bits on every
// run, no float atomics.  The products and the order of every sum follow
// from (m, n) and the card alone, so an offset view gives the same bits as
// its aligned copy.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kTile = 128;    // output tile: 128 columns of A by 128
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;     // rows of A a stage
constexpr int kSumRows = 64;  // rows summed in the tensor cores' accumulators
constexpr int kSumChunks = kSumRows / kRows;
constexpr int kRowThreads = kThreads / kRows;   // threads copying a row
constexpr int kSmemMax = 232448;   // shared memory a block may use
static_assert(kRows == 32 && kSumRows % kRows == 0,
              "slot() and the k-steps are written for stages of 32 rows");

// f32's B operand, a stage's J columns split and K-major: for each k-step
// j, part (high, low), K half h and group of 8 columns, a core matrix of 8
// columns x 4 K values (16 bytes a column).  Two buffers, so that the pass
// for one stage runs while the other's wgmmas read.
constexpr int kCoreBytes = 8 * 16;
constexpr int kSplitLbo = (kTile / 8) * kCoreBytes;   // K half to K half
constexpr int kSplitStep = 2 * kSplitLbo;             // k-step to k-step
constexpr int kSplitPart = (kRows / 8) * kSplitStep;  // high to low
constexpr int kSplitBuf = 2 * kSplitPart;

// Staging by storage type: kVec elements a 16-byte piece; a staged row of
// a column tile holds kStride elements (the widest window, kTile + kVec,
// and more: rows one slot apart fall 8 banks apart); a ring of 4 stages,
// and for f32 the two split buffers after it.
template <typename T>
struct Staging {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kStride = kTile + 32 / (int)sizeof(T);
  static constexpr int kOperandBytes = kRows * kStride * (int)sizeof(T);
  static constexpr int kStageBytes = 2 * kOperandBytes;
  static constexpr int kStages = 4;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmem =
      kRingBytes + (std::is_same<T, float>::value ? 2 * kSplitBuf : 0);
  static_assert(kTile + kVec <= kStride, "a window must fit a staged row");
  static_assert(kSmem <= kSmemMax, "the staging must fit a block");
};

// The staging slot of stage row k (see "K order" above).
template <typename T>
__device__ __forceinline__ int slot(int k) {
  if constexpr (std::is_same<T, float>::value)
    return (k & 3) * (kRows / 4) + (k >> 2);
  else
    return (k & 7) * (kRows / 8) + (k >> 3);
}

// Row k's shift in its window: (p + k n) mod kVec (computed mod 2^32, which
// kVec divides).
template <typename T>
__device__ __forceinline__ int row_shift(int p, unsigned k, int n) {
  return (int)(((unsigned)p + k * (unsigned)n) &
               (unsigned)(Staging<T>::kVec - 1));
}

// d += a (16 x 16, bf16) * b (16 x 8, bf16), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 16, f16) * b (16 x 8, f16), f32 accumulators.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 bit patterns in one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(unsigned short lo,
                                              unsigned short hi) {
  return __byte_perm((uint32_t)lo, (uint32_t)hi, 0x5410);
}

// The 16-bit routes' operand: what a staged element is read as (U), how
// two of them become one 32-bit fragment register (`lo` in the low half)
// and the mma that multiplies them.  bf16 as it is; fp8 converted to f16
// as it is packed.
template <typename T>
struct Route16;
template <>
struct Route16<__nv_bfloat16> {
  using U = unsigned short;
  static __device__ __forceinline__ uint32_t pack(U lo, U hi) {
    return pack_bf16(lo, hi);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_bf16(d, a, b0, b1);
  }
};
// fp8 (e4m3 or e5m2): each pair converted to f16x2 by one cvt as it is
// packed, multiplied in f16.
template <typename T>
struct Route16Fp8 {
  using U = unsigned char;
  static __device__ __forceinline__ uint32_t pack(U lo, U hi) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(lo | (hi << 8)), Fp8<T>::kKind);
    return (uint32_t)h.x | ((uint32_t)h.y << 16);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_f16(d, a, b0, b1);
  }
};
template <>
struct Route16<fp8> : Route16Fp8<fp8> {};
template <>
struct Route16<fp8e5> : Route16Fp8<fp8e5> {};

// A block's tile pair, its slice of rows and its ring of stages, and the
// copies that fill the ring (both product routes share them).
template <typename T>
struct Rows {
  using S = Staging<T>;
  unsigned char* smem;
  const T* a16;       // the 16-byte boundary at or below A's start
  int p;              // A's start in elements past it
  int n, i0, j0;
  bool diag;
  long long r_begin, r_end;
  int nchunks;

  __device__ __forceinline__ Rows(const T* a, long long m, int n_, int tiles,
                                  long long rows_per_slice,
                                  unsigned char* smem_)
      : smem(smem_), n(n_) {
    // blockIdx.x enumerates the upper-triangle tile pairs (ti <= tj) row
    // by row.
    int pidx = blockIdx.x, ti = 0;
    while (pidx >= tiles - ti) {
      pidx -= tiles - ti;
      ++ti;
    }
    const int tj = ti + pidx;
    diag = ti == tj;
    i0 = ti * kTile;
    j0 = tj * kTile;
    r_begin = (long long)blockIdx.y * rows_per_slice;
    r_end = min(m, r_begin + rows_per_slice);
    nchunks = r_end > r_begin ? (int)((r_end - r_begin + kRows - 1) / kRows)
                              : 0;
    p = (int)((reinterpret_cast<uintptr_t>(a) & 15) / sizeof(T));
    a16 = a - p;
  }

  // Operand o (0: columns I, 1: columns J) of stage `buf`; a diagonal
  // tile reads both from operand 0.
  __device__ __forceinline__ T* stage(int buf, int o) const {
    return reinterpret_cast<T*>(smem + buf * S::kStageBytes +
                                (diag ? 0 : o) * S::kOperandBytes);
  }

  // Copy chunk `chunk`'s rows of A[:, I] (and of A[:, J] off the
  // diagonal), each row's window by the kRowThreads threads of its group,
  // into stage `buf`: the pieces that cover the tile's width.  In a tile
  // that reaches past A's last column each piece reads only its bytes
  // before that column (`bytes`, at most 16) and fills the rest with
  // zeros; in the others every piece is read whole (its bytes past the
  // tile are never read back).
  __device__ __forceinline__ void issue(int chunk, int buf) const {
    const int crow = threadIdx.x / kRowThreads;
    const int csub = threadIdx.x % kRowThreads;
    const long long row = r_begin + (long long)chunk * kRows + crow;
    const bool live = row < r_end;
    const long long base = p + row * n;
    const int shift = (int)(base & (S::kVec - 1));
    const int pieces = (shift + kTile + S::kVec - 1) / S::kVec;
    for (int o = 0; o < (diag ? 1 : 2); ++o) {
      const int c0 = o ? j0 : i0;
      const int end = !live                ? 0
                      : c0 + kTile <= n    ? 16 * pieces
                                           : (shift + n - c0) * (int)sizeof(T);
      const T* src = a16 + (base + c0 - shift);
      T* dst = stage(buf, o) + slot<T>(crow) * S::kStride;
      for (int pc = csub; pc < pieces; pc += kRowThreads) {
        const int bytes = min(max(end - 16 * pc, 0), 16);
        cp_async16_zfill(dst + pc * S::kVec, bytes ? src + pc * S::kVec : a16,
                         bytes);
      }
    }
  }

  __device__ __forceinline__ unsigned row0(int chunk) const {
    return (unsigned)(r_begin + (long long)chunk * kRows);
  }
};

// f32, the split pass: stage rows row0 .. row0 + 31 of the J columns (`sj`)
// into `sb` as their TF32 high and low parts, K-major.  Thread (column
// c = tid % 128, half = tid / 128) writes, for the four (k-step, K half)
// pairs of its half, the 4 K values of column c: rows 4 apart (one shift),
// one 16-byte store each part.
__device__ __forceinline__ void split_b(const float* sj, unsigned char* sb,
                                        unsigned row0, int p, int n) {
  using S = Staging<float>;
  const int c = threadIdx.x % kTile, half = threadIdx.x / kTile;
  unsigned char* dst = sb + (c >> 3) * kCoreBytes + (c & 7) * 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = (4 * half + q) >> 1, h = q & 1;
    // K index 4h + u of k-step j is row j + 16h + 4u.
    const int k0 = j + 16 * h;
    const int s = row_shift<float>(p, row0 + k0, n);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      split_tf32(sj[slot<float>(k0 + 4 * u) * S::kStride + s + c], hi[u],
                 lo[u]);
    unsigned char* d = dst + j * kSplitStep + h * kSplitLbo;
    *reinterpret_cast<uint4*>(d) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(d + kSplitPart) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// f32, the A fragments of a stage: for each k-step j, the lane's four
// values of the I columns (M g and g + 8 from column ci, K t and t + 4:
// rows j + 4t and j + 4t + 16, one shift), split.
__device__ __forceinline__ void load_a(const float* si, unsigned row0, int p,
                                       int n, int ci, int t,
                                       uint32_t (&ahi)[4][4],
                                       uint32_t (&alo)[4][4]) {
  using S = Staging<float>;
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
    const int ka = j + 4 * t, kb = ka + 16;
    const int s = row_shift<float>(p, row0 + ka, n);
    const float* ra = si + slot<float>(ka) * S::kStride + s + ci;
    const float* rb = si + slot<float>(kb) * S::kStride + s + ci;
    const float v[4] = {ra[0], ra[8], rb[0], rb[8]};
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], ahi[j][e], alo[j][e]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
tsgram_f32(const float* __restrict__ a, long long m, int n, int tiles,
           long long rows_per_slice, float* __restrict__ part) {
  using S = Staging<float>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Rows<float> rw(a, m, n, tiles, rows_per_slice, smem);
  unsigned char* split = smem + S::kRingBytes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // Warpgroup wg owns rows 64 wg .. of the tile; the lane's A rows (its
  // I columns) start at ci.
  const int wg = warp >> 2;
  const int ci = 64 * wg + 16 * (warp & 3) + g;

  float total[64], acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) total[e] = acc[e] = 0.f;
  uint32_t ahi[4][4], alo[4][4];

  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < rw.nchunks) rw.issue(s, s);
    cp_async_commit();
  }
  // Chunk c: stage c landed; the next copies issued; the split pass of
  // stage c (while chunk c - 1's wgmmas run); chunk c - 1's products
  // waited for and, at a run's end, added to the totals; A's fragments;
  // the split made visible; then chunk c's twelve wgmmas, the first of a
  // run from zero.  Chunk 0 is peeled off the loop, so that every path
  // into the loop has one chunk's wgmmas in flight.
  auto begin = [&](int c) {
    cp_async_wait<S::kStages - 2>();
    __syncthreads();   // stage c landed; every thread is done with c - 1
    if (c + S::kStages - 1 < rw.nchunks)
      rw.issue(c + S::kStages - 1, (c + S::kStages - 1) % S::kStages);
    cp_async_commit();
    split_b(rw.stage(c % S::kStages, 1), split + (c & 1) * kSplitBuf,
            rw.row0(c), rw.p, n);
  };
  auto products = [&](int c) {
    load_a(rw.stage(c % S::kStages, 0), rw.row0(c), rw.p, n, ci, t, ahi,
           alo);
    // The split's stores, made visible to the tensor cores.  (ptxas 12.9
    // crashes where this fence follows the split pass directly.)
    fence_proxy_async();
    __syncthreads();   // every thread's split of stage c is in place
    wgmma_fence();
    const unsigned char* sb = split + (c & 1) * kSplitBuf;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const uint64_t dhi = smem_desc(sb + j * kSplitStep, kSplitLbo,
                                     kCoreBytes, 0);
      const uint64_t dlo = smem_desc(sb + kSplitPart + j * kSplitStep,
                                     kSplitLbo, kCoreBytes, 0);
      wgmma_tf32(acc, alo[j], dhi, j > 0 || c % kSumChunks != 0);
      wgmma_tf32(acc, ahi[j], dlo, 1);
      wgmma_tf32(acc, ahi[j], dhi, 1);
    }
    wgmma_commit();
  };
  if (rw.nchunks > 0) {
    begin(0);
    products(0);
    for (int c = 1; c < rw.nchunks; ++c) {
      begin(c);
      wgmma_wait<0>();
      if (c % kSumChunks == 0) {
#pragma unroll
        for (int e = 0; e < 64; ++e) total[e] += acc[e];
      }
      products(c);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 64; ++e) total[e] += acc[e];
  }

  // Accumulator: e = 4 cc + i at row 16 (warp % 4) + g + 8 (i / 2),
  // column 8 cc + 2t + i % 2.
  float* out = part + (size_t)blockIdx.y * n * n;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int i = rw.i0 + ci + 8 * ((e & 3) >> 1);
    const int jj = rw.j0 + 8 * (e >> 2) + 2 * t + (e & 1);
    if (i < n && jj < n) out[(size_t)i * n + jj] = total[e];
  }
}

// bf16 or fp8, one stage's products: stage rows row0 .. row0 + 31 of the
// I columns (`si`) against the J columns (`sj`), for the 64 x 32 outputs
// of a warp whose lane reads I columns ci + 16 mt + 8 h and J columns
// cj + 8 nt of the tile.
template <typename T>
__device__ __forceinline__ void stage_products_16(
    const T* si, const T* sj, unsigned row0, int p, int n, int ci, int cj,
    int t, float (&acc)[4][4][4]) {
  using S = Staging<T>;
  using R = Route16<T>;
  using U = typename R::U;
#pragma unroll
  for (int j = 0; j < kRows / 16; ++j) {
    // K indices 2t, 2t + 1, 2t + 8, 2t + 9 are rows k0 + 0 .. k0 + 3,
    // each with its own shift.
    const int k0 = 8 * t + 4 * j;
    const U* ra[4];
    const U* ca[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int off = slot<T>(k0 + c) * S::kStride +
                      row_shift<T>(p, row0 + k0 + c, n);
      ra[c] = reinterpret_cast<const U*>(si + off + ci);
      ca[c] = reinterpret_cast<const U*>(sj + off + cj);
    }
    // B fragments (k16 x n8): b0 (K 2t, 2t + 1; N g), b1 (K 2t + 8, 2t + 9).
    uint32_t b[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      b[nt][0] = R::pack(ca[0][8 * nt], ca[1][8 * nt]);
      b[nt][1] = R::pack(ca[2][8 * nt], ca[3][8 * nt]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      // A fragment (m16 x k16): a0 (M g, K 2t..), a1 (g + 8, 2t..),
      // a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..).
      U v[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[h][c] = ra[c][16 * mt + 8 * h];
      const uint32_t a[4] = {R::pack(v[0][0], v[0][1]),
                             R::pack(v[1][0], v[1][1]),
                             R::pack(v[0][2], v[0][3]),
                             R::pack(v[1][2], v[1][3])};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) R::mma(acc[mt][nt], a, b[nt][0], b[nt][1]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
tsgram_16(const T* __restrict__ a, long long m, int n, int tiles,
          long long rows_per_slice, float* __restrict__ part) {
  using S = Staging<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Rows<T> rw(a, m, n, tiles, rows_per_slice, smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ci = (warp >> 2) * 64 + g;   // the lane's first I column
  const int cj = (warp & 3) * 32 + g;    // and J column, in the tile

  float total[4][4][4], acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[mt][nt][e] = acc[mt][nt][e] = 0.f;

  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < rw.nchunks) rw.issue(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < rw.nchunks; ++c) {
    cp_async_wait<S::kStages - 2>();
    __syncthreads();   // chunk c landed; every warp is done with c - 1
    if (c + S::kStages - 1 < rw.nchunks)
      rw.issue(c + S::kStages - 1, (c + S::kStages - 1) % S::kStages);
    cp_async_commit();
    stage_products_16<T>(rw.stage(c % S::kStages, 0),
                         rw.stage(c % S::kStages, 1), rw.row0(c), rw.p, n,
                         ci, cj, t, acc);
    if (c % kSumChunks == kSumChunks - 1 || c == rw.nchunks - 1) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[mt][nt][e] += acc[mt][nt][e];
            acc[mt][nt][e] = 0.f;
          }
    }
  }

  // Accumulator (m16 x n8): e = 0, 1 at (g, 2t + e), e = 2, 3 at g + 8.
  float* out = part + (size_t)blockIdx.y * n * n;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rw.i0 + ci + 16 * mt + 8 * (e >> 1);
        const int jj = rw.j0 + (cj - g) + 8 * nt + 2 * t + (e & 1);
        if (i < n && jj < n) out[(size_t)i * n + jj] = total[mt][nt][e];
      }
}

// Last pass: G[i, j] = sum over slices of part[(min, max)] in slice order.
template <typename TO>
__global__ void tsgram_reduce(const float* __restrict__ part, int slices,
                              int n, TO* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)n * n) return;
  const int i = (int)(e / n), j = (int)(e % n);
  const size_t src = (size_t)min(i, j) * n + max(i, j);
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += part[(size_t)k * n * n + src];
  store_f32(out + e, s);
}

template <typename T, typename K>
cudaError_t launch(K kernel, const void* a, long long m, int n, int slices,
                   long long rows_per_slice, float* part, cudaStream_t s) {
  constexpr int smem = Staging<T>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, slices);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(a), m, n, tiles,
                                      rows_per_slice, part);
  return cudaGetLastError();
}

}  // namespace

// a (m, n) f32, bf16, e4m3 or e5m2, any start, contiguous; part
// (slices, n, n)
// f32 scratch, slices of whole stages; out (n, n) in out_dtype (f32 or
// bf16).
extern "C" int repro_tsgram(int device, const void* a, int dtype, long long m,
                            int n, int slices, long long rows_per_slice,
                            void* part, void* out, int out_dtype,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows_per_slice % kRows || slices < 1 || slices > 65535 || n < 1 ||
      (dtype != DT_F32 && dtype != DT_BF16 && dtype != DT_F8 &&
       dtype != DT_F8E5) ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  err = dtype == DT_BF16
            ? launch<__nv_bfloat16>(tsgram_16<__nv_bfloat16>, a, m, n,
                                    slices, rows_per_slice, pf, s)
        : dtype == DT_F8
            ? launch<fp8>(tsgram_16<fp8>, a, m, n, slices, rows_per_slice,
                          pf, s)
        : dtype == DT_F8E5
            ? launch<fp8e5>(tsgram_16<fp8e5>, a, m, n, slices,
                            rows_per_slice, pf, s)
            : launch<float>(tsgram_f32, a, m, n, slices, rows_per_slice, pf,
                            s);
  if (err != cudaSuccess) return err;
  const long long total = (long long)n * n;
  constexpr int kReduceThreads = 256;
  const unsigned rblocks =
      (unsigned)((total + kReduceThreads - 1) / kReduceThreads);
  if (out_dtype == DT_BF16)
    tsgram_reduce<__nv_bfloat16><<<rblocks, kReduceThreads, 0, s>>>(
        pf, slices, n, static_cast<__nv_bfloat16*>(out));
  else
    tsgram_reduce<float><<<rblocks, kReduceThreads, 0, s>>>(
        pf, slices, n, static_cast<float*>(out));
  return cudaGetLastError();
}
