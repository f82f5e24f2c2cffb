// Dense product C = A @ B, A (m x K) f32, bf16, e4m3 or e5m2, B (K x N) f32
// or bf16, C f32 or bf16, all row-major, sums in f32.
//
// Replaces the TPU kernel src/repro/kernels/gemm.py:gemm (_gemm_kernel).
// On the paths it runs skinny: U = A (V S^-1) in the SVD (K = 1024 or
// 16384, N = 16), Y = A_w Z in the randomized SVD (K = 16384, N = 26) and
// TSQR's Q = Y R^-1 (K = N = 26).  It is bound there by the bytes of A:
// 2mKN flops against one read of A.  In f32 FMA on the CUDA cores the
// products of A_w by 32 padded columns alone take 4.1 ms against the 5.1
// ms bytes bound, so here they run on the tensor cores.
//
// Products: TF32 on the tensor cores' warpgroup multiply (wgmma
// m64n{8,16,32}k8, f32 += tf32 x tf32) in exact splits (common.cuh:
// split_tf32): f32 x f32 is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (3xTF32),
// bf16 x f32 is a*b_lo + a*b_hi, f32 x bf16 is a_lo*b + a_hi*b, bf16 x
// bf16 is a*b: bf16 is exact in TF32, and so are e4m3 and e5m2, which take
// bf16's products (upcast to f32 as their fragments load).  A development version
// on mma.sync.m16n8k8 spent about as long on the products of A_w by 32
// columns alone as the bytes bound allows for the whole.
// wgmma takes .tf32 operands K-major only: A (rows of K values) is K-major
// and comes from registers in the mma.sync fragment layout, loaded element
// by element from the staged rows (the row shifts below cost nothing
// there) and split there; B's k-slice (at most 128 x 32 values, in L2) is
// split by the block itself once a stage, straight into the canonical
// K-major layout without swizzle (8 x 16-byte core matrices) in which the
// wgmmas' descriptors read it: its loads issue an iteration before its
// stores, which go out with the stage's copies.  There is no second kernel
// and no scratch: a development version that split B once a launch in a
// first pass took a third longer at TSQR's 2^18 x 26 x 26 and up to a
// tenth less at A_w in bf16 (tools/time_gemm.py, PERF.md).
//
// Tiles.  A block owns 256 x (8 NT) output tiles (NT = 1, 2 or 4 n8 tiles,
// from N: a narrow B spends no products on zero columns; N > 32 takes
// several column tiles) across all of K, so there is no cross-block sum
// and no atomic: two runs give the same bits, and a row's bits depend on
// its own row of A and on B alone, not on m or on where A starts.  The grid
// is persistent (one block an SM, gridDim.x of them), each block walking
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... with one ring of stages
// across them, so a tile's first copies overlap the last tile's products.
// Four warpgroups each own 64 rows (one m64 wgmma tile).  A stage holds 256
// bytes of each of the tile's 256 rows (64 f32 or 128 bf16 values of K;
// 128 bytes, 128 values, in fp8, whose B split for 256 values would not
// leave room for two stages at NT = 4) and B's split k-slice; the ring has
// two stages (three at NT = 1), filled by every thread with 16-byte
// cp.async copies, so the next stage lands while this one is multiplied.
// 128-row tiles and 128-byte rows, each with a ring of 4 stages, were
// slower for f32 (tools/diagnose_kernels.py --kernel gemm, PERF.md): long
// row segments and tall tiles (B's k-slice is read once a tile) weigh more
// than the ring's depth.
//
// Any K, any start.  Row r's 256 (fp8: 128) bytes of a stage start at
// element p + r*K + k0 counted from the 16-byte boundary at or below A's
// start (p is A's start in elements past that boundary, k0 the stage's
// first column).  The stage copies the 17 (9) pieces from that element
// rounded down to a piece (one more than an aligned row needs) and a
// fragment reads element
// (r, k) at row r's slot, at s_r + k: s_r = (p + r*K) mod (16 / sizeof(T)),
// the same for every stage of the row, computed, never stored.  An aligned
// A with K a multiple of the piece (every s_r = 0) takes the same code.
// Each piece reads only its bytes inside the row's stage (cp.async's
// src-size) and writes zeros after them, so columns past K are zeros, never
// multiplied garbage, and the products need no select; rows past m arrive
// as zeros.  Each piece read holds a byte of A, and device allocations start
// on 256-byte boundaries and are whole multiples of 16 bytes, so every
// piece lies inside A's allocation.  Staged rows are 272 bytes apart (68
// words; fp8 144, 36 words), so the rows of a fragment load (g = 0..7)
// fall on distinct banks when their shifts agree and at most two to a bank
// when they do not.
//
// Sums.  Each stage's products start from zero in the wgmma accumulators
// and are then added to a running f32 total on the CUDA cores (Hopper's
// tensor cores lose accuracy on long f32 accumulation chains).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileM = 16 * kWarps;    // rows of a tile: 64 a warpgroup
constexpr int kCoreBytes = 128;        // a core matrix: 8 columns x 16 bytes
constexpr int kSmemMax = 232448;       // shared memory a block may use

// B's split for one k-step of a column tile of NT n8 tiles, K-major: part
// (high, low), K half h, n8 tile c, then a core matrix of 8 columns x 4 K
// values.  wgmma reads a part through a descriptor with LBO = the distance
// between K halves and SBO = kCoreBytes, the distance between n8 tiles.
template <int NT>
struct SplitStep {
  static constexpr int kLbo = NT * kCoreBytes;
  static constexpr int kPart = 2 * kLbo;
  static constexpr int kBytes = 2 * kPart;
};

// Staging by A's storage type and the tile's n8 tiles: kVec elements a
// piece, kRowBytes of each row (kChunk columns of A, kSteps k-steps) a
// stage, each row's window kRowStride bytes (kRowPieces pieces, copied by
// kRowThreads threads, kCopyRows rows at a time), B's split of those
// k-steps after A's rows, as many stages as fit, up to 4.
template <typename TA, int NT>
struct Staging {
  static constexpr int kVec = 16 / (int)sizeof(TA);
  static constexpr int kRowBytes = sizeof(TA) == 1 ? 128 : 256;
  static constexpr int kRowStride = kRowBytes + 16;
  static constexpr int kRowPieces = kRowStride / 16;
  static constexpr int kRowThreads = kRowBytes / 16;
  static constexpr int kCopyRows = kThreads / kRowThreads;
  static constexpr int kChunk = kRowBytes / (int)sizeof(TA);
  static constexpr int kSteps = kChunk / 8;
  // The stage's products in kParts commit groups of kPartSteps k-steps
  // (8 registers of A a k-step in f32, 4 in bf16 and fp8).
  static constexpr int kPartSteps = sizeof(TA) == 4 ? 1 : 2;
  static constexpr int kParts = kSteps / kPartSteps;
  static constexpr int kBBytes = kSteps * SplitStep<NT>::kBytes;
  // B's split a stage: groups of 4 K values of one column (a core-matrix
  // row), kBGroups of them, kBLoads a thread.
  static constexpr int kBGroups = kSteps * 2 * NT * 8;
  static constexpr int kBLoads = (kBGroups + kThreads - 1) / kThreads;
  static constexpr int kABytes = kTileM * kRowStride;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages =
      kSmemMax / kStageBytes < 4 ? kSmemMax / kStageBytes : 4;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kStages >= 2, "a ring needs two stages");
  static_assert(kABytes % kCoreBytes == 0 && kStageBytes % kCoreBytes == 0,
                "B's core matrices on 128-byte boundaries");
};

// The next (tile, stage) of a block's walk: its tiles are blockIdx.x,
// blockIdx.x + gridDim.x, ..., each nchunks stages long; row0 and ct are
// the tile's first row and column tile.
struct Cursor {
  long long row0;
  int tile, ct, chunk;
  __device__ __forceinline__ void start(int tile_, int ctiles) {
    tile = tile_;
    row0 = (long long)(tile / ctiles) * kTileM;
    ct = (int)(tile % ctiles);
    chunk = 0;
  }
  __device__ __forceinline__ void advance(int nchunks, int ctiles) {
    if (++chunk == nchunks) start(tile + (int)gridDim.x, ctiles);
  }
};

template <typename TA, typename TB, int NT>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tc(const TA* __restrict__ a, const TB* __restrict__ b,
        void* __restrict__ c, int c_bf16, long long m, int K, int N,
        int ctiles, int tiles) {
  using S = Staging<TA, NT>;
  using B = SplitStep<NT>;
  constexpr bool kALo = std::is_same<TA, float>::value;
  constexpr bool kBLo = std::is_same<TB, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nchunks = max((K + S::kChunk - 1) / S::kChunk, 1);
  // A's start in elements past the 16-byte boundary at or below it, and
  // that boundary: element e of A's storage order lies at a16 + (p + e).
  const int p = (int)((reinterpret_cast<uintptr_t>(a) & 15) / sizeof(TA));
  const TA* a16 = a - p;

  // Copy stage `cur` (A's rows of its tile, kRowBytes from column k0, each
  // row's window by the kRowThreads threads of its group) into buffer
  // `buf`.
  const int crow = threadIdx.x / S::kRowThreads;
  const int csub = threadIdx.x % S::kRowThreads;
  auto issue = [&](const Cursor& cur, int buf) {
    unsigned char* sa = smem + buf * S::kStageBytes;
    const int k0 = cur.chunk * S::kChunk;
    const int len = min(S::kChunk, K - k0);
    for (int r = crow; r < kTileM; r += S::kCopyRows) {
      const long long row = cur.row0 + r;
      const long long first = p + row * K + k0;
      const int shift = (int)(first & (S::kVec - 1));
      // Bytes of the window that hold the row's columns k0 .. k0 + len - 1.
      const int end = row < m && len > 0 ? (shift + len) * (int)sizeof(TA)
                                         : 0;
      const TA* src = a16 + (first - shift);
      // A piece that reads nothing names its row's window (A's first piece
      // past m), so that the zero fills do not all name one address.
      for (int pc = csub; pc < S::kRowPieces; pc += S::kRowThreads) {
        const int bytes = min(max(end - 16 * pc, 0), 16);
        cp_async16_zfill(sa + r * S::kRowStride + 16 * pc,
                         bytes ? src + pc * S::kVec : (row < m ? src : a16),
                         bytes);
      }
    }
  };

  // B's split of stage `cur`, in two halves: load_b reads the thread's
  // groups of its k-slice (group e: K values k0 + 8 s + 4 h + u, u < 4, of
  // column 8 NT ct + 8 j + r, for e = ((s * 2 + h) * NT + j) * 8 + r; zeros
  // past K and N), store_b splits them into buffer `buf`'s B region in
  // SplitStep's layout, high parts and (for an f32 B) low parts.
  float braw[S::kBLoads][4];
  auto load_b = [&](const Cursor& cur) {
#pragma unroll
    for (int i = 0; i < S::kBLoads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e & 7, j = (e >> 3) % NT, sh = (e >> 3) / NT;
      const int col = cur.ct * 8 * NT + 8 * j + r;
      const int k = cur.chunk * S::kChunk + 4 * sh;   // sh = 2 s + h
#pragma unroll
      for (int u = 0; u < 4; ++u)
        braw[i][u] = e < S::kBGroups && col < N && k + u < K
                         ? to_f32(b[(long long)(k + u) * N + col])
                         : 0.f;
    }
  };
  auto store_b = [&](int buf) {
    unsigned char* sb = smem + buf * S::kStageBytes + S::kABytes;
#pragma unroll
    for (int i = 0; i < S::kBLoads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e >= S::kBGroups) continue;
      const int r = e & 7, j = (e >> 3) % NT, sh = (e >> 3) / NT;
      unsigned char* d = sb + (sh >> 1) * B::kBytes + (sh & 1) * B::kLbo +
                         j * kCoreBytes + 16 * r;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) split_tf32(braw[i][u], hi[u], lo[u]);
      *reinterpret_cast<uint4*>(d) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      if constexpr (kBLo)
        *reinterpret_cast<uint4*>(d + B::kPart) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // The lane's rows of the tile: r0 and r0 + 8 (warpgroup warp / 4 owns
  // rows 64 (warp / 4) .., warp w of it rows 16 (w % 4) ..).
  const int r0 = 16 * warp + g;
  float total[4 * NT], acc[4 * NT];
#pragma unroll
  for (int e = 0; e < 4 * NT; ++e) total[e] = acc[e] = 0.f;
  uint32_t ahi[2][S::kPartSteps][4], alo[2][S::kPartSteps][4];

  // The stage `cur` in buffer `buf`, in kParts parts of kPartSteps
  // k-steps, each committed on its own: A's fragments of the part's k-steps
  // (a0 (r0, t), a1 (r0 + 8, t), a2 (r0, t + 4), a3 (r0 + 8, t + 4),
  // columns 8 s + t (+ 4) of the stage, at the rows' shifts), split into
  // one of two register buffers, then its wgmmas, the stage's first from
  // zero.  A part's fragments load while the part before runs; the buffer
  // is reused once the part two back is done (so few registers are live
  // that ptxas neither spills nor serializes the wgmmas).
  auto products = [&](const Cursor& cur, int buf) {
    const unsigned char* sa = smem + buf * S::kStageBytes;
    const unsigned char* sb = sa + S::kABytes;
    // The rows' shifts (mod 2^32 keeps the residue: kVec divides 2^32, and
    // k0 is a multiple of kVec).
    const TA* row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const int sh = (int)(((unsigned)p + (unsigned)(cur.row0 + r) *
                                              (unsigned)K) &
                           (S::kVec - 1));
      row[h] = reinterpret_cast<const TA*>(sa + r * S::kRowStride) + sh + t;
    }
#pragma unroll
    for (int part = 0; part < S::kParts; ++part) {
      uint32_t(&hi)[S::kPartSteps][4] = ahi[part & 1];
      uint32_t(&lo)[S::kPartSteps][4] = alo[part & 1];
      if (part >= 2) wgmma_wait<1>();
#pragma unroll
      for (int u = 0; u < S::kPartSteps; ++u) {
        const int s = part * S::kPartSteps + u;
        const float v[4] = {to_f32(row[0][8 * s]), to_f32(row[1][8 * s]),
                            to_f32(row[0][8 * s + 4]),
                            to_f32(row[1][8 * s + 4])};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kALo)
            split_tf32(v[i], hi[u][i], lo[u][i]);
          else
            hi[u][i] = __float_as_uint(v[i]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < S::kPartSteps; ++u) {
        const int s = part * S::kPartSteps + u;
        const uint64_t dhi =
            smem_desc(sb + s * B::kBytes, B::kLbo, kCoreBytes, 0);
        const uint64_t dlo =
            smem_desc(sb + s * B::kBytes + B::kPart, B::kLbo, kCoreBytes, 0);
        if constexpr (kALo) wgmma_tf32(acc, lo[u], dhi, s > 0);
        if constexpr (kBLo) wgmma_tf32(acc, hi[u], dlo, kALo || s > 0);
        wgmma_tf32(acc, hi[u], dhi, kALo || kBLo || s > 0);
      }
      wgmma_commit();
    }
  };
  // After the stage `cur`'s products landed: add them to the totals and,
  // at its tile's last stage, write the tile (d[4 j + i] at row r0 +
  // 8 (i / 2), column 8 j + 2t + i % 2) and start fresh totals.
  auto add = [&](const Cursor& cur) {
#pragma unroll
    for (int e = 0; e < 4 * NT; ++e) total[e] += acc[e];
    if (cur.chunk != nchunks - 1) return;
    // d[e], d[e + 1] (e even) are columns 2t, 2t + 1 of a row: where N is
    // even they go out as one 8-byte (4-byte in bf16) store, so each store
    // of a warp writes whole 32-byte sectors.
    const int col0 = cur.ct * 8 * NT;
#pragma unroll
    for (int e = 0; e < 4 * NT; e += 2) {
      const long long row = cur.row0 + r0 + 8 * ((e & 3) >> 1);
      const int col = col0 + 8 * (e >> 2) + 2 * t;
      const long long at = row * N + col;
      if (row < m && col < N) {
        if (c_bf16) {
          __nv_bfloat16* cb = static_cast<__nv_bfloat16*>(c);
          if (N % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(cb + at) =
                __floats2bfloat162_rn(total[e], total[e + 1]);
          } else {
            store_f32(cb + at, total[e]);
            if (col + 1 < N) store_f32(cb + at + 1, total[e + 1]);
          }
        } else {
          float* cf = static_cast<float*>(c);
          if (N % 2 == 0) {
            *reinterpret_cast<float2*>(cf + at) =
                make_float2(total[e], total[e + 1]);
          } else {
            cf[at] = total[e];
            if (col + 1 < N) cf[at + 1] = total[e + 1];
          }
        }
      }
      total[e] = total[e + 1] = 0.f;
    }
  };
  // Stage `buf` landed and, with its B split, is visible to the tensor
  // cores; every warpgroup's products of the last stage are done (their
  // buffer may be overwritten); the next stage goes into the buffer they
  // read: its copies, and its B split, loaded an iteration ago (the loads'
  // latency hidden behind a stage's products); then the B split of the
  // stage after it is loaded.
  Cursor in;
  in.start(blockIdx.x, ctiles);
  auto begin = [&](int buf) {
    cp_async_wait<S::kStages - 2>();
    fence_proxy_async();
    wgmma_wait<0>();
    __syncthreads();
    if (in.tile < tiles) {
      const int next = buf == 0 ? S::kStages - 1 : buf - 1;
      issue(in, next);
      store_b(next);
      in.advance(nchunks, ctiles);
      if (in.tile < tiles) load_b(in);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (in.tile < tiles) {
      load_b(in);
      store_b(s);
      issue(in, s);
      in.advance(nchunks, ctiles);
    }
    cp_async_commit();
  }
  if (in.tile < tiles) load_b(in);
  // The first stage is peeled off the loop, so that every path into it has
  // one stage's wgmmas in flight.
  Cursor cur;
  cur.start(blockIdx.x, ctiles);
  if (cur.tile >= tiles) return;
  begin(0);
  products(cur, 0);
  Cursor last = cur;
  cur.advance(nchunks, ctiles);
  for (int buf = 1 % S::kStages; cur.tile < tiles;
       buf = buf + 1 == S::kStages ? 0 : buf + 1) {
    begin(buf);
    add(last);
    products(cur, buf);
    last = cur;
    cur.advance(nchunks, ctiles);
  }
  wgmma_wait<0>();
  add(last);
  cp_async_wait<0>();   // no copy outlives the block (the last are empty)
}

template <typename TA, typename TB, int NT>
cudaError_t launch(const void* a, const void* b, void* c, int c_bf16,
                   long long m, int K, int N, int blocks, cudaStream_t s) {
  constexpr int smem = Staging<TA, NT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_tc<TA, TB, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int ctiles = (N + 8 * NT - 1) / (8 * NT);
  const int tiles = (int)((m + kTileM - 1) / kTileM * ctiles);
  const unsigned grid = (unsigned)(tiles < blocks ? tiles : blocks);
  gemm_tc<TA, TB, NT><<<grid, kThreads, smem, s>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), c, c_bf16, m, K,
      N, ctiles, tiles);
  return cudaGetLastError();
}

template <typename TA, typename TB>
cudaError_t launch_nt(const void* a, const void* b, void* c, int c_bf16,
                      long long m, int K, int N, int nt, int blocks,
                      cudaStream_t s) {
  switch (nt) {
    case 1: return launch<TA, TB, 1>(a, b, c, c_bf16, m, K, N, blocks, s);
    case 2: return launch<TA, TB, 2>(a, b, c, c_bf16, m, K, N, blocks, s);
    default: return launch<TA, TB, 4>(a, b, c, c_bf16, m, K, N, blocks, s);
  }
}

}  // namespace

// a (m, K) f32, bf16, e4m3 or e5m2, contiguous, any start; b (K, N) f32 or
// bf16, contiguous; c (m, N) in c_dtype (f32 or bf16: an fp8 C is cast by the
// wrapper, gemm.py); `nt` the n8 tiles of an output tile (1,
// 2 or 4; gemm.py:tile_width / 8 unless the autotuner chose another) and
// `blocks` the persistent grid's size (the card's SMs).
extern "C" int repro_gemm(int device, const void* a, int a_dtype,
                          const void* b, int b_dtype, void* c, int c_dtype,
                          long long m, int K, int N, int nt, int blocks,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || N <= 0 || K < 0 || blocks <= 0 ||
      (nt != 1 && nt != 2 && nt != 4) ||
      (m + kTileM - 1) / kTileM * ((N + 8 * nt - 1) / (8 * nt)) >= (1LL << 31) ||
      (a_dtype != DT_F32 && a_dtype != DT_BF16 && a_dtype != DT_F8 &&
       a_dtype != DT_F8E5) ||
      (b_dtype != DT_F32 && b_dtype != DT_BF16) ||
      (c_dtype != DT_F32 && c_dtype != DT_BF16))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c_bf16 = c_dtype == DT_BF16;
  if (a_dtype == DT_F8)
    return b_dtype == DT_BF16
               ? launch_nt<fp8, __nv_bfloat16>(a, b, c, c_bf16, m, K, N, nt,
                                               blocks, s)
               : launch_nt<fp8, float>(a, b, c, c_bf16, m, K, N, nt, blocks,
                                       s);
  if (a_dtype == DT_F8E5)
    return b_dtype == DT_BF16
               ? launch_nt<fp8e5, __nv_bfloat16>(a, b, c, c_bf16, m, K, N,
                                                 nt, blocks, s)
               : launch_nt<fp8e5, float>(a, b, c, c_bf16, m, K, N, nt,
                                         blocks, s);
  if (a_dtype == DT_BF16)
    return b_dtype == DT_BF16
               ? launch_nt<__nv_bfloat16, __nv_bfloat16>(a, b, c, c_bf16, m,
                                                         K, N, nt, blocks, s)
               : launch_nt<__nv_bfloat16, float>(a, b, c, c_bf16, m, K, N,
                                                 nt, blocks, s);
  return b_dtype == DT_BF16
             ? launch_nt<float, __nv_bfloat16>(a, b, c, c_bf16, m, K, N, nt,
                                               blocks, s)
             : launch_nt<float, float>(a, b, c, c_bf16, m, K, N, nt, blocks,
                                       s);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
