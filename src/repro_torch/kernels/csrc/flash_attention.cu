// Flash attention forward with native GQA: O = softmax(Q K^T * scale) V,
// causal or not, for q (B*Hq, Sq, D) and k, v (B*Hkv, Sk, D) in bf16 or f32.
// The causal mask is top-left, as the reference's tril((Sq, Sk)): query row
// i sees keys 0..i, so rows >= Sk see every key.  The KV row is bh / group
// (the q-head-major flattening of the reference's kv_map).  The ragged
// edges are masked inside the kernel (keys >= Sk do not count, rows >= Sq
// are not written), causal or not; a causal key tile is visited iff its
// first key is <= the query tile's last row and < Sk, and query tiles are
// launched last first, so the longest causal rows start first.  p is
// rounded to V's type before the PV product, as the reference rounds it
// (p.astype(v.dtype)); l sums the unrounded p.  No float atomics: the sums
// run in a fixed order, so two runs give the same bits.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel).  On the H100 it is bound by operations:
// 4*D flops per live (query, key) pair (S(S+1)/2 pairs a head when causal
// and Sq = Sk = S) against one read of q, k, v and one write of o.  The TPU
// kernel walks the key tiles on a sequential grid axis and keeps the
// running max m, sum l and the (bq x D) accumulator in VMEM scratch; here a
// block owns a (b*hq, query tile) and loops over the key tiles itself, with
// m, l and the accumulator in registers.
//
// bf16 (the LM prefill's type): the tensor cores.  Both products are
// wgmma.m64nNk16.f32.bf16.bf16 (bf16 at 989 TFLOP/s against 67 for f32 FMA).
// A block is two consumer warpgroups, each owning 64 query rows of a 128-row
// Q tile, and a producer warpgroup, one thread of which loads the Q tile
// once and then the K and V key tiles by TMA into two rings of two
// stages (3-D tensor maps over (D, S, B*H), so a tile past Sk or Sq arrives
// as zeros, never as the next head's rows).  Each stage is announced and
// released by mbarriers, K and V apart, so the next tiles land while the
// consumers work on these.  S = Q K^T reads both operands from shared
// memory, K-major (D is contiguous in q and k).  O += P V takes P from
// registers: the S accumulator, converted pairwise to bf16x2, is exactly the
// A fragment of the PV product (the rounding the reference asks for), and V,
// (keys x D) with D contiguous, is read MN-major with wgmma's transpose bit.
// A consumer starts S_j and then P_{j-1} V_{j-1}, and runs tile j's softmax
// while the PV product is in flight; O is rescaled and P_j packed once it
// has landed.  Tiles are 128 keys wide up to D = 128: the S accumulator is
// then 64 registers a thread (m64n128), the O accumulator 64 at D = 128 and
// P 32: more than the 168 a thread that 384 threads leave (ptxas then
// serializes the wgmmas), so the producer warpgroup drops to 40 registers a
// thread and the consumers rise to 232 (setmaxnreg).  The causal diagonal
// falls on one key tile per query tile (two at 64-key tiles); at D = 128
// the Q tile and two stages of K and V take 160 KB of shared memory.  At
// D = 192 (DeepSeek's MLA prefill: 128 + 64 rotary columns) a 128-key ring
// would take 240 KB, over the 227 KB a block may have, and O alone is 96
// registers a thread, so the key tile is 64 (a template parameter of this
// path): Q 48 KB plus two stages of K and V at 24 KB each, 145 KB; S is 32
// registers, P 16, O 96; QK^T is 12 k-steps of m64n64k16 and PV one
// m64n192k16 a 16-key step.  Rows of D * 2 bytes are cut into column blocks
// of 64 bf16 (128 bytes, the 128-byte swizzle) or, at D = 32, one of 32
// (the 64-byte swizzle); TMA writes each block in the swizzle that the
// wgmma descriptors name.  Each thread of the accumulator layout holds
// pieces of two rows; the row max reduces over the 4 lanes of a quad by
// shuffles, and the row sums stay per thread until the end.  The softmax
// runs in base 2 with scale * log2(e) folded into the scores, on the
// special-function unit's ex2.approx.ftz (about 2 ulp of f32, and weights
// below 2^-126 of the row's largest flush to 0), far inside the bf16 limit.
// Only the diagonal tile and a tile past Sk apply the mask.
//
// f32: the CUDA cores (the tensor cores have no f32 product at f32
// precision, and TF32 would miss the 1e-4 f32 limit).  One block of 256
// threads owns one (b*hq, 64-query tile) and loops over the 64-key tiles.
// Q (transposed) and each K (transposed) and V tile are staged in shared
// memory, so a thread reads a float4 of 4 query rows and a float4 of 4
// keys per d and does 16 FMAs with them.  Thread (ty, tx) owns query rows
// 4*ty..4*ty+3: their scores at keys 4*tx..4*tx+3 of the tile, their m and
// l (the same on the 16 lanes of a half-warp, reduced by shuffles) and
// their accumulator columns tx, tx + 16, ..., all in registers; p goes
// through shared memory to the PV product.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// -- bf16: the tensor cores --------------------------------------------

constexpr int kTcBQ = 128;                      // query rows a block
constexpr int kTcStages = 2;                    // K/V tiles in the ring
constexpr int kTcConsumers = 256;               // two warpgroups of 64 rows
constexpr int kTcThreads = kTcConsumers + 128;  // and the producer's
// Registers a thread: the producer's few against the consumers' S (64),
// O (up to 64) and P (32) accumulators at 128-key tiles, S 32, O 96 and P 16
// at D = 192; 128 * 40 + 256 * 232 <= 65536.
constexpr int kTcProducerRegs = 40;
constexpr int kTcConsumerRegs = 232;

// Keys a K or V tile at head dim D: 128, or 64 at D = 192, where two stages
// of 128-key K and V tiles do not fit beside Q.
template <int D>
constexpr int tc_keys() { return D > 128 ? 64 : 128; }

// A Rows-row tile of a (S, D) bf16 matrix in shared memory, as TMA writes
// it: column blocks of kCols, each Rows rows of kRowBytes, swizzled.
template <int D, int Rows>
struct TcTile {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kSwizzle = kRowBytes == 128 ? kSwizzle128 : kSwizzle64;
  static constexpr int kBlocks = D / kCols;
  static constexpr int kBlockBytes = Rows * kRowBytes;
  static constexpr int kBytes = kBlocks * kBlockBytes;
  static constexpr int kGroupBytes = 8 * kRowBytes;  // the swizzle period
};

// The block's shared memory at head dim D: the Q tile, then the K ring,
// then the V ring, then the barriers, and room to align the start.
template <int D>
struct TcSmem {
  static constexpr int kKeys = tc_keys<D>();
  using Q = TcTile<D, kTcBQ>;
  using KV = TcTile<D, kKeys>;
  __device__ static uint8_t* k_tile(uint8_t* qs, int s) {
    return qs + Q::kBytes + s * KV::kBytes;
  }
  __device__ static uint8_t* v_tile(uint8_t* qs, int s) {
    return qs + Q::kBytes + (kTcStages + s) * KV::kBytes;
  }
  static constexpr int kBarriers = Q::kBytes + 2 * kTcStages * KV::kBytes;
  static constexpr int kBytes = kBarriers + 8 * (4 * kTcStages + 1) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit; results below 2^-126 flush to 0 (a
// weight that small next to the row's largest, 1, does not count).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// O += P V_j (V_j has landed): 16 keys a step, V MN-major, started after a
// wgmma fence of its own with its registers pinned.
template <int D, int BK>
__device__ __forceinline__ void tc_start_pv(float (&acc)[D / 2],
                                            uint32_t (&pa)[BK / 16][4],
                                            uint8_t* qs, int j) {
  using L = typename TcSmem<D>::KV;
  const uint64_t vdesc =
      smem_desc(TcSmem<D>::v_tile(qs, j % kTcStages), L::kBlockBytes,
                L::kGroupBytes, L::kSwizzle);
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs_tb(acc, pa[kk], vdesc + ((kk * 16 * L::kRowBytes) >> 4));
  wgmma_commit();
}

// After wgmma_wait: PV_j has landed in acc, and this warp is done with V_j.
template <int D, int BK>
__device__ __forceinline__ void tc_pv_landed(float (&acc)[D / 2],
                                             uint32_t (&pa)[BK / 16][4],
                                             uint64_t* vempty, int j) {
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
  if (threadIdx.x % 32 == 0) mbar_arrive(&vempty[j % kTcStages]);
}

// The online softmax of one S tile in the accumulator layout, in base 2:
// scores scaled, keys past Sk or the causal diagonal masked (only on an
// edge tile), the running max m and sum l updated, corr the factor for O,
// and sc left holding p.
template <int BK>
__device__ __forceinline__ void tc_softmax(float (&sc)[BK / 2],
                                           float (&m)[2], float (&l)[2],
                                           float (&corr)[2], bool edge,
                                           int k0, int row0, int col0,
                                           int Sk, float scale_log2,
                                           int causal) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + col0 + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      if (key >= Sk || (causal && key > row)) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float mb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    mb[h] = mx[h] == -INFINITY ? 0.f : mx[h];  // no live key yet
    corr[h] = fast_exp2(m[h] - mb[h]);
    m[h] = mx[h];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float p = fast_exp2(sc[i] - mb[(i >> 1) & 1]);
    sc[i] = p;
    rs[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
}

// p rounded to bf16, pairwise along keys: the PV product's A fragment.
template <int BK>
__device__ __forceinline__ void tc_pack(const float (&sc)[BK / 2],
                                        uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// S = Q K^T for the K tile at `kt`: D / 16 steps along D, 32 bytes of a
// swizzled row each (Q's and K's column blocks apart by their own rows),
// after a wgmma fence of its own.
template <int D, int BK>
__device__ __forceinline__ void tc_start_s(float (&sc)[BK / 2],
                                           uint64_t qdesc, uint8_t* kt) {
  using Q = typename TcSmem<D>::Q;
  using K = typename TcSmem<D>::KV;
  const uint64_t kdesc = smem_desc(kt, 16, K::kGroupBytes, K::kSwizzle);
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int blk = kk / (Q::kCols / 16), col = (kk % (Q::kCols / 16)) * 32;
    wgmma_ss(sc, qdesc + ((blk * Q::kBlockBytes + col) >> 4),
             kdesc + ((blk * K::kBlockBytes + col) >> 4), kk > 0);
  }
  wgmma_commit();
}

// The consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 of the
// block's Q tile in `qs`; tile j of K and of V is in stage j % kTcStages of
// its ring, announced by kfull / vfull and released through kempty /
// vempty.  After tile 0, iteration j starts S_j = Q K_j^T and then
// O += P_{j-1} V_{j-1}, and runs tile j's softmax while the second
// product is in flight; O is rescaled and P_j packed once it has landed.
// Tile 0 runs before the loop, so no two paths with different products in
// flight meet inside it: where they do, ptxas serializes the wgmmas.
template <int D>
__device__ __forceinline__ void tc_consume(
    uint8_t* qs, uint64_t* kfull, uint64_t* vfull, uint64_t* kempty,
    uint64_t* vempty, uint64_t* qbar, __nv_bfloat16* __restrict__ o, int q0,
    int bh, int nk, int Sq, int Sk, float scale_log2, int causal) {
  using L = typename TcSmem<D>::Q;
  constexpr int BK = TcSmem<D>::kKeys;
  // This thread: rows row0 and row0 + 8, columns col0, col0 + 1 of each 8.
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int wg_row0 = q0 + 64 * wg;
  const int row0 = wg_row0 + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int col0 = 2 * (lane % 4);
  // Keys past Sk or the causal diagonal fall in the tile at k0.
  auto edge = [&](int k0) {
    return k0 + BK > Sk || (causal && k0 + BK - 1 > wg_row0);
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];  // P of the previous tile in bf16

  const uint64_t qdesc = smem_desc(qs + 64 * wg * L::kRowBytes, 16,
                                   L::kGroupBytes, L::kSwizzle);
  mbar_wait(qbar, 0);

  mbar_wait(&kfull[0], 0);
  tc_start_s<D, BK>(sc, qdesc, TcSmem<D>::k_tile(qs, 0));
  wgmma_wait<0>();
  fence_regs(sc);
  if (lane == 0) mbar_arrive(&kempty[0]);
  tc_softmax<BK>(sc, m, l, corr, edge(0), 0, row0, col0, Sk, scale_log2,
                 causal);
  tc_pack<BK>(sc, pa);

  for (int j = 1; j < nk; ++j) {
    const int s = j % kTcStages;
    mbar_wait(&kfull[s], (j / kTcStages) & 1);
    mbar_wait(&vfull[(j - 1) % kTcStages], ((j - 1) / kTcStages) & 1);
    tc_start_s<D, BK>(sc, qdesc, TcSmem<D>::k_tile(qs, s));
    tc_start_pv<D, BK>(acc, pa, qs, j - 1);
    wgmma_wait<1>();  // S_j has landed; PV_{j-1} may still run
    fence_regs(sc);
    if (lane == 0) mbar_arrive(&kempty[s]);  // this warp is done with K_j
    tc_softmax<BK>(sc, m, l, corr, edge(j * BK), j * BK, row0, col0, Sk,
                   scale_log2, causal);
    wgmma_wait<0>();
    tc_pv_landed<D, BK>(acc, pa, vempty, j - 1);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    tc_pack<BK>(sc, pa);
  }
  mbar_wait(&vfull[(nk - 1) % kTcStages], ((nk - 1) / kTcStages) & 1);
  tc_start_pv<D, BK>(acc, pa, qs, nk - 1);
  wgmma_wait<0>();
  tc_pv_landed<D, BK>(acc, pa, vempty, nk - 1);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* out = o + ((size_t)bh * Sq + row) * D + col0;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) = __floats2bfloat162_rn(
          acc[4 * c + 2 * h] / denom, acc[4 * c + 2 * h + 1] / denom);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             __nv_bfloat16* __restrict__ o, int Sq, int Sk, int group,
             float scale_log2, int causal) {
  using Q = typename TcSmem<D>::Q;
  using KV = typename TcSmem<D>::KV;
  constexpr int BK = TcSmem<D>::kKeys;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;  // then the K ring, then the V ring
  uint64_t* kfull =
      reinterpret_cast<uint64_t*>(base + TcSmem<D>::kBarriers);
  uint64_t* vfull = kfull + kTcStages;
  uint64_t* kempty = vfull + kTcStages;
  uint64_t* vempty = kempty + kTcStages;
  uint64_t* qbar = vempty + kTcStages;

  const int nq = (Sq + kTcBQ - 1) / kTcBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kTcBQ;
  const int bh = blockIdx.y;
  const int last_key = causal ? min(min(q0 + kTcBQ, Sq), Sk) - 1 : Sk - 1;
  const int nk = last_key / BK + 1;

  if (threadIdx.x == kTcConsumers) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], kTcConsumers / 32);  // one arrival a warp
      mbar_init(&vempty[s], kTcConsumers / 32);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {
    // The producer warpgroup gives up registers for the consumers; one
    // thread loads Q once, then K_j and V_j into stage j % kTcStages of
    // their rings as soon as every consumer warp is done with K, V of
    // tile j - kTcStages.
    setmaxnreg_dec<kTcProducerRegs>();
    if (threadIdx.x == kTcConsumers) {
      mbar_expect_tx(qbar, Q::kBytes);
      for (int b = 0; b < Q::kBlocks; ++b)
        tma_load_3d(qs + b * Q::kBlockBytes, &qmap, qbar, b * Q::kCols, q0,
                    bh);
      const int bkv = bh / group;
      for (int j = 0; j < nk; ++j) {
        const int s = j % kTcStages;
        const unsigned parity = (j / kTcStages - 1) & 1;
        uint8_t* kt = TcSmem<D>::k_tile(qs, s);
        uint8_t* vt = TcSmem<D>::v_tile(qs, s);
        if (j >= kTcStages) mbar_wait(&kempty[s], parity);
        mbar_expect_tx(&kfull[s], KV::kBytes);
        for (int b = 0; b < KV::kBlocks; ++b)
          tma_load_3d(kt + b * KV::kBlockBytes, &kmap, &kfull[s],
                      b * KV::kCols, j * BK, bkv);
        if (j >= kTcStages) mbar_wait(&vempty[s], parity);
        mbar_expect_tx(&vfull[s], KV::kBytes);
        for (int b = 0; b < KV::kBlocks; ++b)
          tma_load_3d(vt + b * KV::kBlockBytes, &vmap, &vfull[s],
                      b * KV::kCols, j * BK, bkv);
      }
    }
  } else {
    setmaxnreg_inc<kTcConsumerRegs>();
    tc_consume<D>(qs, kfull, vfull, kempty, vempty, qbar, o, q0, bh, nk, Sq,
                  Sk, scale_log2, causal);
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time through the
// runtime, so that the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a (bh, S, D) bf16 tensor, in boxes of (one column
// block, Rows rows, one head).
template <int D, int Rows>
cudaError_t tile_map(CUtensorMap* map, const void* p, int bh, int S) {
  using L = TcTile<D, Rows>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)L::kCols, (cuuint32_t)Rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::kSwizzle == kSwizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int bhq, int Sq, int Sk, int group, float scale,
                      int causal, cudaStream_t stream) {
  constexpr int BK = TcSmem<D>::kKeys;
  CUtensorMap qm, km, vm;
  cudaError_t err = tile_map<D, kTcBQ>(&qm, q, bhq, Sq);
  if (err == cudaSuccess) err = tile_map<D, BK>(&km, k, bhq / group, Sk);
  if (err == cudaSuccess) err = tile_map<D, BK>(&vm, v, bhq / group, Sk);
  if (err != cudaSuccess) return err;
  auto fn = flash_fwd_tc<D>;
  constexpr int bytes = TcSmem<D>::kBytes;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTcBQ - 1) / kTcBQ, bhq);
  const float scale_log2 = (float)(scale * 1.4426950408889634);  // log2(e)
  fn<<<grid, kTcThreads, bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), Sq, Sk, group, scale_log2,
      causal);
  return cudaGetLastError();
}

// -- f32: the CUDA cores -----------------------------------------------

constexpr int kBQ = 64;       // query rows a block
constexpr int kBK = 64;       // keys a tile
constexpr int kThreads = 256; // 16 x 16: 4 rows x 4 keys of the scores each
constexpr int kPStride = kBK + 4;  // padded row of p (16-byte aligned)
constexpr float kMask = -0.7f * 3.402823466e38f;  // the reference's MASK_VALUE

template <int D>
constexpr int smem_floats() {
  return D * kBQ + D * kBK + kBK * D + kBQ * kPStride;
}

// rows [r0, r0 + 64) of a (S, D) matrix into dst[d * 64 + r] (transposed),
// 16 bytes a load, lanes on consecutive rows; rows >= S read as 0.
template <int D>
__device__ __forceinline__ void stage_transposed(const float* __restrict__ src,
                                                 int r0, int S,
                                                 float* __restrict__ dst) {
  for (int e = threadIdx.x; e < 64 * (D / 4); e += kThreads) {
    const int r = e % 64, c = (e / 64) * 4;
    float vals[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) load_vec<float, 4>(src + (size_t)(r0 + r) * D + c, vals);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[(c + i) * 64 + r] = vals[i];
  }
}

// rows [r0, r0 + 64) of a (S, D) matrix into dst[r * D + d]; rows >= S as 0.
template <int D>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int r0, int S,
                                           float* __restrict__ dst) {
  for (int e = threadIdx.x; e < 64 * (D / 4); e += kThreads) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    float vals[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) load_vec<float, 4>(src + (size_t)(r0 + r) * D + c, vals);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[r * D + c + i] = vals[i];
  }
}

// Max and sum over the 16 lanes of a half-warp (the lanes sharing ty).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Sq,
              int Sk, int group, float scale, int causal) {
  constexpr int CPT = D / 16;  // accumulator columns a thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [D][kBQ]
  float* kt = qt + D * kBQ;      // [D][kBK]
  float* vs = kt + D * kBK;      // [kBK][D]
  float* ps = vs + kBK * D;      // [kBQ][kPStride]

  const int nq = (Sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)(bh / group) * Sk * D;
  const float* vb = v + (size_t)(bh / group) * Sk * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage_transposed<D>(qb, q0, Sq, qt);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  const int last_key = causal ? min(min(q0 + kBQ, Sq), Sk) - 1 : Sk - 1;
  const int nk = last_key / kBK + 1;
  for (int kti = 0; kti < nk; ++kti) {
    const int k0 = kti * kBK;
    __syncthreads();  // the previous tile's kt, vs and ps are read
    stage_transposed<D>(kb, k0, Sk, kt);
    stage_rows<D>(vb, k0, Sk, vs);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kBQ + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(kt + d * kBK + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        const bool live = key < Sk && !(causal && key > row);
        s[i][j] = live ? s[i][j] * scale : kMask;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float p[4], rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] - m_new);
        rowsum += p[j];
      }
      l[i] = l[i] * corr + half_warp_sum(rowsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kPStride + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kPStride + c);
        pr[i][0] = pv.x; pr[i][1] = pv.y; pr[i][2] = pv.z; pr[i][3] = pv.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) vv[j] = vs[(c + cc) * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[i][j] = fmaf(pr[i][cc], vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* out = o + ((size_t)bh * Sq + row) * D + tx;
#pragma unroll
    for (int j = 0; j < CPT; ++j) out[16 * j] = acc[i][j] / denom;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int bhq, int Sq, int Sk, int group, float scale,
                       int causal, cudaStream_t stream) {
  auto fn = flash_fwd_f32<D>;
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, bhq);
  fn<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, group,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, int bhq, int Sq, int Sk, int group, float scale,
                   int causal, cudaStream_t stream) {
  if (dtype == DT_BF16)
    return launch_tc<D>(q, k, v, o, bhq, Sq, Sk, group, scale, causal,
                        stream);
  if (dtype == DT_F32)
    return launch_f32<D>(q, k, v, o, bhq, Sq, Sk, group, scale, causal,
                         stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_flash_attention(int device, const void* q, const void* k,
                                     const void* v, void* o, int dtype,
                                     int bhq, int Sq, int Sk, int D,
                                     int group, float scale, int causal,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bhq == 0 || Sq == 0) return cudaSuccess;
  if (Sk == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(dtype, q, k, v, o, bhq, Sq, Sk, group, scale, causal, s);
    case 64: return launch<64>(dtype, q, k, v, o, bhq, Sq, Sk, group, scale, causal, s);
    case 128: return launch<128>(dtype, q, k, v, o, bhq, Sq, Sk, group, scale, causal, s);
    case 192: return launch<192>(dtype, q, k, v, o, bhq, Sq, Sk, group, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
