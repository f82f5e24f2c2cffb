// Y = A^T X for a block-ELL A (nbr block-rows of `ell` stored bs x bs
// blocks, block-column ids in cols[nbr][ell]) and a dense row-major f32 X
// (nbr*bs x nx): the adjoint of the unfused sparse solve, Lanczos' half of
// A^T A v (nx = 1), the int8 group pass (nx = slots) and the sparse Gram
// (one 512-column strip of A at a time).
//
// Replaces both forms of the TPU kernel src/repro/kernels/bsr.py:
// bsr_rmatmul: the fused scatter (_bsr_rmm_kernel), which adds each
// A_ij^T X_i into a VMEM-resident accumulator at block-row cols[i, s] and is
// race-free only because the TPU grid runs in order, and the partials +
// segment_sum form (_bsr_rmm_partials_kernel) of the wide regime.
//
// Bound on the H100.  Every stored block is read once per output tile,
// plus X and Y: at nx = 1 the bytes of the blocks bound it.  The products
// are 2 nx flops a stored element and pass the bytes from nx of a few tens
// on.  They run on the tensor cores: 3xTF32 for f32 blocks (three TF32
// products a product, as randsketch.cu), two products for bf16 and int8
// blocks, whose values are exact in TF32.  The gather reads X_i once a
// stored block (ell times in all), from L2 where blocks running together
// share it.
//
// Design.  Blocks of a GPU grid run in no order and float atomics would
// change the bits from run to run, so the scatter becomes a gather over a
// column-major index of the block pattern, built once by the wrapper
// (kernels/bsr.py:ColumnIndex): for block column j, the flat slots
// i*ell + s that hold it, in ascending i, cut into chunks of at most
// kMaxChunk slots.  A unit of work is one chunk and one tile of nt output
// columns, the chunks in the index's order and a chunk's tiles next to
// each other in the launch order, so they share its blocks' reads.  Pass 1:
// a persistent grid of 128-thread blocks (as many as the card holds at
// once) takes the units in turn, block b units b, b + G, .., and streams
// their slots through one ring of `stages` shared-memory stages, each a
// slot's stored block (rows padded so that a fragment's loads fall on
// distinct banks), the nt columns of its X_i slab and its int8 scale,
// filled by 16-byte (X: 16- or 4-byte) cp.async copies across the units'
// boundaries; the units' headers and index lists are loaded units ahead of
// their copies.  The products are mma.sync.m16n8k8 with the block
// transposed as A (M = in-block column c, K = in-block row r) and X_i's
// slab as B (N = output column j); warps load their fragments element by
// element from the stage and split them into TF32 parts there.  Tiles
// wider than 32 columns give each warp up to kTilesPerWarp 16 x 8 output
// tiles of each slot; narrower ones, which have fewer tiles than warps,
// give the warps several slots at once (see the narrow path below).  Pass
// 2 sums each column's chunk partials in a fixed order (bsr_rmm_reduce).
//
// Sums.  A slot's products start from zero in two sets of mma
// accumulators, the even and the odd k-steps, each k-step by k-step in
// order (f32: a_lo x_hi, a_hi x_lo, a_hi x_hi; bf16 and int8: a x_lo,
// a x_hi); the two are added and the result added to the chunk's running
// total in slot order on the CUDA cores (int8: times the block's scale,
// one fmaf).  mma computes an output element from its own B column only,
// so every output's arithmetic follows from A's pattern and values alone:
// the tile width, nx and X's other columns change which warp computes it,
// never how.  Padding slots (zero blocks at column 0) add exact zeros, as
// in the reference.  No float atomics; runs repeat bit for bit.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxStages = 8;
constexpr int kTilesPerWarp = 8;     // 16 x 8 output tiles a warp at most
constexpr int kMaxChunk = 32;        // slots a chunk at most (RMATMUL_CHUNK)
constexpr int kSmemMax = 232448;     // shared memory a block may use

// The staged row stride (bytes) of rows of `row_bytes` bytes whose elements
// are `elem` bytes: the row itself below 16 bytes (the block is then one
// run of 16-byte pieces), else the least whole number of 16-byte pieces,
// at least the row, at which the rows t = 0..3 and elements g = 0..7 that
// one fragment load reads fall on distinct shared-memory banks.
// bsr.py:rmatmul_row_stride mirrors it.
__host__ __device__ constexpr int row_stride(int row_bytes, int elem) {
  if (row_bytes < 16) return row_bytes;
  const int foot = 8 * elem;
  for (int s = row_bytes;; s += 16) {
    bool ok = true;
    for (int a = 0; a < 4; ++a)
      for (int b = a + 1; b < 4; ++b) {
        const int d = ((b - a) * s) % 128;
        if (d < foot || 128 - d < foot) ok = false;
      }
    if (ok) return s;
  }
}

template <typename T, int BS>
struct Layout {
  static constexpr int kRowBytes = BS * (int)sizeof(T);
  static constexpr int kRowStride = row_stride(kRowBytes, (int)sizeof(T));
  static constexpr int kBlockBytes = BS * kRowStride;
  static constexpr int kPieces = BS * kRowBytes / 16;  // of a stored block
  static constexpr int kMT = BS >= 16 ? BS / 16 : 1;   // m16 tiles
  static constexpr int kKS = BS / 8;                   // k8 steps
  // Widest output tile: kTilesPerWarp tiles a warp.
  static constexpr int kMaxTile = 8 * kWarps * (kTilesPerWarp / kMT);
};

__host__ __device__ inline int x_stride_floats(int nt) {
  return row_stride(4 * nt, 4) / 4;
}

// A stage: the stored block, nt columns of its X slab, and 16 bytes for
// its int8 scale.  bsr.py:rmatmul_plan mirrors it.
template <typename T, int BS>
__host__ __device__ inline int stage_bytes(int nt) {
  return Layout<T, BS>::kBlockBytes + BS * 4 * x_stride_floats(nt) + 16;
}

// B fragment (k8 x n8) of k-step ks and n-tile n8 from a staged X slab:
// b0 (row t, column g), b1 (row t + 4), split into TF32 parts.
__device__ __forceinline__ void load_b(const float* xs, int xstride, int ks,
                                       int n8, int g, int t,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* xb = xs + (8 * ks + t) * xstride + 8 * n8 + g;
  split_tf32(xb[0], hi[0], lo[0]);
  split_tf32(xb[4 * xstride], hi[1], lo[1]);
}

// A fragment (m16 x k8, m = in-block column c, k = in-block row r) of
// k-step ks and m-tile mt from a staged block: a0 (c = g, r = t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); columns past bs (at
// bs = 8) are zero.  f32 splits into TF32 parts; bf16 and int8 values are
// exact in TF32 (lo unused).
template <typename T, int BS>
__device__ __forceinline__ void load_a(const unsigned char* st, int ks,
                                       int mt, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  using L = Layout<T, BS>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 16 * mt + g + 8 * (i & 1);
    const int r = 8 * ks + t + 4 * (i >> 1);
    const float v = c < BS ? to_f32(*reinterpret_cast<const T*>(
                                 st + r * L::kRowStride + c * (int)sizeof(T)))
                           : 0.f;
    if constexpr (std::is_same<T, float>::value) {
      split_tf32(v, hi[i], lo[i]);
    } else {
      hi[i] = __float_as_uint(v);
      lo[i] = 0u;
    }
  }
}

// One k-step's products into d, in the fixed order: f32 a_lo x_hi,
// a_hi x_lo, a_hi x_hi; bf16 and int8 a x_lo, a x_hi.
template <typename T>
__device__ __forceinline__ void products(float (&d)[4], const uint32_t (&ahi)[4],
                                         const uint32_t (&alo)[4],
                                         const uint32_t (&bhi)[2],
                                         const uint32_t (&blo)[2]) {
  if constexpr (std::is_same<T, float>::value)
    mma_tf32(d, alo, bhi[0], bhi[1]);
  mma_tf32(d, ahi, blo[0], blo[1]);
  mma_tf32(d, ahi, bhi[0], bhi[1]);
}

// A slot's product (its even and odd k-step halves added) into a running
// total: int8 times the block's scale.
template <bool kScaled, int H, int MT, int QMAX>
__device__ __forceinline__ void add_product(float (&tot)[4],
                                            const float (&acc)[H][MT][QMAX][4],
                                            int p, int q, float sc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float prod = H == 2 ? acc[0][p][q][i] + acc[H - 1][p][q][i]
                              : acc[0][p][q][i];
    tot[i] = kScaled ? fmaf(sc, prod, tot[i]) : tot[i] + prod;
  }
}

// Pass 1.  A persistent grid: block b runs units u = b, b + G, b + 2G, ..
// (G = gridDim.x) of the launch order, unit u being tile u % ntiles (output
// columns j0 = (u % ntiles) nt ..) of chunk u / ntiles, and
// streams their slots through one ring, so a unit's first copies land under
// the last unit's products.  Warp w owns the m-tiles wm + wmc p (p = 0,
// 1, ..) and n-tiles wn + wnc q (q < nq) of the bs x nt tile, wnc =
// min(nt / 8, 4) warps across n and wmc = 4 / wnc down m; QMAX bounds nq
// (1 up to nt = 32, kTilesPerWarp / kMT past it).
template <typename T, int BS, int QMAX>
__global__ void __launch_bounds__(kThreads)
bsr_rmm_tc(const T* __restrict__ data, const float* __restrict__ scales,
           const int* __restrict__ order, const int* __restrict__ rows,
           const int* __restrict__ chunk_start,
           const int* __restrict__ chunk_len,
           const float* __restrict__ x, int nx, int xvec, int nt_log2,
           int ntiles, int units, int stages, float* __restrict__ part) {
  using L = Layout<T, BS>;
  constexpr int MT = L::kMT;
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = 1 << nt_log2;
  const int xstride = x_stride_floats(nt);
  const int x_off = L::kBlockBytes, sc_off = x_off + BS * 4 * xstride;
  const int sbytes = sc_off + 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntl = nt >> 3, ntl_log2 = nt_log2 - 3;
  const int wnc = ntl < kWarps ? ntl : kWarps;
  const int wmc = kWarps / wnc;
  const int wn = warp % wnc, wm = warp / wnc;
  const int nq = QMAX == 1 ? 1 : ntl / wnc;
  // A slot's product in two halves, the even and the odd k-steps (two
  // chains of mmas in flight), added at the end.
  constexpr int H = L::kKS > 1 ? 2 : 1;

  // Unit k of this block: its chunk, slots (start, len; len 0 past the
  // last unit) and first output column.
  struct Unit {
    int chunk, start, len, j0;
  };
  auto unit = [&](int k) {
    Unit h{0, 0, 0, 0};
    const unsigned u = blockIdx.x + (unsigned)k * gridDim.x;
    if (u < (unsigned)units) {
      const unsigned c = ntiles == 1 ? u : u / (unsigned)ntiles;
      h.chunk = (int)c;
      h.start = __ldg(chunk_start + c);
      h.len = __ldg(chunk_len + c);
      h.j0 = (int)(u - c * (unsigned)ntiles) * nt;
    }
    return h;
  };

  // The issue pointer: slot ie of unit ik (iu; the next three units'
  // headers in u1, u2, u3).  The flat slots and block-rows of a unit's
  // chunk are staged in shared memory (lists lq, lr, one of three buffers a
  // unit, lb the current unit's) before its slots are issued: thread t
  // loads entry t of unit ik + 2's lists into (pq, pr) when the pointer
  // enters unit ik and stores them when it enters unit ik + 1, so no copy
  // waits on a load of the index.
  __shared__ int lq[3][kMaxChunk], lr[3][kMaxChunk];
  int ik = 0, ie = 0, lb = 0;
  Unit iu = unit(0), u1 = unit(1), u2 = unit(2), u3 = unit(3);
  int pq = 0, pr = 0;
  if (tid < iu.len) {
    lq[0][tid] = __ldg(order + iu.start + tid);
    lr[0][tid] = __ldg(rows + iu.start + tid);
  }
  if (tid < u1.len) {
    lq[1][tid] = __ldg(order + u1.start + tid);
    lr[1][tid] = __ldg(rows + u1.start + tid);
  }
  if (tid < u2.len) {
    pq = __ldg(order + u2.start + tid);
    pr = __ldg(rows + u2.start + tid);
  }
  __syncthreads();
  // The next slot into stage `buf`: its stored block, row by row at the
  // padded stride, rows ir*BS .. ir*BS + BS - 1 of X at the unit's columns
  // below nx (the tile's columns past nx are never copied: they feed only
  // outputs that are never written), and its int8 scale.
  auto issue = [&](int buf) {
    if (iu.len == 0) return;
    const int iq = lq[lb][ie], ir = lr[lb][ie];
    unsigned char* st = smem + (size_t)buf * sbytes;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(data) +
                               (long long)iq * (BS * L::kRowBytes);
    // At most two pieces a thread (bf16 and f32 blocks up to 32 x 32):
    // straight-line copies; otherwise a loop.
    constexpr int kTrips = (L::kPieces + kThreads - 1) / kThreads;
    if constexpr (kTrips <= 2 && !kScaled) {
#pragma unroll
      for (int k = 0; k < kTrips; ++k) {
        const int p = tid + k * kThreads;
        if (L::kPieces % kThreads == 0 || p < L::kPieces) {
          const int off = 16 * p;
          cp_async16(st + (off / L::kRowBytes) * L::kRowStride +
                         off % L::kRowBytes,
                     src + off);
        }
      }
    } else {
      for (int p = tid; p < L::kPieces; p += kThreads) {
        const int off = 16 * p;
        cp_async16(st + (off / L::kRowBytes) * L::kRowStride +
                       off % L::kRowBytes,
                   src + off);
      }
    }
    float* xs = reinterpret_cast<float*>(st + x_off);
    // Offsets inside the slab fit an int: BS rows of nx floats.
    const float* xrow = x + (long long)ir * BS * nx + iu.j0;
    const int live_cols = min(nt, nx - iu.j0);
    if (xvec) {
      const int per_row_log2 = nt_log2 - 2;
      for (int p = tid; p < (BS << per_row_log2); p += kThreads) {
        const int r = p >> per_row_log2;
        const int jj = 4 * (p & ((1 << per_row_log2) - 1));
        if (jj < live_cols) cp_async16(xs + r * xstride + jj, xrow + r * nx + jj);
      }
    } else {
      for (int p = tid; p < (BS << nt_log2); p += kThreads) {
        const int r = p >> nt_log2, jj = p & (nt - 1);
        if (jj < live_cols) cp_async4(xs + r * xstride + jj, xrow + r * nx + jj);
      }
    }
    if constexpr (kScaled) {
      if (tid == 0)
        cp_async4(reinterpret_cast<float*>(st + sc_off), scales + iq);
    }
    if (++ie == iu.len) {   // uniform: every thread takes this branch
      ie = 0;
      ++ik;
      lb = lb == 2 ? 0 : lb + 1;
      iu = u1;
      u1 = u2;
      u2 = u3;
      u3 = unit(ik + 3);
      // Unit ik + 1's lists into their buffer (that of unit ik - 2, whose
      // slots are all issued), visible to every thread past the barrier;
      // then unit ik + 2's into registers.
      const int nb = lb == 2 ? 0 : lb + 1;
      if (tid < u1.len) {
        lq[nb][tid] = pq;
        lr[nb][tid] = pr;
      }
      __syncthreads();
      if (tid < u2.len) {
        pq = __ldg(order + u2.start + tid);
        pr = __ldg(rows + u2.start + tid);
      }
    }
  };

  // Tiles up to 32 columns (QMAX = 1): nts = MT * (nt / 8) output tiles a
  // slot.  Warp w owns tiles w, w + 4, .. (nts >= 4); with fewer tiles,
  // R = 4 / nts warps share one, tile w % nts, replica w / nts.  An iteration
  // takes P = J R slots (J a replica), at most half the ring: slot k's
  // products are computed by replica k % R, and the owner (replica 0) adds
  // them to its totals in slot order, taking the other replicas' through
  // shared memory; every output's sum is the same as with one slot an
  // iteration.  Wide tiles take one slot an iteration.
  constexpr int JMAX = MT >= 4 ? 1 : 2;
  const int nts = MT * ntl;
  const int R = QMAX == 1 && nts < 4 ? 4 / nts : 1;
  const int TW = nts < 4 ? 1 : nts / 4;            // tiles a warp
  const int r = nts < 4 ? warp / nts : 0;
  const int tau0 = nts < 4 ? warp % nts : warp;    // first tile; then + 4
  int J = (stages / 2) / R;
  J = QMAX > 1 ? 1 : (J < JMAX ? J : JMAX);
  const int P = J * R;
  // The ring holds the P slots being computed and stages - P more: the
  // issue pointer runs stages - P slots ahead.
  for (int s = 0; s < stages - P; ++s) {
    issue(s);
    cp_async_commit();
  }
  // The compute pointer: slot ce of unit ck (cu; the next header in cn).
  int ck = 0, ce = 0, buf = 0, ibuf = stages - P;
  Unit cu = unit(0), cn = unit(1);
  // After a unit's last slot: write the partial `tot` of output tile
  // (mt, n8) and zero it.  Accumulator (m16 x n8): i = 0, 1 at (c = g,
  // j = 2t + {0, 1}), i = 2, 3 at c = g + 8.
  auto write = [&](float (&tot)[4], int mt, int n8, bool mine) {
    float* out = part + (long long)cu.chunk * BS * nx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 16 * mt + g + 8 * (i >> 1);
      const int j = cu.j0 + 8 * n8 + 2 * t + (i & 1);
      if (mine && mt < MT && c < BS && j < nx)
        out[(long long)c * nx + j] = tot[i];
      tot[i] = 0.f;
    }
  };
  auto next_slot = [&]() { return ++ce == cu.len; };   // a unit ended?
  auto next_unit = [&]() {
    ce = 0;
    ++ck;
    cu = cn;
    cn = unit(ck + 1);
  };

  if constexpr (QMAX > 1) {
    // Wide tiles: one slot an iteration; warp w computes and sums its
    // m-tiles wm + wmc p and n-tiles wn + wnc q itself.
    float total[MT][QMAX][4];
#pragma unroll
    for (int p = 0; p < MT; ++p)
#pragma unroll
      for (int q = 0; q < QMAX; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) total[p][q][i] = 0.f;
    while (cu.len > 0) {
      cp_async_wait_n<kMaxStages - 2>(stages - 2);
      __syncthreads();   // this slot landed; every warp is done with the last
      issue(ibuf);
      cp_async_commit();
      if (++ibuf == stages) ibuf = 0;
      const unsigned char* st = smem + (size_t)buf * sbytes;
      if (++buf == stages) buf = 0;
      const float* xs = reinterpret_cast<const float*>(st + x_off);
      float acc[H][MT][QMAX][4];
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int p = 0; p < MT; ++p)
#pragma unroll
          for (int q = 0; q < QMAX; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[h][p][q][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < L::kKS; ++ks) {
        uint32_t bhi[QMAX][2], blo[QMAX][2];
#pragma unroll
        for (int q = 0; q < QMAX; ++q)
          if (q < nq)
            load_b(xs, xstride, ks, wn + wnc * q, g, t, bhi[q], blo[q]);
#pragma unroll
        for (int p = 0; p < MT; ++p) {
          const int mt = wm + wmc * p;
          if (mt < MT) {
            uint32_t ahi[4], alo[4];
            load_a<T, BS>(st, ks, mt, g, t, ahi, alo);
#pragma unroll
            for (int q = 0; q < QMAX; ++q)
              if (q < nq)
                products<T>(acc[ks % H][p][q], ahi, alo, bhi[q], blo[q]);
          }
        }
      }
      const float sc = kScaled ? *reinterpret_cast<const float*>(st + sc_off)
                               : 1.f;
#pragma unroll
      for (int p = 0; p < MT; ++p)
#pragma unroll
        for (int q = 0; q < QMAX; ++q)
          add_product<kScaled, H>(total[p][q], acc, p, q, sc);
      if (next_slot()) {
#pragma unroll
        for (int p = 0; p < MT; ++p)
#pragma unroll
          for (int q = 0; q < QMAX; ++q)
            write(total[p][q], wm + wmc * p, wn + wnc * q, q < nq);
        next_unit();
      }
    }
  } else {
    // The replicas' products, slot k's tile tau at k nts + tau (<= 8).
    __shared__ float4 prodbuf[JMAX * 4][32];
    float total[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) total[m][i] = 0.f;
    while (cu.len > 0) {
      cp_async_wait_n<kMaxStages - 2>(stages - 2 * P);
      __syncthreads();   // these P slots landed; the last P are done with
#pragma unroll 1
      for (int k = 0; k < P; ++k) {
        issue(ibuf);
        cp_async_commit();
        if (++ibuf == stages) ibuf = 0;
      }
      // This warp's products: slot r + R j, tiles tau0 + 4 m.
      float prod[JMAX][MT][4];
#pragma unroll
      for (int j = 0; j < JMAX; ++j) {
        int bj = buf + r + R * j;   // < 2 stages
        if (bj >= stages) bj -= stages;
        const unsigned char* st = smem + (size_t)bj * sbytes;
        const float* xs = reinterpret_cast<const float*>(st + x_off);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int tau = tau0 + 4 * m;
          if (j < J && m < TW) {
            float acc[H][4];
#pragma unroll
            for (int h = 0; h < H; ++h)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[h][i] = 0.f;
            const int mt = tau >> ntl_log2, n8 = tau & (ntl - 1);
#pragma unroll
            for (int ks = 0; ks < L::kKS; ++ks) {
              uint32_t bhi[2], blo[2], ahi[4], alo[4];
              load_b(xs, xstride, ks, n8, g, t, bhi, blo);
              load_a<T, BS>(st, ks, mt, g, t, ahi, alo);
              products<T>(acc[ks % H], ahi, alo, bhi, blo);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
              prod[j][m][i] = H == 2 ? acc[0][i] + acc[H - 1][i] : acc[0][i];
            if (r > 0)
              prodbuf[(r + R * j) * nts + tau][lane] =
                  make_float4(prod[j][m][0], prod[j][m][1], prod[j][m][2],
                              prod[j][m][3]);
          }
        }
      }
      if (R > 1) __syncthreads();   // the replicas' products are in place
      // Slot order: k = R j + rr; the owner adds, every warp walks.
#pragma unroll
      for (int j = 0; j < JMAX; ++j) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int k = R * j + rr;
          if (j < J && rr < R && cu.len > 0) {
            const int bk = buf + k < stages ? buf + k : buf + k - stages;
            const unsigned char* st = smem + (size_t)bk * sbytes;
            const float sc =
                kScaled ? *reinterpret_cast<const float*>(st + sc_off) : 1.f;
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              if (r == 0 && m < TW) {
                float pk[4];
                if (rr == 0) {
#pragma unroll
                  for (int i = 0; i < 4; ++i) pk[i] = prod[j][m][i];
                } else {
                  const float4 v = prodbuf[k * nts + tau0][lane];
                  pk[0] = v.x, pk[1] = v.y, pk[2] = v.z, pk[3] = v.w;
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  total[m][i] = kScaled ? fmaf(sc, pk[i], total[m][i])
                                        : total[m][i] + pk[i];
              }
            }
            if (next_slot()) {
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                const int tau = tau0 + 4 * m;
                write(total[m], tau >> ntl_log2, tau & (ntl - 1),
                      r == 0 && m < TW);
              }
              next_unit();
            }
          }
        }
      }
      buf += P;
      if (buf >= stages) buf -= stages;
    }
  }
  cp_async_wait<0>();
}

// Pass 2: Y[jb*bs + c, j] = sum of block column jb's chunk partials
// (chunks col_chunks[jb] .. col_chunks[jb+1]-1; none: 0).  A block sums
// kReduceOuts consecutive outputs of one block column (blockIdx.y) with
// kReduceLanes lanes each: lane w adds chunks w, w + kReduceLanes, .. in
// order, then lane 0 adds the lanes' sums in lane order.  The order follows
// from the column's chunk count alone, and a hot column's long list is
// read kReduceLanes chunks at a time.  Block b takes column b / tiles and
// its outputs (b % tiles) kReduceOuts ...
constexpr int kReduceOuts = 32;
constexpr int kReduceLanes = 8;

__global__ void __launch_bounds__(kReduceOuts * kReduceLanes)
bsr_rmm_reduce(const float* __restrict__ part,
               const int* __restrict__ col_chunks, int bs, int nx, int tiles,
               float* __restrict__ y) {
  __shared__ float sums[kReduceLanes][kReduceOuts];
  const int o = threadIdx.x % kReduceOuts, w = threadIdx.x / kReduceOuts;
  const long long jb = blockIdx.x / tiles;
  const long long per_col = (long long)bs * nx;
  const long long e = (long long)(blockIdx.x % tiles) * kReduceOuts + o;
  const int c0 = __ldg(col_chunks + jb), c1 = __ldg(col_chunks + jb + 1);
  float s = 0.f;
  if (e < per_col) {
    int ch = c0 + w;
    for (; ch + 3 * kReduceLanes < c1; ch += 4 * kReduceLanes) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = __ldg(part + (long long)(ch + k * kReduceLanes) * per_col + e);
#pragma unroll
      for (int k = 0; k < 4; ++k) s += v[k];
    }
    for (; ch < c1; ch += kReduceLanes)
      s += __ldg(part + (long long)ch * per_col + e);
  }
  sums[w][o] = s;
  __syncthreads();
  if (w == 0 && e < per_col) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kReduceLanes; ++k) t += sums[k][o];
    y[jb * per_col + e] = t;
  }
}

struct Args {
  const void *data, *scales, *order, *rows, *chunk_start, *chunk_len;
  int nchunks;
  const void* x;
  int nx, xvec, nt, stages, smem;
  void* part;
};

template <typename T, int BS, int QMAX>
cudaError_t launch_q(const Args& a, cudaStream_t s) {
  const void* fn = (const void*)&bsr_rmm_tc<T, BS, QMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  int nt_log2 = 0;
  while ((1 << nt_log2) < a.nt) ++nt_log2;
  const int ntiles = (a.nx + a.nt - 1) / a.nt;
  const long long units = (long long)a.nchunks * ntiles;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  // As many blocks as the card holds at once, never more than the units.
  int per_sm = 0, sms = 0, dev = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      a.smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  bsr_rmm_tc<T, BS, QMAX>
      <<<(unsigned)(grid < units ? grid : units), kThreads, a.smem, s>>>(
          static_cast<const T*>(a.data), static_cast<const float*>(a.scales),
          static_cast<const int*>(a.order), static_cast<const int*>(a.rows),
          static_cast<const int*>(a.chunk_start),
          static_cast<const int*>(a.chunk_len), static_cast<const float*>(a.x),
          a.nx, a.xvec, nt_log2, ntiles, (int)units, a.stages,
          static_cast<float*>(a.part));
  return cudaGetLastError();
}

template <typename T, int BS>
cudaError_t launch(const Args& a, cudaStream_t s) {
  using L = Layout<T, BS>;
  if (a.nt < 8 || a.nt > L::kMaxTile || (a.nt & (a.nt - 1)) ||
      a.stages < 2 || a.stages > kMaxStages ||
      a.smem != a.stages * stage_bytes<T, BS>(a.nt) || a.smem > kSmemMax ||
      (a.xvec && (a.nx % 4 || reinterpret_cast<uintptr_t>(a.x) % 16)))
    return cudaErrorInvalidValue;
  // Tiles up to 32 columns give a warp one n-tile (and take P slots an
  // iteration, at most half the ring); wider ones up to kTilesPerWarp /
  // kMT.
  const int tiles = L::kMT * (a.nt / 8);
  if (a.nt <= 8 * kWarps && tiles < 4 && a.stages < 2 * (4 / tiles))
    return cudaErrorInvalidValue;
  if constexpr (L::kMaxTile > 8 * kWarps) {
    if (a.nt > 8 * kWarps)
      return launch_q<T, BS, kTilesPerWarp / L::kMT>(a, s);
  }
  return launch_q<T, BS, 1>(a, s);
}

template <typename T>
cudaError_t launch_bs(int bs, const Args& a, cudaStream_t s) {
  switch (bs) {
    case 8: return launch<T, 8>(a, s);
    case 16: return launch<T, 16>(a, s);
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 128: return launch<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// data (nbr, ell, bs, bs) in `dtype` on a 16-byte boundary, scales
// (nbr, ell) f32 for int8 data (else null); the column index
// (bsr.py:ColumnIndex): order (nbr*ell) int32 flat slots sorted by column
// and rows their block-rows, chunk_start and chunk_len (nchunks) int32 the
// chunks, each at most kMaxChunk slots, in launch order; col_chunks (nbc + 1)
// int32, the chunks of each block column; x (nbr*bs, nx) f32 row-major
// (xvec: nx a multiple of 4 and x on a 16-byte boundary, copied in 16-byte
// pieces; else element by element); the plan (bsr.py:rmatmul_plan): tile width
// nt, stages and shared-memory bytes; part (nchunks, bs, nx) f32 scratch
// -> y (nbc*bs, nx) f32.
extern "C" int repro_bsr_rmatmul(int device, const void* data, int dtype,
                                 const void* scales, const void* order,
                                 const void* rows, const void* chunk_start,
                                 const void* chunk_len, const void* col_chunks,
                                 int nchunks,
                                 int bs, int nbc, const void* x, int nx,
                                 int xvec, int nt, int stages, int smem,
                                 void* part, void* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nx < 1 || nx > (1 << 24) || nbc < 1 || nchunks < 0 ||
      reinterpret_cast<uintptr_t>(data) % 16)
    return cudaErrorInvalidValue;
  if ((dtype == DT_I8) != (scales != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{data, scales, order, rows, chunk_start, chunk_len, nchunks,
               x, nx, xvec, nt, stages, smem, part};
  if (nchunks > 0) {
    switch (dtype) {
      case DT_F32: err = launch_bs<float>(bs, a, s); break;
      case DT_BF16: err = launch_bs<__nv_bfloat16>(bs, a, s); break;
      case DT_I8: err = launch_bs<int8_t>(bs, a, s); break;
      default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  const long long per_col = (long long)bs * nx;
  const long long tiles = (per_col + kReduceOuts - 1) / kReduceOuts;
  if (tiles * nbc > 0x7fffffffLL) return cudaErrorInvalidValue;
  bsr_rmm_reduce<<<(unsigned)(tiles * nbc), kReduceOuts * kReduceLanes, 0,
                   s>>>(static_cast<const float*>(part),
                        static_cast<const int*>(col_chunks), bs, nx,
                        (int)tiles, static_cast<float*>(y));
  return cudaGetLastError();
}
