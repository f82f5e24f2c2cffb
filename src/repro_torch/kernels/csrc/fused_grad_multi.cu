// Fused composite gradient for k right-hand sides (slots) sharing one
// design matrix: one read of A gives
//   f_s = sum_i W_si l((A X_s)_i, T_si),  G_s = A^T (W_s o l'(A X_s, T_s)),
//   Z_s = A X_s                                       for every slot s < k,
// for any k >= 1 in one launch.
//
// Replaces both TPU kernels of src/repro/kernels/fusedgrad.py: fused_grad
// (_fused_grad_kernel) is the case k = 1, fused_grad_multi
// (_fused_grad_multi_kernel) the request-batched form.  Bandwidth-bound on
// the H100 for small k: 4mnk f32 FMA flops against m*n*sizeof(storage)
// bytes of A plus 12mk bytes of T, W and Z.  At n = 1024, 67 TFLOP/s and
// 3.35 TB/s the operations pass the bytes near k = 21.2 in f32 storage and,
// counting the f32 FMAs the kernel does, k = 10.6 in bf16 storage and 5.3
// in fp8 storage.  bf16 and fp8 (e4m3 or e5m2) storage is upcast to f32
// before both products (fp8 two values a cvt, common.cuh: load_vec); sums
// and the residual are f32 (no tensor cores, no TF32).
//
// Design.  The TPU kernels walk row blocks on a sequential grid and carry
// G and f in VMEM scratch.  Here a persistent grid walks row tiles with a
// block stride, and every tile leaves HBM once, whatever k is.  The slots
// go through the tile in chunks of KC = 8 (a constant), so a block's
// registers hold one chunk's G while A stays in shared memory.
//
// Staged path (n <= 1024, the main path): one block an SM keeps a ring of
// row tiles of 16 rows in shared memory (64 KB in f32 at n = 1024, 32 KB in
// bf16, 16 KB in fp8; 3, 5 and 6 stages, as many as fit up to 6), filled
// by 16-byte cp.async pieces
// from every thread, so the next tiles land while this one is computed.
// (One thread's bulk copy of a whole tile moved only about 16 GB/s an SM
// on the H100, 2.1 TB/s in all: too slow.)  A stage also holds its rows'
// targets and weights when k <= KC, loaded with the tile, since a load
// issued a tile ahead still waits on a saturated memory.  The chunk's X
// (KC x n f32) sits beside the ring, loaded once when k <= KC, else
// reloaded for every chunk through registers while the previous chunk's
// sweep 2 runs.  Per chunk:
//   sweep 1: Z = A_tile X_c^T, register-tiled: a thread owns 4 rows x 4
//            slots over every 32nd group of 4 columns, so each A and X
//            value read from shared memory serves 4 FMAs; the 32 lanes of
//            a warp sum their parts by reduce_scatter (common.cuh), which
//            leaves each output with one lane, and that lane forms the
//            residual and loss (row_loss.cuh);
//   sweep 2: G_c += R_c^T A_tile: thread c owns columns 4c..4c+3 for the
//            chunk's slots (32 f32 registers) and adds the tile row by row.
// Sums stay short, so accuracy does not fall with the rows a block walks
// (about 16K at 2^21 rows on 132 SMs): sweep 2 adds into a group partial
// of G over kGroupTiles tiles (512 rows), which is then added to the
// block's running G; a slot's losses are summed a tile at a time and the
// tile sums added with compensation (row_loss.cuh); the second kernel sums
// the blocks' partials with compensation too.  When k <= KC, the group
// partial stays in registers; otherwise each chunk's goes through the
// block's slice of g_part between tiles.  The running G always lives
// there (the slice is 2 x k x n f32: 43 MB at k = 40, n = 1024).
// Unstaged path (wide n): 32-row blocks, six an SM in the grid, read from
// global memory by both sweeps (the second finds the rows in L2 when it
// can), four columns a load: sweep 1 is one warp a row, each lane summing
// its groups of 4 columns (lane-strided) a slot, then the butterfly; sweep
// 2 one thread a group of 4 columns, G in the block's slice of g_part.
// Each chunk reads the row block again.  Its kernel is compiled once for
// each chunk width (1, 2, 4 or 8 slots) and runs every chunk of a launch
// at that width, masking the dead slots: a slot's sums are the same chains
// at any width, and one width a kernel keeps its registers few.
// Slot independence: the paths, the tile height, the column split of
// sweep 1, the grid and the chunk width follow from (m, n, dtype) and the
// card alone, never from k.  Each slot's z is a chain of FMAs over its
// lane's columns, then the same pairing tree over the lanes; its G entry
// and its f the sums above, in tile order; the chunk's live width only
// decides which slots are computed, never how.  So a slot's bits
// depend neither on the other slots' values nor on how many slots there
// are: a request gets the same bits alone (fused_grad) or in a group of
// any size.  Per-block partials of G and f are summed in block order by a
// second kernel (multi_reduce, row_loss.cuh; no float atomics), so
// repeated runs agree bit for bit.
// Ragged m, n and k are masked, not padded.
#include "common.cuh"
#include "row_loss.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBm = 16;                     // rows a staged tile
constexpr int kRows = 4;                    // sweep 1: rows a thread
constexpr int kLanes = 32;                  // sweep 1: lanes a (rows, slots) tile
constexpr int kMaxStages = 6;
constexpr size_t kSmemMax = 232448;         // a block's shared memory
constexpr int kStagedMaxN = 4 * kThreads;   // sweep 2: 4 columns a thread
constexpr int kUnstagedRows = 32;
constexpr int kUnstagedBlocksPerSM = 6;
constexpr int kUnstagedMinBlocks = 3;
constexpr int kGroupTiles = 32;             // tiles a group partial of G
static_assert(kBm / kRows * 2 * kLanes == kThreads, "sweep 1's thread map");

__host__ __device__ inline int round_up(int v, int q) {
  return (v + q - 1) / q * q;
}

// -- staged path -----------------------------------------------------------

// A stage of the ring: the tile's kBm rows (T, row stride ldt), then the
// chunk's targets as ts[KC][kBm] and weights as ws[kBm][KC] (f32).  Sweep 1
// overwrites each target with its loss and each weight with its residual,
// the same lane the same entry, so ts becomes the losses (slot-major, for
// the loss sums) and ws the residuals (row-major, for sweep 2).
struct StageLayout {
  int ldt;              // elements of a staged row
  size_t tile_bytes;    // kBm * ldt * sizeof(T)
  size_t bytes;         // the whole stage
  __host__ __device__ StageLayout(int n, int tsize) {
    ldt = round_up(n, 16 / tsize);
    tile_bytes = (size_t)kBm * ldt * tsize;
    bytes = tile_bytes + 2 * (size_t)KC * kBm * sizeof(float);
  }
};

// Stages of the ring, as many as fit beside X's chunk (KC x n f32): the
// loads in flight hide the latency of a saturated memory (3 at n = 1024
// in f32, 5 in bf16, 6 in fp8).  They follow from (n, dtype) alone.
int stages_for(int n, int tsize) {
  const StageLayout sl(n, tsize);
  const size_t xs = (size_t)KC * round_up(n, 4) * sizeof(float);
  int s = (int)((kSmemMax - xs) / sl.bytes);
  return s > kMaxStages ? kMaxStages : s;
}

size_t staged_smem(int n, int tsize, int stages) {
  return stages * StageLayout(n, tsize).bytes +
         (size_t)KC * round_up(n, 4) * sizeof(float);
}

// Sweep 1's thread map: thread (rg, sg, jg) owns rows 4rg..4rg+3 and slot
// group sg (slots 4sg.. of the chunk, fewer when the chunk is narrow) over
// the column groups of 4 with index = jg mod 32; the 32 lanes of a warp
// share a (rows, slots) tile and sum it by reduce_scatter.
struct Sweep1Map {
  int jg, sg, rg;
  __device__ __forceinline__ Sweep1Map() {
    jg = threadIdx.x % kLanes;
    const int ti = threadIdx.x / kLanes;
    sg = ti & 1;
    rg = ti >> 1;
  }
};

// The (row, slot position) of the output lane jg forms the residual of, in
// a chunk of width class W (ST = min(W, 4) slots a thread), or false.
template <int W>
__device__ __forceinline__ bool lane_output(const Sweep1Map& mp, int* i,
                                            int* p) {
  constexpr int ST = W < 4 ? W : 4, SG = W / ST;
  const ScatterOut<kLanes, kRows * ST> out(mp.jg);
  *i = mp.rg * kRows + out.first / ST;
  *p = mp.sg * ST + out.first % ST;
  return mp.sg < SG && out.writer;
}

__device__ __forceinline__ bool lane_output(int wc, const Sweep1Map& mp,
                                            int* i, int* p) {
  switch (wc) {
    case 1: return lane_output<1>(mp, i, p);
    case 2: return lane_output<2>(mp, i, p);
    case 4: return lane_output<4>(mp, i, p);
    default: return lane_output<8>(mp, i, p);
  }
}

// The target and weight this lane's residual will read in the chunk of
// width class `wc` at rows r0.. and slots c0.. (multi-chunk launches: one
// chunk ahead, so the latency hides behind the chunk before).
__device__ __forceinline__ void prefetch_tw(float (&tw)[2], int wc,
                                            int rows, long long r0,
                                            long long m, int c0, int live,
                                            const float* __restrict__ t,
                                            const float* __restrict__ w) {
  const Sweep1Map mp;
  int i, p;
  if (lane_output(wc, mp, &i, &p) && i < rows && p < live) {
    const long long idx = (long long)(c0 + p) * m + r0 + i;
    tw[0] = __ldg(t + idx);
    tw[1] = __ldg(w + idx);
  }
}

// One chunk of W (1, 2, 4 or 8) slot positions, `live` of them real, over
// the staged tile `at`: sweep 1 and the residuals.  The target and weight
// come from the stage (`staged`) or from prefetch_tw; z, the losses (ts)
// and the residuals (ws) go out.
template <typename T, int W>
__device__ __forceinline__ void staged_sweep1(
    const T* __restrict__ at, int ldt, const float* __restrict__ xs,
    int ldx, int n, int rows, long long r0, long long m, int c0, int live,
    bool staged, const float (&tw)[2], int loss, float param,
    float* __restrict__ z, float* __restrict__ ts, float* __restrict__ ws) {
  constexpr int ST = W < 4 ? W : 4;   // slots a thread
  constexpr int SG = W / ST;          // slot groups: 2 when W = 8
  const Sweep1Map mp;
  // Whole warps of a second slot group idle when W < 8.
  if (mp.sg >= SG) return;
  float acc[kRows * ST];
#pragma unroll
  for (int o = 0; o < kRows * ST; ++o) acc[o] = 0.f;
  const T* arow = at + (size_t)mp.rg * kRows * ldt;
  const float* xrow = xs + (size_t)mp.sg * ST * ldx;
#pragma unroll 2
  for (int j = mp.jg * 4; j < n; j += kLanes * 4) {
    float av[kRows][4], xv[ST][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) load_vec<T, 4>(arow + r * ldt + j, av[r]);
#pragma unroll
    for (int s = 0; s < ST; ++s) load_vec<float, 4>(xrow + s * ldx + j, xv[s]);
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int s = 0; s < ST; ++s)
          acc[r * ST + s] = fmaf(av[r][v], xv[s][v], acc[r * ST + s]);
  }
  reduce_scatter<kLanes, kRows * ST>(acc, mp.jg);
  int i, p;
  if (lane_output<W>(mp, &i, &p) && i < rows && p < live) {
    const long long idx = (long long)(c0 + p) * m + r0 + i;
    float* tl = ts + p * kBm + i;
    float* wl = ws + i * KC + p;
    float le, rr;
    row_loss(loss, param, acc[0], staged ? *tl : tw[0], staged ? *wl : tw[1],
             &le, &rr);
    z[idx] = acc[0];
    *wl = rr;
    *tl = le;
  }
}

// Sweep 2 for one chunk: g[s][v] += sum over the tile's rows of
// R[i][s] A[i][4c + v], row by row, for this thread's four columns.
template <typename T, int W, int WMAX>
__device__ __forceinline__ void staged_sweep2(const T* __restrict__ at,
                                              int ldt, int n, int rows,
                                              const float* __restrict__ rs,
                                              float (&g)[WMAX][4]) {
  const int j = threadIdx.x * 4;
  if (j >= n) return;
#pragma unroll 4
  for (int i = 0; i < rows; ++i) {
    float av[4], rv[W];
    load_vec<T, 4>(at + (size_t)i * ldt + j, av);
    if constexpr (W >= 4) {
#pragma unroll
      for (int q = 0; q < W; q += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rs + i * KC + q);
        rv[q] = r4.x;
        rv[q + 1] = r4.y;
        rv[q + 2] = r4.z;
        rv[q + 3] = r4.w;
      }
    } else {
#pragma unroll
      for (int s = 0; s < W; ++s) rv[s] = rs[i * KC + s];
    }
#pragma unroll
    for (int s = 0; s < W; ++s)
#pragma unroll
      for (int v = 0; v < 4; ++v) g[s][v] = fmaf(rv[s], av[v], g[s][v]);
  }
}

// This thread's four columns of the chunk's G (slots c0..c0+live-1) to
// (store) or from (load; zeros when `zero`) the block's slice of g_part.
template <int WMAX>
__device__ __forceinline__ void spill_g(float (&g)[WMAX][4],
                                        float* __restrict__ g_blk, int n,
                                        int c0, int live, bool zero,
                                        bool store) {
  const int j = threadIdx.x * 4;
  if (j >= n) return;
  const bool vec = (n & 3) == 0;
#pragma unroll
  for (int s = 0; s < WMAX; ++s) {
    if (s >= live) continue;
    float* p = g_blk + (size_t)(c0 + s) * n + j;
    if (store) {
      if (vec) {
        *reinterpret_cast<float4*>(p) =
            make_float4(g[s][0], g[s][1], g[s][2], g[s][3]);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (j + v < n) p[v] = g[s][v];
      }
    } else if (zero) {
#pragma unroll
      for (int v = 0; v < 4; ++v) g[s][v] = 0.f;
    } else if (vec) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      g[s][0] = q.x;
      g[s][1] = q.y;
      g[s][2] = q.z;
      g[s][3] = q.w;
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v) g[s][v] = j + v < n ? p[v] : 0.f;
    }
  }
}

// The end of a group: add this thread's four columns of the chunk's group
// partial to the running G in the block's slice (which starts at zero in
// the first group) and zero the partial.
template <int WMAX>
__device__ __forceinline__ void flush_g(float (&g)[WMAX][4],
                                        float* __restrict__ g_blk, int n,
                                        int c0, int live, bool first) {
  float run[WMAX][4] = {};
  spill_g<WMAX>(run, g_blk, n, c0, live, first, false);
#pragma unroll
  for (int s = 0; s < WMAX; ++s)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      run[s][v] += g[s][v];
      g[s][v] = 0.f;
    }
  spill_g<WMAX>(run, g_blk, n, c0, live, false, true);
}

// Copy `rows` rows of n elements (global stride n) into shared rows of
// stride ld, zero-filling columns n..ld-1; every thread of the block.
template <typename T>
__device__ __forceinline__ void copy_rows(T* __restrict__ dst, int ld,
                                          const T* __restrict__ src,
                                          int rows, int n) {
  for (int e = threadIdx.x; e < rows * ld; e += kThreads) {
    const int r = e / ld, c = e - r * ld;
    dst[e] = c < n ? src[(size_t)r * n + c] : static_cast<T>(0.f);
  }
}

// X rows c0..c0+live-1 (a chunk) as float4 pieces: thread tid's pieces
// tid, tid + kThreads, ... of the chunk's live * n / 4, held in registers
// from their load to their store into xs, so sweep 2 runs in between.
constexpr int kXVec = KC * kStagedMaxN / 4 / kThreads;

__device__ __forceinline__ void load_x(float4 (&xr)[kXVec],
                                       const float* __restrict__ x, int n,
                                       int c0, int live) {
  const int pieces = live * (n / 4);
#pragma unroll
  for (int q = 0; q < kXVec; ++q) {
    const int e = threadIdx.x + q * kThreads;
    if (e < pieces)
      xr[q] = __ldg(reinterpret_cast<const float4*>(x + (size_t)c0 * n) + e);
  }
}
__device__ __forceinline__ void store_x(const float4 (&xr)[kXVec],
                                        float* __restrict__ xs, int n,
                                        int live) {
  const int pieces = live * (n / 4);
#pragma unroll
  for (int q = 0; q < kXVec; ++q) {
    const int e = threadIdx.x + q * kThreads;
    if (e < pieces) reinterpret_cast<float4*>(xs)[e] = xr[q];
  }
}

// WMAX, the widest chunk class of this launch (width_class(min(k, KC))),
// only sizes the registers: every chunk runs the same code for its width.
// vec: A's and X's rows are 16-byte aligned (n * sizeof(T) and n * 4 are
// multiples of 16: n % 16 == 0 in fp8), so tiles stream in by cp.async
// and X by float4 loads; otherwise both are copied element by element, one
// tile at a time.
template <typename T, int WMAX>
__global__ void __launch_bounds__(kThreads, 1)
fgm_staged(const T* __restrict__ a, const float* __restrict__ x,
           const float* __restrict__ t, const float* __restrict__ w,
           long long m, int n, int k, int stages, int vec, int loss,
           float param, float* __restrict__ z, float* __restrict__ g_part,
           float* __restrict__ f_part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const StageLayout sl(n, (int)sizeof(T));
  const int ldt = sl.ldt, ldx = round_up(n, 4);
  float* xs = reinterpret_cast<float*>(smem + stages * sl.bytes);
  const int tid = threadIdx.x;
  const long long tiles = (m + kBm - 1) / kBm;
  const int nchunks = (k + KC - 1) / KC;
  const bool resident = nchunks == 1;
  // The block's running G, then (multi-chunk launches) its group partial.
  float* g_blk = g_part + (size_t)blockIdx.x * 2 * k * n;
  float* g_grp = g_blk + (size_t)k * n;
  float* f_blk = f_part + (size_t)blockIdx.x * 2 * k;
  auto tile_of = [&](int buf) {
    return reinterpret_cast<T*>(smem + buf * sl.bytes);
  };
  auto ts_of = [&](int buf) {
    return reinterpret_cast<float*>(smem + buf * sl.bytes + sl.tile_bytes);
  };

  // Tile `tile` into stage `buf`, 16-byte pieces from every thread, and
  // (resident launches) its rows' targets and weights; one group.
  auto issue_tile = [&](long long tile, int buf) {
    if (tile < tiles) {
      const long long r0 = tile * kBm;
      const int rows = (int)min((long long)kBm, m - r0);
      const int pieces = rows * n * (int)sizeof(T) / 16;
      const char* src = reinterpret_cast<const char*>(a + r0 * n);
      char* dst = reinterpret_cast<char*>(tile_of(buf));
      for (int e = tid; e < pieces; e += kThreads)
        cp_async16(dst + 16 * e, src + 16 * e);
      if (resident) {
        float* ts = ts_of(buf);
        float* ws = ts + KC * kBm;
        for (int e = tid; e < k * rows; e += kThreads) {
          const int p = e / rows, i = e - p * rows;
          const long long idx = (long long)p * m + r0 + i;
          cp_async4(ts + p * kBm + i, t + idx);
          cp_async4(ws + i * KC + p, w + idx);
        }
      }
    }
    cp_async_commit();
  };

  zero_losses<kThreads>(f_blk, k);
  float fr = 0.f, fc = 0.f;   // slot tid's loss sum and its compensation
  float tw[2];      // multi-chunk launches: the next chunk's target, weight
  if (!resident)
    prefetch_tw(tw, KC, (int)min((long long)kBm, m - (long long)blockIdx.x * kBm),
                (long long)blockIdx.x * kBm, m, 0, KC, t, w);
  if (vec) {
    float4 xr[kXVec];
    load_x(xr, x, n, 0, min(k, KC));
    store_x(xr, xs, n, min(k, KC));
    for (int q = 0; q < stages - 1; ++q)
      issue_tile(blockIdx.x + (long long)q * gridDim.x, q);
  }

  float g[WMAX][4];
#pragma unroll
  for (int s = 0; s < WMAX; ++s)
#pragma unroll
    for (int v = 0; v < 4; ++v) g[s][v] = 0.f;
  int li = 0;   // this block's tile count
  for (long long tile = blockIdx.x; tile < tiles;
       tile += gridDim.x, ++li) {
    const int buf = vec ? li % stages : 0;
    const T* at = tile_of(buf);
    float* ts = ts_of(buf);
    float* ws = ts + KC * kBm;
    const long long r0 = tile * kBm;
    const int rows = (int)min((long long)kBm, m - r0);
    const bool gstart = li % kGroupTiles == 0;
    const bool gend = (li + 1) % kGroupTiles == 0 || tile + gridDim.x >= tiles;
    const bool gfirst = li < kGroupTiles;
    if (vec) {
      cp_async_wait_n<kMaxStages - 2>(stages - 2);   // this tile has landed
      __syncthreads();   // for every thread; the tile before is done with
      issue_tile(tile + (long long)(stages - 1) * gridDim.x,
                 (li + stages - 1) % stages);
    } else {
      __syncthreads();
      copy_rows(tile_of(0), ldt, a + r0 * n, rows, n);
      if (resident) {
        for (int e = tid; e < k * rows; e += kThreads) {
          const int p = e / rows, i = e - p * rows;
          ts[p * kBm + i] = t[(long long)p * m + r0 + i];
          ws[i * KC + p] = w[(long long)p * m + r0 + i];
        }
        if (li == 0) copy_rows(xs, ldx, x, k, n);
      }
      __syncthreads();
    }
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * KC, live = min(KC, k - c0);
      if (!vec && !resident) {
        copy_rows(xs, ldx, x + (size_t)c0 * n, live, n);
        __syncthreads();
      }
      // The group partial: from the block's slice between chunks, unless
      // resident; loaded now, used in sweep 2.
      if (!resident) spill_g<WMAX>(g, g_grp, n, c0, live, gstart, false);
      switch (width_class(live)) {
        case 1: staged_sweep1<T, 1>(at, ldt, xs, ldx, n, rows, r0, m, c0, live, resident, tw, loss, param, z, ts, ws); break;
        case 2: if constexpr (WMAX >= 2) staged_sweep1<T, 2>(at, ldt, xs, ldx, n, rows, r0, m, c0, live, resident, tw, loss, param, z, ts, ws); break;
        case 4: if constexpr (WMAX >= 4) staged_sweep1<T, 4>(at, ldt, xs, ldx, n, rows, r0, m, c0, live, resident, tw, loss, param, z, ts, ws); break;
        default: if constexpr (WMAX >= 8) staged_sweep1<T, 8>(at, ldt, xs, ldx, n, rows, r0, m, c0, live, resident, tw, loss, param, z, ts, ws); break;
      }
      // Multi-chunk launches: the next chunk (chunk 0 again for the next
      // tile), its target and weight now, its X while this chunk's sweep 2
      // runs.
      const int cn = c + 1 < nchunks ? c + 1 : 0;
      const int live_n = min(KC, k - cn * KC);
      const long long tile_n = c + 1 < nchunks ? tile : tile + gridDim.x;
      const bool more = !resident && tile_n < tiles;
      if (more)
        prefetch_tw(tw, width_class(live_n),
                    (int)min((long long)kBm, m - tile_n * kBm), tile_n * kBm,
                    m, cn * KC, live_n, t, w);
      __syncthreads();   // losses and residuals are written; xs is free
      float4 xr[kXVec];
      if (vec && more) load_x(xr, x, n, cn * KC, live_n);
      add_losses<kThreads>(fr, fc, f_blk, k, ts, kBm, rows, c0, live);
      switch (width_class(live)) {
        case 1: staged_sweep2<T, 1, WMAX>(at, ldt, n, rows, ws, g); break;
        case 2: if constexpr (WMAX >= 2) staged_sweep2<T, 2, WMAX>(at, ldt, n, rows, ws, g); break;
        case 4: if constexpr (WMAX >= 4) staged_sweep2<T, 4, WMAX>(at, ldt, n, rows, ws, g); break;
        default: if constexpr (WMAX >= 8) staged_sweep2<T, 8, WMAX>(at, ldt, n, rows, ws, g); break;
      }
      if (gend) flush_g<WMAX>(g, g_blk, n, c0, live, gfirst);
      else if (!resident) spill_g<WMAX>(g, g_grp, n, c0, live, false, true);
      if (!resident) {
        if (vec && more) store_x(xr, xs, n, live_n);
        __syncthreads();   // ts, ws and xs are reused by the next chunk
      }
    }
  }
  cp_async_wait<0>();
  finish_losses<kThreads>(fr, fc, f_blk, k);
}

// -- unstaged path ---------------------------------------------------------

// Columns j..j+3 of the row at p (j a multiple of 4), upcast to f32: one
// vector load when VEC (n a multiple of 4, rows 16-byte aligned), else one
// load each, with zeros past n.  The arithmetic over them is the same
// either way.
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ p, int j, int n,
                                      float (&v)[4]) {
  if constexpr (VEC) {
    load_vec<T, 4>(p + j, v);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = j + u < n ? to_f32(p[j + u]) : 0.f;
  }
}

// One chunk of W slot positions, `live` of them real, over the row block
// blk: both sweeps read it from global memory, in groups of 4 columns, so
// each load instruction moves 4 elements and a thread keeps several in
// flight.
template <typename T, int W, bool VEC>
__device__ __forceinline__ void unstaged_chunk(
    const T* __restrict__ blk, const float* __restrict__ x,
    const float* __restrict__ t, const float* __restrict__ w, long long m,
    int n, int k, int rows, long long r0, int c0, int live, bool first,
    int loss, float param, float* __restrict__ z, float* __restrict__ g_blk,
    float* __restrict__ f_blk, float& fr, float& fc, float* __restrict__ rs,
    float* __restrict__ les) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = (n + 3) / 4;
  // Sweep 1: one warp a row; lane l sums columns 4q..4q+3 for the groups
  // q = l, l + 32, ..., W sums a lane, then the butterfly over the lanes.
  for (int i = warp; i < rows; i += kWarps) {
    float acc[W];
#pragma unroll
    for (int s = 0; s < W; ++s) acc[s] = 0.f;
    const T* arow = blk + (size_t)i * n;
#pragma unroll 4
    for (int q = lane; q < groups; q += 32) {
      const int j = 4 * q;
      float av[4];
      load4<T, VEC>(arow, j, n, av);
#pragma unroll
      for (int s = 0; s < W; ++s) {
        if (s < live) {
          float xv[4];
          load4<float, VEC>(x + (size_t)(c0 + s) * n, j, n, xv);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (VEC || j + u < n) acc[s] = fmaf(av[u], xv[u], acc[s]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < W; ++s)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], off);
#pragma unroll
    for (int s = 0; s < W; ++s) {
      if (lane == s && s < live) {
        const long long idx = (long long)(c0 + s) * m + r0 + i;
        float le, rr;
        row_loss(loss, param, acc[s], __ldg(t + idx), __ldg(w + idx), &le,
                 &rr);
        z[idx] = acc[s];
        rs[i * KC + s] = rr;
        les[s * kUnstagedRows + i] = le;
      }
    }
  }
  __syncthreads();
  add_losses<kThreads>(fr, fc, f_blk, k, les, kUnstagedRows, rows, c0,
                       live);
  // Sweep 2: thread c owns columns 4c..4c+3 (and every kThreads-th group
  // after), W x 4 sums through the block's slice, a chain over the rows.
  for (int q = tid; q < groups; q += kThreads) {
    const int j = 4 * q;
    float acc[W][4];
#pragma unroll
    for (int s = 0; s < W; ++s) {
      if (!first && s < live) {
        load4<float, VEC>(g_blk + (size_t)(c0 + s) * n, j, n, acc[s]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[s][u] = 0.f;
      }
    }
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      float av[4];
      load4<T, VEC>(blk + (size_t)i * n, j, n, av);
#pragma unroll
      for (int s = 0; s < W; ++s) {
        const float r = rs[i * KC + s];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[s][u] = fmaf(r, av[u], acc[s][u]);
      }
    }
#pragma unroll
    for (int s = 0; s < W; ++s) {
      if (s >= live) continue;
      float* gp = g_blk + (size_t)(c0 + s) * n + j;
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(gp) =
            make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j + u < n) gp[u] = acc[s][u];
      }
    }
  }
  __syncthreads();   // rs and les are reused next
}

// Every chunk at width W (the launch's widest chunk class), its dead slots
// masked.  The sweeps wait on global memory, so the registers are capped
// for kUnstagedMinBlocks blocks an SM.
template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(kThreads, kUnstagedMinBlocks)
fgm_unstaged(const T* __restrict__ a, const float* __restrict__ x,
             const float* __restrict__ t, const float* __restrict__ w,
             long long m, int n, int k, int loss, float param,
             float* __restrict__ z, float* __restrict__ g_part,
             float* __restrict__ f_part) {
  __shared__ float rs[kUnstagedRows * KC];
  __shared__ float les[KC * kUnstagedRows];
  const int bm = kUnstagedRows;
  float* g_blk = g_part + (size_t)blockIdx.x * k * n;
  float* f_blk = f_part + (size_t)blockIdx.x * 2 * k;
  zero_losses<kThreads>(f_blk, k);
  float fr = 0.f, fc = 0.f;   // slot threadIdx.x's loss sum, compensation
  for (long long r0 = (long long)blockIdx.x * bm; r0 < m;
       r0 += (long long)gridDim.x * bm) {
    const int rows = (int)min((long long)bm, m - r0);
    const T* blk = a + r0 * n;
    const bool first = r0 == (long long)blockIdx.x * bm;
    for (int c0 = 0; c0 < k; c0 += KC)
      unstaged_chunk<T, W, VEC>(blk, x, t, w, m, n, k, rows, r0, c0,
                                min(KC, k - c0), first, loss, param, z,
                                g_blk, f_blk, fr, fc, rs, les);
  }
  finish_losses<kThreads>(fr, fc, f_blk, k);
}

template <typename T, int WMAX>
const void* kernel_path(int staged, int vec) {
  if (staged) return (const void*)&fgm_staged<T, WMAX>;
  return vec ? (const void*)&fgm_unstaged<T, WMAX, true>
             : (const void*)&fgm_unstaged<T, WMAX, false>;
}

template <typename T>
const void* kernel_wmax(int staged, int vec, int wmax) {
  switch (wmax) {
    case 1: return kernel_path<T, 1>(staged, vec);
    case 2: return kernel_path<T, 2>(staged, vec);
    case 4: return kernel_path<T, 4>(staged, vec);
    default: return kernel_path<T, 8>(staged, vec);
  }
}

// The kernel for storage `dtype`, the path and k slots: the widest chunk
// class k meets picks the variant, and so only the registers it holds
// (never a slot's arithmetic).
const void* kernel_for(int dtype, int staged, int vec, int k) {
  const int wmax = width_class(k < KC ? k : KC);
  if (dtype == DT_BF16) return kernel_wmax<__nv_bfloat16>(staged, vec, wmax);
  if (dtype == DT_F32) return kernel_wmax<float>(staged, vec, wmax);
  if (dtype == DT_F8) return kernel_wmax<fp8>(staged, vec, wmax);
  if (dtype == DT_F8E5) return kernel_wmax<fp8e5>(staged, vec, wmax);
  return nullptr;
}

int tsize_for(int dtype) {
  return dtype == DT_F8 || dtype == DT_F8E5 ? 1 : dtype == DT_BF16 ? 2 : 4;
}

}  // namespace

// Path and grid for an (m x n) operand of storage `dtype` on `device`.
// They follow from (m, n, dtype) and the card alone, never from the slot
// count, so a slot's sums run in the same order for every k.
extern "C" int repro_fused_grad_multi_plan(int device, long long m, int n,
                                           int dtype, int* staged,
                                           int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (m < 1 || n < 1 || kernel_for(dtype, 1, 1, 1) == nullptr)
    return cudaErrorInvalidValue;
  *staged = n <= kStagedMaxN;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int bm = *staged ? kBm : kUnstagedRows;
  long long g = *staged ? sms                  // one block an SM
                        : (long long)sms * kUnstagedBlocksPerSM;
  const long long blocks = (m + bm - 1) / bm;
  if (blocks < g) g = blocks;
  *grid = (int)g;
  return cudaSuccess;
}

// a (m, n) f32, bf16, e4m3 or e5m2 row-major, x (k, n), t and w (k, m)
// f32, any k >= 1;
// z (k, m), g_part (grid, 1 + staged, k, n), f_part (grid, 2, k), g (k, n)
// and f (k) f32 outputs and scratch.
extern "C" int repro_fused_grad_multi(int device, const void* a, int dtype,
                                      const void* x, const void* t,
                                      const void* w, long long m, int n,
                                      int k, int staged, int grid, int loss,
                                      float param, void* z, void* g_part,
                                      void* f_part, void* g, void* f,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k < 1 || grid < 1) return cudaErrorInvalidValue;
  const int tsize = tsize_for(dtype);
  // Vector loads (cp.async and float4 on the staged path, four elements a
  // load on the unstaged one) need 16-byte aligned A and X and rows of a
  // multiple of 4 elements (16 bytes each on the staged path, so a
  // multiple of 16 in fp8); otherwise they load element by element, with
  // the same arithmetic.
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 && n % 4 == 0;
  int vec = aligned && (!staged || (size_t)n * tsize % 16 == 0);
  const void* fn = kernel_for(dtype, staged, vec, k);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long mm = m;
  int nn = n, kk = k, ll = loss;
  float pp = param;
  if (staged) {
    int stages = stages_for(n, tsize);
    const size_t smem = staged_smem(n, tsize, stages);
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    void* args[] = {const_cast<void**>(&a), const_cast<void**>(&x),
                    const_cast<void**>(&t), const_cast<void**>(&w), &mm,
                    &nn, &kk, &stages, &vec, &ll, &pp, &z, &g_part, &f_part};
    err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, smem, s);
  } else {
    void* args[] = {const_cast<void**>(&a), const_cast<void**>(&x),
                    const_cast<void**>(&t), const_cast<void**>(&w), &mm,
                    &nn, &kk, &ll, &pp, &z, &g_part, &f_part};
    err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, 0, s);
  }
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long kn = (long long)k * n;
  launch_multi_reduce(static_cast<const float*>(g_part),
                      static_cast<const float*>(f_part), grid, k, n,
                      (staged ? 2 : 1) * kn, static_cast<float*>(g),
                      static_cast<float*>(f), s);
  return cudaGetLastError();
}
