// Fused composite gradient for k right-hand sides (slots) sharing one
// block-ELL A (nbr block-rows of `ell` stored bs x bs blocks, block-column
// ids in cols[nbr][ell]): one read of the stored blocks gives, for every
// slot s < k,
//   f_s = sum_i W_si l((A X_s)_i, T_si),  G_s = A^T (W_s o l'(A X_s, T_s)),
//   Z_s = A X_s,
// for any k >= 1 in one launch.
//
// Replaces the TPU kernel src/repro/kernels/fusedgrad.py:fused_grad_bsr_multi
// (_fused_grad_bsr_multi_kernel): the serving path's group pass on a sparse
// design matrix (core/optim/batched over SparseRowMatrix).  For a few slots
// it is bound by bytes on the H100: every stored block is read once
// (nbr*ell*bs*bs*sizeof(storage)) for 4k flops an element, plus X, T, W, Z
// and G; in f32 FMA at 67 TFLOP/s and 3.35 TB/s the operations pass the
// bytes of f32 blocks near k = 20.  Storage is f32 or bf16, upcast in
// registers; the residual stays f32; sums in f32.  int8 shards never come
// here: kernels/ops.py composes bsr_matmul and bsr_rmatmul for them, as the
// reference does.
//
// Design.  The TPU kernel walks block-rows on a sequential grid and
// scatter-adds each (k x bs) slab A_ij^T R into a VMEM-resident
// (nbc x k x bs) accumulator.  Here a persistent grid walks block-rows with
// a block stride, and every stored block leaves HBM once, whatever k is:
// the slots go through a block-row in chunks of KC = 8 (a constant).
// Staged path (a block-row of at most 64 KB and 1024 columns; S's 16
// blocks of 32 x 32 in f32 or bf16): one block an SM keeps a ring of three
// block-rows (two where three do not fit) in shared memory in the storage
// type, filled by 16-byte cp.async pieces from every thread, so the next
// block-rows land while this one is computed.  The chunk's X slab (the
// KC x ell*bs entries of X that the block-row's columns select) is
// gathered into registers while the previous chunk's second sweep runs,
// then stored beside it.  Per chunk:
//   sweep 1: Z = A_row X_slab^T, register-tiled: a thread owns 4 rows (2
//            at bs 8) x 4 slots over every few groups of 4 entries, so each
//            A and X value read from shared memory serves 4 FMAs; a
//            butterfly over the lanes that share a tile, then one lane an
//            output forms the residual and loss (row_loss.cuh);
//   sweep 2: every thread forms contributions sum_r R[r][s] A[sl][r][c] for
//            4 in-block columns of one stored block and 4 slots into shared
//            memory; then thread (s, c) alone adds slot s's contributions at
//            in-block offset c, stored block by stored block in order, into
//            the block's partial G at cols[sl]*bs + c, so no atomics are
//            needed even when two stored blocks of a block-row share a
//            column (padding slots sit at column 0); it loads eight old
//            values at once, so the adds wait on memory once a batch.
// Unstaged path (wider block-rows): two blocks an SM read the block-row
// from global memory in both sweeps (one warp a row; thread (s, c) forms
// and adds its own contributions), a chunk at a time.
// G is k x n, too large for shared memory at wide n, so each block keeps
// its partial G in its own slice of g_part (grid x k x n f32); a second
// kernel (multi_reduce, row_loss.cuh) sums the slices, and the blocks'
// partial f, in block order, with compensation.  A slot's losses are summed
// a block-row at a time and the block-row sums added with compensation, so
// f stays accurate however many rows a block walks.  No float atomics.
// Slot independence: the paths, the grid, the chunk width and the column
// split of sweep 1 follow from A's shape, its storage and the card alone,
// never from k, and every slot's z, f and G is a sum in an order fixed by
// them and not by the slot's index or the chunk's live width, so a slot's
// bits depend neither on the other slots' values, nor on how many slots
// there are, nor on which slot it is: a request gets the same bits alone or
// anywhere in a group, and repeated runs agree bit for bit.
#include "common.cuh"
#include "row_loss.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 64 * 1024;     // a staged block-row's blocks
constexpr int kMaxWidth = 1024;            // entries of a staged row
constexpr int kUnstagedBlocksPerSM = 2;
constexpr int kMaxStages = 6;
constexpr int kOwnerBatch = 16;            // stored blocks an owner adds at once
constexpr size_t kSmemMax = 232448;        // a block's shared memory
constexpr int kXVec = KC * kMaxWidth / 4 / kThreads;   // X pieces a thread

// A stage of the staged path's ring: the block-row's ell blocks (T), then
// the chunk's targets as ts[KC][bs] and weights as ws[bs][KC] (f32).  Sweep
// 1 overwrites each target with its loss and each weight with its
// residual, the same lane the same entry, so ts becomes the losses
// (slot-major) and ws the residuals (row-major).  Beside the ring, xs
// [KC][ell*bs] holds the chunk's X slab and, once sweep 1 is done with it,
// sweep 2's contributions contrib[ell][KC][bs] (the same size).
__host__ __device__ inline size_t stage_bytes(int bs, int ell, int tsize) {
  return (size_t)ell * bs * bs * tsize + 2 * (size_t)KC * bs * sizeof(float);
}

__host__ __device__ inline size_t xs_bytes(int bs, int ell) {
  return (size_t)KC * ell * bs * sizeof(float);
}

// Stages of the ring, as many as fit (3 for S's block-rows in f32, 5 in
// bf16): the shape and the storage decide, never the slot count.
int stages_for(int bs, int ell, int tsize) {
  const int s = (int)((kSmemMax - xs_bytes(bs, ell)) /
                      stage_bytes(bs, ell, tsize));
  return s > kMaxStages ? kMaxStages : s;
}

size_t staged_smem(int bs, int ell, int tsize, int stages) {
  return stages * stage_bytes(bs, ell, tsize) + xs_bytes(bs, ell);
}

// Thread (slot p, in-block column c) adds slot p's contributions of the
// block-row's stored blocks, in order, into its G entries at
// cols[sl]*BS + c, kOwnerBatch blocks at a time: the batch's old values are
// loaded together (owner_load; the first batch of a thread's first owner
// task a chunk ahead, right after its last stores), and a column met twice
// in a batch (padding slots) continues from its running value, so every
// entry sees the same chain of adds as one block at a time would give it.
struct OwnerBatch {
  int col[kOwnerBatch];
  float v[kOwnerBatch];
};

template <int BS>
__device__ __forceinline__ void owner_load(OwnerBatch& b,
                                           const float* __restrict__ gs,
                                           const int* __restrict__ ci,
                                           int s0, int ell) {
#pragma unroll
  for (int q = 0; q < kOwnerBatch; ++q)
    b.col[q] = s0 + q < ell ? __ldg(ci + s0 + q) : -1;
#pragma unroll
  for (int q = 0; q < kOwnerBatch; ++q)
    b.v[q] = b.col[q] >= 0 ? gs[(size_t)b.col[q] * BS] : 0.f;
}

template <int BS>
__device__ __forceinline__ void owner_add(OwnerBatch& b,
                                          float* __restrict__ gs,
                                          const float* __restrict__ cp,
                                          int s0) {
#pragma unroll
  for (int q = 0; q < kOwnerBatch; ++q) {
    if (b.col[q] < 0) continue;
#pragma unroll
    for (int e = 0; e < q; ++e)
      if (b.col[e] == b.col[q]) b.v[q] = b.v[e];
    b.v[q] += cp[(size_t)(s0 + q) * KC * BS];
  }
#pragma unroll
  for (int q = 0; q < kOwnerBatch; ++q)
    if (b.col[q] >= 0) gs[(size_t)b.col[q] * BS] = b.v[q];
}

// All of an owner task's batches; with `loaded`, `first` is its first
// batch already loaded.
template <int BS>
__device__ __forceinline__ void owner_adds(float* __restrict__ gs,
                                           const int* __restrict__ ci,
                                           const float* __restrict__ cp,
                                           int ell, OwnerBatch& first,
                                           bool loaded) {
  if (loaded) owner_add<BS>(first, gs, cp, 0);
  for (int s0 = loaded ? kOwnerBatch : 0; s0 < ell; s0 += kOwnerBatch) {
    OwnerBatch b;
    owner_load<BS>(b, gs, ci, s0, ell);
    owner_add<BS>(b, gs, cp, s0);
  }
}

// Sweep 1's thread map at block size BS: thread (rg, sg, jg) owns RT rows
// (row group rg) and slot group sg (min(W, 4) slots) over every JGS-th
// group of 4 entries; the JGS lanes sharing a (rows, slots) tile sum it by
// reduce_scatter (common.cuh), which leaves each output with one lane.
template <int BS>
struct Sweep1Map {
  static constexpr int RT = BS >= 16 ? 4 : 2;
  static constexpr int RG = BS / RT;
  static constexpr int JGS = kThreads / (2 * RG);
  static constexpr int NQ = 4 * RT >= JGS ? 4 * RT / JGS : 1;
  int jg, sg, rg;
  __device__ __forceinline__ Sweep1Map() {
    jg = threadIdx.x % JGS;
    const int ti = threadIdx.x / JGS;
    sg = ti & 1;
    rg = ti >> 1;
  }
};

// The outputs lane jg forms the residuals of, in a chunk of width class
// W: rows i[q] and slot positions p[q] for q < n; false if none.
template <int BS, int W>
__device__ __forceinline__ int lane_outputs(
    const Sweep1Map<BS>& mp, int (&i)[Sweep1Map<BS>::NQ],
    int (&p)[Sweep1Map<BS>::NQ]) {
  using Map = Sweep1Map<BS>;
  constexpr int ST = W < 4 ? W : 4, SG = W / ST, V = Map::RT * ST;
  const ScatterOut<Map::JGS, V> out(mp.jg);
  if (mp.sg >= SG || !out.writer) return 0;
#pragma unroll
  for (int q = 0; q < ScatterOut<Map::JGS, V>::NQ; ++q) {
    i[q] = mp.rg * Map::RT + (out.first + q) / ST;
    p[q] = mp.sg * ST + (out.first + q) % ST;
  }
  return ScatterOut<Map::JGS, V>::NQ;
}

template <int BS>
__device__ __forceinline__ int lane_outputs(
    int wc, const Sweep1Map<BS>& mp, int (&i)[Sweep1Map<BS>::NQ],
    int (&p)[Sweep1Map<BS>::NQ]) {
  switch (wc) {
    case 1: return lane_outputs<BS, 1>(mp, i, p);
    case 2: return lane_outputs<BS, 2>(mp, i, p);
    case 4: return lane_outputs<BS, 4>(mp, i, p);
    default: return lane_outputs<BS, 8>(mp, i, p);
  }
}

// Multi-chunk launches: the targets and weights this lane's residuals will
// read in the chunk of width class `wc` at block-row br and slots c0..,
// loaded one chunk ahead so their latency hides behind the chunk before.
template <int BS>
__device__ __forceinline__ void prefetch_tw(
    float (&tw)[Sweep1Map<BS>::NQ][2], int wc, long long br, long long m,
    int c0, int live, const float* __restrict__ t,
    const float* __restrict__ w) {
  using Map = Sweep1Map<BS>;
  const Map mp;
  int i[Map::NQ], p[Map::NQ];
  const int nq = lane_outputs<BS>(wc, mp, i, p);
#pragma unroll
  for (int q = 0; q < Map::NQ; ++q) {
    if (q < nq && p[q] < live) {
      const long long idx = (long long)(c0 + p[q]) * m + br * BS + i[q];
      tw[q][0] = __ldg(t + idx);
      tw[q][1] = __ldg(w + idx);
    }
  }
}

// Sweep 1 of one chunk over the staged block-row `at` (block-row `br`):
// z, and in place of the targets and weights (from the stage when
// `staged`, else from prefetch_tw) the losses ts[p][r] and residuals
// ws[r][p].
template <typename T, int BS, int W>
__device__ __forceinline__ void staged_sweep1(
    const T* __restrict__ at, const float* __restrict__ xs, int ell,
    long long br, long long m, int c0, int live, bool staged,
    const float (&tw)[Sweep1Map<BS>::NQ][2], int loss, float param,
    float* __restrict__ z, float* __restrict__ ts, float* __restrict__ ws) {
  using Map = Sweep1Map<BS>;
  constexpr int RT = Map::RT;                 // rows a thread
  constexpr int JGS = Map::JGS;               // lanes sharing a tile
  constexpr int ST = W < 4 ? W : 4;           // slots a thread
  constexpr int SG = W / ST;                  // slot groups: 2 when W = 8
  const int width = ell * BS;
  const Map mp;
  // Whole warps of a second slot group idle when W < 8; narrower lane
  // groups compute on and store nothing, so every lane takes the shuffles.
  if (mp.sg >= SG && JGS >= 32) return;
  float acc[RT * ST];
#pragma unroll
  for (int o = 0; o < RT * ST; ++o) acc[o] = 0.f;
  const float* xrow = xs + (size_t)mp.sg * ST * width;
#pragma unroll 2
  for (int q = mp.jg; q < width / 4; q += JGS) {
    const int j = 4 * q, sl = j / BS, c = j % BS;
    const T* ab = at + (size_t)sl * BS * BS + mp.rg * RT * BS + c;
    float av[RT][4], xv[ST][4];
#pragma unroll
    for (int r = 0; r < RT; ++r) load_vec<T, 4>(ab + r * BS, av[r]);
#pragma unroll
    for (int s = 0; s < ST; ++s) load_vec<float, 4>(xrow + s * width + j, xv[s]);
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int s = 0; s < ST; ++s)
          acc[r * ST + s] = fmaf(av[r][v], xv[s][v], acc[r * ST + s]);
  }
  reduce_scatter<JGS, RT * ST>(acc, mp.jg);
  int i[Map::NQ], p[Map::NQ];
  const int nq = lane_outputs<BS, W>(mp, i, p);
#pragma unroll
  for (int q = 0; q < Map::NQ; ++q) {
    if (q < nq && p[q] < live) {
      const long long idx = (long long)(c0 + p[q]) * m + br * BS + i[q];
      float* tl = ts + p[q] * BS + i[q];
      float* wl = ws + i[q] * KC + p[q];
      float le, rr;
      row_loss(loss, param, acc[q], staged ? *tl : tw[q][0],
               staged ? *wl : tw[q][1], &le, &rr);
      z[idx] = acc[q];
      *wl = rr;
      *tl = le;
    }
  }
}

// Sweep 2's contributions of one chunk: contrib[sl][p][c] =
// sum_r R[r][p] A[sl][r][c], a chain over the rows in order, 4 columns x up
// to 4 slots a task.
template <typename T, int BS, int W>
__device__ __forceinline__ void staged_contrib(const T* __restrict__ at,
                                               int ell,
                                               const float* __restrict__ rs,
                                               float* __restrict__ contrib) {
  constexpr int ST = W < 4 ? W : 4;
  constexpr int SG = W / ST;
  constexpr int C4 = BS / 4;
  const int tasks = ell * C4 * SG;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int sg = task % SG, rest = task / SG;
    const int c4 = rest % C4, sl = rest / C4;
    const T* ab = at + (size_t)sl * BS * BS + c4 * 4;
    float acc[ST][4];
#pragma unroll
    for (int s = 0; s < ST; ++s)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[s][v] = 0.f;
#pragma unroll 4
    for (int r = 0; r < BS; ++r) {
      float av[4], rv[ST];
      load_vec<T, 4>(ab + r * BS, av);
      if constexpr (ST == 4) {
        const float4 r4 =
            *reinterpret_cast<const float4*>(rs + r * KC + sg * 4);
        rv[0] = r4.x;
        rv[1] = r4.y;
        rv[2] = r4.z;
        rv[3] = r4.w;
      } else {
#pragma unroll
        for (int s = 0; s < ST; ++s) rv[s] = rs[r * KC + s];
      }
#pragma unroll
      for (int s = 0; s < ST; ++s)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[s][v] = fmaf(rv[s], av[v], acc[s][v]);
    }
#pragma unroll
    for (int s = 0; s < ST; ++s)
      *reinterpret_cast<float4*>(
          contrib + ((size_t)sl * KC + sg * ST + s) * BS + c4 * 4) =
          make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
  }
}

template <typename T, int BS>
__global__ void __launch_bounds__(kThreads, 1)
fgbm_staged(const T* __restrict__ data, const int* __restrict__ cols,
            const float* __restrict__ x, const float* __restrict__ t,
            const float* __restrict__ w, long long nbr, int ell, int n,
            int k, int stages, int loss, float param, float* __restrict__ z,
            float* __restrict__ g_part, float* __restrict__ f_part) {
  constexpr int kElems = BS * BS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int width = ell * BS;
  const size_t stage = (size_t)ell * kElems;     // elements of the blocks
  const size_t sbytes = stage_bytes(BS, ell, (int)sizeof(T));
  float* xs = reinterpret_cast<float*>(smem + stages * sbytes);
  float* contrib = xs;   // once sweep 1 is done with the slab
  const long long m = nbr * BS;
  const int tid = threadIdx.x;
  const int nchunks = (k + KC - 1) / KC;
  const bool resident = nchunks == 1;
  float* g_blk = g_part + (size_t)blockIdx.x * k * n;
  float* f_blk = f_part + (size_t)blockIdx.x * 2 * k;
  auto tile_of = [&](int buf) {
    return reinterpret_cast<T*>(smem + buf * sbytes);
  };
  auto ts_of = [&](int buf) {
    return reinterpret_cast<float*>(smem + buf * sbytes + stage * sizeof(T));
  };

  // Block-row i into stage `buf`, 16-byte pieces from every thread, and
  // (resident launches) its rows' targets and weights; one group.
  auto issue_row = [&](long long i, int buf) {
    if (i < nbr) {
      const int pieces = (int)(stage * sizeof(T) / 16);
      const char* src = reinterpret_cast<const char*>(data + i * stage);
      char* dst = reinterpret_cast<char*>(tile_of(buf));
      for (int e = tid; e < pieces; e += kThreads)
        cp_async16(dst + 16 * e, src + 16 * e);
      if (resident) {
        float* ts = ts_of(buf);
        float* ws = ts + KC * BS;
        for (int e = tid; e < k * BS; e += kThreads) {
          const int p = e / BS, r = e % BS;
          const long long idx = (long long)p * m + i * BS + r;
          cp_async4(ts + p * BS + r, t + idx);
          cp_async4(ws + r * KC + p, w + idx);
        }
      }
    }
    cp_async_commit();
  };
  // Chunk c's X slab of block-row i (rows c*KC.. of X at the columns the
  // block-row selects) as float4 pieces in registers: thread tid's pieces
  // tid, tid + kThreads, ..., stored into xs once sweep 2 is done.
  float4 xr[kXVec];
  auto load_x = [&](long long i, int c) {
    const int live = min(KC, k - c * KC), w4 = width / 4;
    const int* ci = cols + i * ell;
#pragma unroll
    for (int q = 0; q < kXVec; ++q) {
      const int e = tid + q * kThreads;
      if (e < live * w4) {
        const int p = e / w4, j = 4 * (e - p * w4);
        xr[q] = __ldg(reinterpret_cast<const float4*>(
            x + (size_t)(c * KC + p) * n + (size_t)__ldg(ci + j / BS) * BS +
            j % BS));
      }
    }
  };
  auto store_x = [&](int live) {
#pragma unroll
    for (int q = 0; q < kXVec; ++q) {
      const int e = tid + q * kThreads;
      if (e < live * (width / 4)) reinterpret_cast<float4*>(xs)[e] = xr[q];
    }
  };

  // Thread tid's first owner task, slot position tid / BS at in-block
  // column tid % BS, and its first batch, loaded a chunk ahead.
  OwnerBatch pre;
  auto owner_prefetch = [&](long long i, int c0, int live) {
    if (tid < live * BS)
      owner_load<BS>(pre, g_blk + (size_t)(c0 + tid / BS) * n + tid % BS,
                     cols + i * ell, 0, ell);
  };

  for (long long e = tid; e < (long long)k * n; e += kThreads) g_blk[e] = 0.f;
  zero_losses<kThreads>(f_blk, k);
  float fr = 0.f, fc = 0.f;   // slot tid's loss sum and its compensation
  float tw[Sweep1Map<BS>::NQ][2];   // multi-chunk: the next chunk's t, w
  if (!resident)
    prefetch_tw<BS>(tw, KC, blockIdx.x, m, 0, KC, t, w);
  __syncthreads();   // the zeroed slice before any thread reads it
  owner_prefetch(blockIdx.x, 0, min(k, KC));
  load_x(blockIdx.x, 0);
  store_x(min(k, KC));
  for (int q = 0; q < stages - 1; ++q)
    issue_row(blockIdx.x + (long long)q * gridDim.x, q);

  int li = 0;   // this block's block-row count
  for (long long i = blockIdx.x; i < nbr; i += gridDim.x, ++li) {
    const int buf = li % stages;
    const T* at = tile_of(buf);
    float* ts = ts_of(buf);
    float* ws = ts + KC * BS;
    const int* ci = cols + i * ell;
    const long long next = i + gridDim.x;
    cp_async_wait_n<kMaxStages - 2>(stages - 2);   // this block-row landed
    __syncthreads();   // for every thread; the block-row before is done with
    issue_row(i + (long long)(stages - 1) * gridDim.x,
              (li + stages - 1) % stages);
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * KC, live = min(KC, k - c0);
      switch (width_class(live)) {
        case 1: staged_sweep1<T, BS, 1>(at, xs, ell, i, m, c0, live, resident, tw, loss, param, z, ts, ws); break;
        case 2: staged_sweep1<T, BS, 2>(at, xs, ell, i, m, c0, live, resident, tw, loss, param, z, ts, ws); break;
        case 4: staged_sweep1<T, BS, 4>(at, xs, ell, i, m, c0, live, resident, tw, loss, param, z, ts, ws); break;
        default: staged_sweep1<T, BS, 8>(at, xs, ell, i, m, c0, live, resident, tw, loss, param, z, ts, ws); break;
      }
      // The next chunk (this block-row's, or the next block-row's first):
      // its targets and weights now (multi-chunk launches), its X slab
      // while this chunk's sweep 2 runs.
      const bool more = c + 1 < nchunks || next < nbr;
      const int live_n = c + 1 < nchunks ? min(KC, k - c0 - KC) : min(k, KC);
      const long long i_n = c + 1 < nchunks ? i : next;
      const int c_n = c + 1 < nchunks ? c + 1 : 0;
      if (more && !resident)
        prefetch_tw<BS>(tw, width_class(live_n), i_n, m, c_n * KC, live_n,
                        t, w);
      __syncthreads();   // losses and residuals are written; xs is free
      if (more) load_x(i_n, c_n);
      add_losses<kThreads>(fr, fc, f_blk, k, ts, BS, BS, c0, live);
      switch (width_class(live)) {
        case 1: staged_contrib<T, BS, 1>(at, ell, ws, contrib); break;
        case 2: staged_contrib<T, BS, 2>(at, ell, ws, contrib); break;
        case 4: staged_contrib<T, BS, 4>(at, ell, ws, contrib); break;
        default: staged_contrib<T, BS, 8>(at, ell, ws, contrib); break;
      }
      __syncthreads();
      // Thread (p, c) alone owns slot p's G entries at in-block offset c.
      for (int e = tid; e < live * BS; e += kThreads) {
        const int p = e / BS, cc = e % BS;
        owner_adds<BS>(g_blk + (size_t)(c0 + p) * n + cc, ci,
                       contrib + p * BS + cc, ell, pre, e == tid);
      }
      if (more) owner_prefetch(i_n, c_n * KC, live_n);
      __syncthreads();   // the contributions are added; xs is free again
      if (more) store_x(live_n);
      __syncthreads();   // xs, ts and ws are reused next
    }
  }
  cp_async_wait<0>();
  finish_losses<kThreads>(fr, fc, f_blk, k);
}

// -- unstaged path ---------------------------------------------------------

template <typename T, int BS, int W>
__device__ __forceinline__ void unstaged_chunk(
    const T* __restrict__ blk, const int* __restrict__ ci,
    const float* __restrict__ x, const float* __restrict__ t,
    const float* __restrict__ w, long long br, long long m, int ell, int n,
    int k, int c0, int live, int loss, float param, float* __restrict__ z,
    float* __restrict__ g_blk, float* __restrict__ f_blk, float& fr,
    float& fc, float* __restrict__ rs, float* __restrict__ les) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int width = ell * BS;
  // Sweep 1: one warp a row, W sums a lane over the row's entries.
  for (int r = warp; r < BS; r += kWarps) {
    float acc[W];
#pragma unroll
    for (int s = 0; s < W; ++s) acc[s] = 0.f;
    for (int j = lane; j < width; j += 32) {
      const int sl = j / BS, c = j % BS;
      const float a = to_f32(blk[(sl * BS + r) * BS + c]);
      const float* xc = x + (size_t)c0 * n + (size_t)__ldg(ci + sl) * BS + c;
#pragma unroll
      for (int s = 0; s < W; ++s)
        if (s < live) acc[s] = fmaf(a, __ldg(xc + (size_t)s * n), acc[s]);
    }
#pragma unroll
    for (int s = 0; s < W; ++s)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], off);
#pragma unroll
    for (int s = 0; s < W; ++s) {
      if (lane == s && s < live) {
        const long long idx = (long long)(c0 + s) * m + br * BS + r;
        float le, rr;
        row_loss(loss, param, acc[s], __ldg(t + idx), __ldg(w + idx), &le,
                 &rr);
        z[idx] = acc[s];
        rs[r * KC + s] = rr;
        les[s * BS + r] = le;
      }
    }
  }
  __syncthreads();
  add_losses<kThreads>(fr, fc, f_blk, k, les, BS, BS, c0, live);
  // Sweep 2: thread (p, c) forms and adds its own contributions.
  for (int e = tid; e < live * BS; e += kThreads) {
    const int p = e / BS, c = e % BS;
    float* gs = g_blk + (size_t)(c0 + p) * n + c;
    for (int sl = 0; sl < ell; ++sl) {
      float acc = 0.f;
#pragma unroll 8
      for (int r = 0; r < BS; ++r)
        acc = fmaf(rs[r * KC + p], to_f32(blk[(sl * BS + r) * BS + c]), acc);
      gs[(size_t)__ldg(ci + sl) * BS] += acc;
    }
  }
  __syncthreads();   // rs and les are reused next
}

template <typename T, int BS>
__global__ void __launch_bounds__(kThreads)
fgbm_unstaged(const T* __restrict__ data, const int* __restrict__ cols,
              const float* __restrict__ x, const float* __restrict__ t,
              const float* __restrict__ w, long long nbr, int ell, int n,
              int k, int stages, int loss, float param,
              float* __restrict__ z, float* __restrict__ g_part,
              float* __restrict__ f_part) {
  __shared__ float rs[BS * KC];
  __shared__ float les[KC * BS];
  const long long m = nbr * BS;
  float* g_blk = g_part + (size_t)blockIdx.x * k * n;
  float* f_blk = f_part + (size_t)blockIdx.x * 2 * k;
  for (long long e = threadIdx.x; e < (long long)k * n; e += kThreads)
    g_blk[e] = 0.f;
  zero_losses<kThreads>(f_blk, k);
  float fr = 0.f, fc = 0.f;   // slot threadIdx.x's loss sum, compensation
  __syncthreads();   // the zeroed slice before any thread adds into it
  for (long long i = blockIdx.x; i < nbr; i += gridDim.x) {
    const T* blk = data + i * ell * BS * BS;
    const int* ci = cols + i * ell;
    for (int c0 = 0; c0 < k; c0 += KC) {
      const int live = min(KC, k - c0);
      switch (width_class(live)) {
        case 1: unstaged_chunk<T, BS, 1>(blk, ci, x, t, w, i, m, ell, n, k, c0, live, loss, param, z, g_blk, f_blk, fr, fc, rs, les); break;
        case 2: unstaged_chunk<T, BS, 2>(blk, ci, x, t, w, i, m, ell, n, k, c0, live, loss, param, z, g_blk, f_blk, fr, fc, rs, les); break;
        case 4: unstaged_chunk<T, BS, 4>(blk, ci, x, t, w, i, m, ell, n, k, c0, live, loss, param, z, g_blk, f_blk, fr, fc, rs, les); break;
        default: unstaged_chunk<T, BS, 8>(blk, ci, x, t, w, i, m, ell, n, k, c0, live, loss, param, z, g_blk, f_blk, fr, fc, rs, les); break;
      }
    }
  }
  finish_losses<kThreads>(fr, fc, f_blk, k);
}

template <typename T, int BS>
const void* kernel_path(int staged) {
  return staged ? (const void*)&fgbm_staged<T, BS>
                : (const void*)&fgbm_unstaged<T, BS>;
}

template <typename T>
const void* kernel_bs(int bs, int staged) {
  switch (bs) {
    case 8: return kernel_path<T, 8>(staged);
    case 16: return kernel_path<T, 16>(staged);
    case 32: return kernel_path<T, 32>(staged);
    case 64: return kernel_path<T, 64>(staged);
    case 128: return kernel_path<T, 128>(staged);
    default: return nullptr;
  }
}

const void* kernel_for(int dtype, int bs, int staged) {
  if (dtype == DT_F32) return kernel_bs<float>(bs, staged);
  if (dtype == DT_BF16) return kernel_bs<__nv_bfloat16>(bs, staged);
  return nullptr;
}

int tsize_for(int dtype) { return dtype == DT_BF16 ? 2 : 4; }

}  // namespace

// The path and the grid for nbr block-rows of `ell` bs x bs blocks of
// storage `dtype` on `device`: they follow from the shape, the storage and
// the card alone, never from the slot count.
extern "C" int repro_fused_grad_bsr_multi_plan(int device, long long nbr,
                                               int ell, int bs, int n,
                                               int dtype, int* staged,
                                               int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbr < 1 || ell < 1 || n < bs || kernel_for(dtype, bs, 1) == nullptr)
    return cudaErrorInvalidValue;
  *staged = (size_t)ell * bs * bs * tsize_for(dtype) <= (size_t)kStageBytes
            && ell * bs <= kMaxWidth;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long g = *staged ? sms : (long long)sms * kUnstagedBlocksPerSM;
  *grid = (int)(nbr < g ? nbr : g);
  return cudaSuccess;
}

// data (nbr, ell, bs, bs) f32 or bf16, cols (nbr, ell) int32, x (k, n) f32,
// t, w (k, nbr*bs) f32, any k >= 1; z (k, nbr*bs), g_part (grid, k, n),
// f_part (grid, 2, k), g (k, n) and f (k) f32 outputs and scratch.  The
// staged path's bulk copies need data and x 16-byte aligned (the caller
// copies a view that is not): a misaligned pointer is an error, never
// another path.
extern "C" int repro_fused_grad_bsr_multi(int device, const void* data,
                                          int dtype, const void* cols,
                                          const void* x, const void* t,
                                          const void* w, long long nbr,
                                          int ell, int bs, int n, int k,
                                          int staged, int grid, int loss,
                                          float param, void* z, void* g_part,
                                          void* f_part, void* g, void* f,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k < 1 || grid < 1) return cudaErrorInvalidValue;
  if (staged && (reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return cudaErrorMisalignedAddress;
  const void* fn = kernel_for(dtype, bs, staged);
  if (fn == nullptr) return cudaErrorInvalidValue;
  int stages = stages_for(bs, ell, tsize_for(dtype));
  const size_t smem =
      staged ? staged_smem(bs, ell, tsize_for(dtype), stages) : 0;
  if (staged) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long nb = nbr;
  int ee = ell, nn = n, kk = k, ll = loss;
  float pp = param;
  void* args[] = {const_cast<void**>(&data), const_cast<void**>(&cols),
                  const_cast<void**>(&x), const_cast<void**>(&t),
                  const_cast<void**>(&w), &nb, &ee, &nn, &kk, &stages, &ll,
                  &pp, &z, &g_part, &f_part};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long kn = (long long)k * n;
  launch_multi_reduce(static_cast<const float*>(g_part),
                      static_cast<const float*>(f_part), grid, k, n,
                      kn, static_cast<float*>(g),
                      static_cast<float*>(f), s);
  return cudaGetLastError();
}
