// Mamba1 selective scan: for each (batch b, channel c) and t = 0 .. S-1,
//   h_t = exp(dt_t * A[c]) o h_{t-1} + dt_t * x_t * B_t   (N states)
//   y_t = C_t . h_t + D[c] * x_t
// with x, dt (Bt, S, d), A (d, N), B, C (Bt, S, N), D (d), an optional h0
// (Bt, d, N), all f32; writes y (Bt, S, d) and the final state (Bt, d, N).
//
// Replaces the TPU kernel src/repro/kernels/selective_scan.py:
// selective_scan (_scan_kernel), and also writes the final state the
// reference kernel leaves out (prefill into a cache needs it).  On the H100
// it is bound by operations: Bt*S*d*N exponentials on the special-function
// units (MUFU, 16 a clock an SM), against one read of x and dt and one
// write of y (about as long).
//
// Design.  The TPU kernel keeps an (N, bd) state tile in VMEM and walks S in
// chunks on a sequential grid axis.  Here a channel's states are split over
// N / 8 adjacent lanes of a warp (8 at N = 64, 4 at 32, 2 at 16, one at
// 8), 8 states a lane in registers for the whole walk with A[c, those
// states] and D[c]: at the Mamba1 path's shape (4 x 2048 x 8192, N = 16)
// 2048 warps, about 16 an SM, where one thread a channel gave 8.  Each step
// a lane computes dt*A' and its exponentials as ex2.approx of A pre-scaled
// by log2(e) (one multiply and one MUFU op each, no range reduction), its
// states and its part of C_t . h_t + D x_t.  Every 4 steps the lanes of a
// channel sum their parts by reduce_scatter (common.cuh): with 4 lanes or
// fewer each lane ends with whole sums of its own steps; with 8 (N = 64)
// each step's sum ends on two lanes alike, and only the first of them
// (ScatterOut's writer) stores it.  S is walked in order, not split into
// chunks with a second pass: that needs cumulative decays, a second
// exponential a state and step.
//
// Mamba2 (zamba2's prefill, N = 64) runs this same recurrence: its head h
// of Pd channels shares one dt and one decay, so the model passes dt and A
// repeated over the head's channels (A[c, n] = A_h for every n), and this
// kernel computes Pd * N exponentials where the head needs one (a later
// redesign's saving, ROADMAP.md).
//
// Staging.  Tiles of 16 steps of x and dt (the block's 16 to 128 channels)
// and of B_t and C_t (shared by every channel) stream through a ring of 3
// stages of 16-byte cp.async copies, so the next tiles land while this one
// is walked.  A step's row of x (and of dt) is staged from the 16-byte
// boundary at or below its first element, whatever d, and read back at its
// shift; a lane reads B_t's and C_t's 8 states as two float4 each.  y goes
// to a staged tile first and is written a tile later, coalesced across
// channels (two y buffers).  Development versions with 4-byte copies into
// channel-major tiles were held by those copies and by y's writes, not by
// the exponentials; tools/diagnose_kernels.py --kernel selective_scan times
// this kernel without each of them, and with 4 states a lane (PERF.md).
// Ragged d (channels >= d) and S (the last tile) are masked; channels past
// d walk zeros and write nothing.  There are no atomics, and every sum has
// a fixed order: two runs give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;    // 4 warps a block
constexpr int kSteps = 16;       // time steps a stage
constexpr int kStages = 3;
constexpr int kGroup = 4;        // steps whose y are summed together
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSteps % kGroup == 0, "whole groups in a full tile");

// 2^x, one MUFU op (flushes subnormal results to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A block's channels and shared memory.  Lane group g (kLanes adjacent
// lanes) owns channel g of the block.  x and dt (which start on 16-byte
// boundaries) step-major: each step's row of the block's channels is staged
// from the 16-byte boundary at or below its first element (kWin floats: the
// widest window), so channel c of step t sits at shift_t + c, shift_t =
// (the element's index) mod 4.  B_t and C_t step-major; y step-major in two
// buffers, rows kYRow floats apart.
template <int N>
struct Tile {
  static constexpr int kStates = N < 8 ? N : 8;     // states a lane
  static constexpr int kLanes = N / kStates;        // lanes a channel
  static constexpr int kChannels = kThreads / kLanes;
  static constexpr int kWin = kChannels + 4;
  static constexpr int kYRow = kChannels + 8;
  float x[kStages][kSteps][kWin];
  float dt[kStages][kSteps][kWin];
  float b[kStages][kSteps][N];
  float c[kStages][kSteps][N];
  float y[2][kSteps][kYRow];
  static_assert(kStates % 4 == 0, "states in float4s");
};

template <int N>
__global__ void __launch_bounds__(kThreads)
scan_fwd(const float* __restrict__ x, const float* __restrict__ dt,
         const float* __restrict__ A, const float* __restrict__ B,
         const float* __restrict__ C, const float* __restrict__ Dv,
         const float* __restrict__ h0, float* __restrict__ y,
         float* __restrict__ h_out, int S, int d) {
  using T = Tile<N>;
  constexpr int kStates = T::kStates, kLanes = T::kLanes;
  constexpr int kCh = T::kChannels;
  constexpr int kPieces = T::kWin / 4;   // 16-byte pieces a staged row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T& sm = *reinterpret_cast<T*>(smem_raw);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCh;
  const int cl = threadIdx.x / kLanes, q = threadIdx.x % kLanes;
  const int c = c0 + cl;
  const bool on = c < d;
  const int n0 = kStates * q;    // the lane's first state
  // The lane's A (pre-scaled by log2(e)) and states, and D, which only the
  // channel's first lane adds to its part of y.
  float a2[kStates], h[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    a2[i] = on ? A[(size_t)c * N + n0 + i] * kLog2e : 0.f;
    h[i] = (on && h0) ? h0[((size_t)b * d + c) * N + n0 + i] : 0.f;
  }
  const float skip = on && q == 0 ? Dv[c] : 0.f;
  const size_t bsd = (size_t)b * S * d;
  const float* Bb = B + (size_t)b * S * N;
  const float* Cb = C + (size_t)b * S * N;
  float* yb = y + bsd;
  const int ntiles = (S + kSteps - 1) / kSteps;
  const int width = min(kCh, d - c0);   // the block's channels

  // Copy tile j's steps of x and dt (each step's window; its pieces read
  // only the block's channels and write zeros past them) and of B_t and
  // C_t (whole 16-byte pieces; zeros past S) into stage `buf`.
  auto issue = [&](int j, int buf) {
    const int t0 = j * kSteps, steps = min(kSteps, S - t0);
    for (int e = threadIdx.x; e < kSteps * kPieces; e += kThreads) {
      const int t = e / kPieces, pc = e % kPieces;
      const size_t first = bsd + (size_t)(t0 + t) * d + c0;
      const int shift = (int)(first & 3);
      const int end = t < steps ? 4 * (shift + width) : 0;
      const int bytes = min(max(end - 16 * pc, 0), 16);
      const size_t at = first - shift + 4 * pc;
      cp_async16_zfill(&sm.x[buf][t][4 * pc], bytes ? x + at : x, bytes);
      cp_async16_zfill(&sm.dt[buf][t][4 * pc], bytes ? dt + at : dt, bytes);
    }
    for (int e = threadIdx.x; e < kSteps * N / 4; e += kThreads) {
      const int bytes = 4 * e / N < steps ? 16 : 0;
      const size_t at = (size_t)t0 * N + 4 * e;
      cp_async16_zfill(&sm.b[buf][0][0] + 4 * e, bytes ? Bb + at : B, bytes);
      cp_async16_zfill(&sm.c[buf][0][0] + 4 * e, bytes ? Cb + at : C, bytes);
    }
  };
  // Write tile j's y, staged in y buffer j & 1, coalesced across channels:
  // thread i writes channel i % kCh of steps i / kCh, + kRows, ...
  auto write_y = [&](int j) {
    constexpr int kRows = kThreads / kCh;
    const int t0 = j * kSteps, steps = min(kSteps, S - t0);
    const int cc = threadIdx.x % kCh;
    if (cc >= width) return;
    float* out = yb + (size_t)(t0 + threadIdx.x / kCh) * d + c0 + cc;
    for (int t = threadIdx.x / kCh; t < steps; t += kRows) {
      *out = sm.y[j & 1][t][cc];
      out += (size_t)kRows * d;
    }
  };
  // One step t of stage buf (shift sh in its window): the lane's states,
  // and its part of C_t . h_t + D x_t.
  auto step = [&](int buf, int t, int sh) {
    float bt[kStates], ct[kStates];
#pragma unroll
    for (int v = 0; v < kStates; v += 4) {
      const float4 bv =
          *reinterpret_cast<const float4*>(&sm.b[buf][t][n0 + v]);
      const float4 cv =
          *reinterpret_cast<const float4*>(&sm.c[buf][t][n0 + v]);
      bt[v] = bv.x, bt[v + 1] = bv.y, bt[v + 2] = bv.z, bt[v + 3] = bv.w;
      ct[v] = cv.x, ct[v + 1] = cv.y, ct[v + 2] = cv.z, ct[v + 3] = cv.w;
    }
    const float xv = sm.x[buf][t][sh + cl], dv = sm.dt[buf][t][sh + cl];
    const float dx = dv * xv;
    float yp = skip * xv;
#pragma unroll
    for (int i = 0; i < kStates; ++i) {
      h[i] = fmaf(ex2(dv * a2[i]), h[i], dx * bt[i]);
      yp = fmaf(h[i], ct[i], yp);
    }
    return yp;
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) issue(s, s);
    cp_async_commit();
  }
  using Out = ScatterOut<kLanes, kGroup>;
  const Out out(q);
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile j landed; tile j - 1's walk is done
    if (j + kStages - 1 < ntiles)
      issue(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    if (j > 0) write_y(j - 1);

    const int buf = j % kStages;
    const int steps = min(kSteps, S - j * kSteps);
    // Step t's shift in its window: (bsd + (t0 + t) d + c0) mod 4 (mod 2^32
    // keeps the residue).
    const unsigned sh0 = (unsigned)(bsd + (size_t)j * kSteps * d + c0);
    float (&ys)[kSteps][T::kYRow] = sm.y[j & 1];
    // Whole groups of kGroup steps: the parts of y summed over the
    // channel's lanes and scattered by reduce_scatter (lane q ends with the
    // sums of steps out.first ..), which each lane stores.
    int t = 0;
    for (; t + kGroup <= steps; t += kGroup) {
      float yg[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        yg[u] = step(buf, t + u, (int)((sh0 + (unsigned)(t + u) * d) & 3u));
      reduce_scatter<kLanes, kGroup>(yg, q);
      if (out.writer) {
#pragma unroll
        for (int v = 0; v < Out::NQ; ++v) ys[t + out.first + v][cl] = yg[v];
      }
    }
    // The tile's last steps (S off the group): one at a time.
    for (; t < steps; ++t) {
      float yp = step(buf, t, (int)((sh0 + (unsigned)t * d) & 3u));
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
        yp += __shfl_xor_sync(0xffffffffu, yp, off);
      if (q == 0) ys[t][cl] = yp;
    }
  }
  __syncthreads();
  if (ntiles > 0) write_y(ntiles - 1);
  if (on) {
#pragma unroll
    for (int i = 0; i < kStates; ++i)
      h_out[((size_t)b * d + c) * N + n0 + i] = h[i];
  }
}

template <int N>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, const void* D, const void* h0, void* y,
                   void* h_out, int Bt, int S, int d, cudaStream_t stream) {
  constexpr int kCh = Tile<N>::kChannels;
  constexpr int smem = sizeof(Tile<N>);
  cudaError_t err = cudaFuncSetAttribute(
      scan_fwd<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((d + kCh - 1) / kCh, Bt);
  scan_fwd<N><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), S, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_selective_scan(int device, const void* x, const void* dt,
                                    const void* A, const void* B,
                                    const void* C, const void* D,
                                    const void* h0, void* y, void* h_out,
                                    int Bt, int S, int d, int N,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Bt == 0 || d == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8: return launch<8>(x, dt, A, B, C, D, h0, y, h_out, Bt, S, d, s);
    case 16: return launch<16>(x, dt, A, B, C, D, h0, y, h_out, Bt, S, d, s);
    case 32: return launch<32>(x, dt, A, B, C, D, h0, y, h_out, Bt, S, d, s);
    case 64: return launch<64>(x, dt, A, B, C, D, h0, y, h_out, Bt, S, d, s);
    default: return cudaErrorInvalidValue;
  }
}
