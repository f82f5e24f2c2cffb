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
// units (16 a clock an SM), against one read of x and dt and one write of y
// (about as long).
//
// Design.  The TPU kernel keeps an (N, bd) state tile in VMEM and walks S in
// chunks on a sequential grid axis.  Here one thread owns one (b, c): its N
// states, A[c, :] and D[c] stay in registers for the whole walk, so the
// state never touches memory.  A block covers one batch row and 128
// channels; each 32-step time tile of x and dt (coalesced across channels)
// and of B_t and C_t (shared by every channel) is staged in shared memory
// first, so a thread has 64 independent loads in flight instead of a load
// latency every step.  y is written each step, coalesced across channels.
// Ragged d (channels >= d) and S (the last tile) are masked in the kernel.
#include "common.cuh"

namespace {

constexpr int kChannels = 128;  // threads a block, one channel each
constexpr int kSteps = 32;      // time steps a staged tile

template <int N>
__global__ void __launch_bounds__(kChannels)
scan_fwd(const float* __restrict__ x, const float* __restrict__ dt,
         const float* __restrict__ A, const float* __restrict__ B,
         const float* __restrict__ C, const float* __restrict__ Dv,
         const float* __restrict__ h0, float* __restrict__ y,
         float* __restrict__ h_out, int S, int d) {
  __shared__ float xs[kSteps][kChannels];
  __shared__ float dts[kSteps][kChannels];
  __shared__ float bs[kSteps][N];
  __shared__ float cs[kSteps][N];

  const int b = blockIdx.y;
  const int c = blockIdx.x * kChannels + threadIdx.x;
  const bool on = c < d;
  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = on ? A[(size_t)c * N + n] : 0.f;
    h[n] = (on && h0) ? h0[((size_t)b * d + c) * N + n] : 0.f;
  }
  const float skip = on ? Dv[c] : 0.f;
  const float* xb = x + (size_t)b * S * d;
  const float* dtb = dt + (size_t)b * S * d;
  const float* Bb = B + (size_t)b * S * N;
  const float* Cb = C + (size_t)b * S * N;
  float* yb = y + (size_t)b * S * d;

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int steps = min(kSteps, S - t0);
    __syncthreads();  // the previous tile is read
    for (int t = 0; t < steps; ++t) {
      const size_t at = (size_t)(t0 + t) * d + c;
      xs[t][threadIdx.x] = on ? xb[at] : 0.f;
      dts[t][threadIdx.x] = on ? dtb[at] : 0.f;
    }
    for (int e = threadIdx.x; e < steps * N; e += kChannels) {
      bs[e / N][e % N] = Bb[(size_t)t0 * N + e];
      cs[e / N][e % N] = Cb[(size_t)t0 * N + e];
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float xv = xs[t][threadIdx.x], dv = dts[t][threadIdx.x];
      const float dx = dv * xv;
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dv * a[n]) * h[n] + dx * bs[t][n];
        yv = fmaf(h[n], cs[t][n], yv);
      }
      if (on) yb[(size_t)(t0 + t) * d + c] = yv + skip * xv;
    }
  }
  if (on) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[((size_t)b * d + c) * N + n] = h[n];
  }
}

template <int N>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, const void* D, const void* h0, void* y,
                   void* h_out, int Bt, int S, int d, cudaStream_t stream) {
  const dim3 grid((d + kChannels - 1) / kChannels, Bt);
  scan_fwd<N><<<grid, kChannels, 0, stream>>>(
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
    default: return cudaErrorInvalidValue;
  }
}
