// Flash attention forward with native GQA: O = softmax(Q K^T * scale) V,
// causal or not, for q (B*Hq, Sq, D) and k, v (B*Hkv, Sk, D) in f32 or bf16.
// The causal mask is top-left, as the reference's tril((Sq, Sk)): query row
// i sees keys 0..i, so rows >= Sk see every key.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel).  On the H100 it is bound by operations:
// 4*D flops per live (query, key) pair (S(S+1)/2 pairs a head when causal
// and Sq = Sk = S)
// against one read of q, k, v and one write of o.  This first version runs
// f32 FMA on the CUDA cores (no tensor cores), so its ceiling is the f32
// rate, not the bf16 tensor-core rate its bound is priced at.
//
// Design.  The TPU kernel walks the key tiles on a sequential grid axis and
// keeps the running max m, sum l and the (bq x D) accumulator in VMEM
// scratch.  Here one block of 256 threads owns one (b*hq, 64-query tile) and
// loops over the 64-key tiles itself, skipping those past the causal
// diagonal.  Q (transposed) and each K (transposed) and V tile are staged in
// shared memory, upcast to f32, so a thread reads a float4 of 4 query rows
// and a float4 of 4 keys per d and does 16 FMAs with them.  Thread (ty, tx)
// owns query rows 4*ty..4*ty+3: their scores at keys 4*tx..4*tx+3 of the
// tile, their m and l (the same on the 16 lanes of a half-warp, reduced by
// shuffles) and their accumulator columns tx, tx + 16, ..., all in
// registers.  p goes through shared memory to the PV product, rounded to
// V's type first as the reference rounds it (p.astype(v.dtype)); l sums the
// unrounded p, as the reference does.  The KV row is bh / group (the
// q-head-major flattening of the reference's kv_map).  The ragged edges
// are masked inside the kernel (keys >= Sk score MASK_VALUE, rows >= Sq are
// not written), causal or not; a causal key tile is visited iff its first
// key is <= the query tile's last row and < Sk.  Query tiles are launched
// last first, so the longest causal rows start first.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows a block
constexpr int kBK = 64;       // keys a tile
constexpr int kThreads = 256; // 16 x 16: 4 rows x 4 keys of the scores each
constexpr int kPStride = kBK + 4;  // padded row of p (16-byte aligned)
constexpr float kMask = -0.7f * 3.402823466e38f;  // the reference's MASK_VALUE

template <int D>
constexpr int smem_floats() {
  return D * kBQ + D * kBK + kBK * D + kBQ * kPStride;
}

__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// rows [r0, r0 + 64) of a (S, D) matrix into dst[d * 64 + r] (transposed),
// 16 bytes a load, lanes on consecutive rows; rows >= S read as 0.
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(const T* __restrict__ src,
                                                 int r0, int S,
                                                 float* __restrict__ dst) {
  constexpr int V = 16 / sizeof(T);
  for (int e = threadIdx.x; e < 64 * (D / V); e += kThreads) {
    const int r = e % 64, c = (e / 64) * V;
    float vals[V];
    if (r0 + r < S) {
      load_vec<T, V>(src + (size_t)(r0 + r) * D + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dst[(c + i) * 64 + r] = vals[i];
  }
}

// rows [r0, r0 + 64) of a (S, D) matrix into dst[r * D + d]; rows >= S as 0.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int r0,
                                           int S, float* __restrict__ dst) {
  constexpr int V = 16 / sizeof(T);
  for (int e = threadIdx.x; e < 64 * (D / V); e += kThreads) {
    const int r = e / (D / V), c = (e % (D / V)) * V;
    float vals[V];
    if (r0 + r < S) {
      load_vec<T, V>(src + (size_t)(r0 + r) * D + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * D + c + i] = vals[i];
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
          int group, float scale, int causal) {
  constexpr int CPT = D / 16;  // accumulator columns a thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [D][kBQ]
  float* kt = qt + D * kBQ;      // [D][kBK]
  float* vs = kt + D * kBK;      // [kBK][D]
  float* ps = vs + kBK * D;      // [kBQ][kPStride]

  const int nq = (Sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)(bh / group) * Sk * D;
  const T* vb = v + (size_t)(bh / group) * Sk * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage_transposed<T, D>(qb, q0, Sq, qt);

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
    stage_transposed<T, D>(kb, k0, Sk, kt);
    stage_rows<T, D>(vb, k0, Sk, vs);
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
          make_float4(round_as(p[0], v), round_as(p[1], v),
                      round_as(p[2], v), round_as(p[3], v));
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
    T* out = o + ((size_t)bh * Sq + row) * D + tx;
#pragma unroll
    for (int j = 0; j < CPT; ++j) store_f32(out + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bhq, int Sq, int Sk, int group, float scale,
                   int causal, cudaStream_t stream) {
  auto fn = flash_fwd<T, D>;
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, bhq);
  fn<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, group, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int bhq, int Sq, int Sk, int group,
                     float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, bhq, Sq, Sk, group, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, bhq, Sq, Sk, group, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, bhq, Sq, Sk, group, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
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
  if (dtype == DT_BF16)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, bhq, Sq, Sk, group, scale,
                                   causal, s);
  if (dtype == DT_F32)
    return launch_d<float>(D, q, k, v, o, bhq, Sq, Sk, group, scale, causal,
                           s);
  return cudaErrorInvalidValue;
}
