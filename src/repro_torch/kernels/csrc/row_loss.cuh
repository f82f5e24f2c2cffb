// The row-separable losses of the fused-gradient kernels
// (fused_grad_multi.cu, fused_grad_bsr.cu): fusedgrad.py:row_loss_elem in
// f32, one row at a time.
#pragma once

namespace {

enum Loss { LOSS_QUAD = 0, LOSS_LOGISTIC = 1, LOSS_HUBER = 2, LOSS_POISSON = 3 };

// (w l(z, t), w l'(z, t)): fusedgrad.py:row_loss_elem, in f32.
__device__ __forceinline__ void row_loss(int loss, float param, float z,
                                         float t, float w, float* le,
                                         float* r) {
  if (loss == LOSS_QUAD) {
    const float d = z - t;
    *le = 0.5f * w * d * d;
    *r = w * d;
  } else if (loss == LOSS_LOGISTIC) {
    const float mz = -t * z;
    *le = w * (fmaxf(mz, 0.f) + log1pf(expf(-fabsf(mz))));  // logaddexp(0, mz)
    *r = w * (-t) * (1.f / (1.f + expf(-mz)));              // sigmoid(mz)
  } else if (loss == LOSS_HUBER) {
    const float d = z - t;
    const float a = fabsf(d);
    *le = w * (a <= param ? 0.5f * d * d : param * (a - 0.5f * param));
    *r = w * fminf(fmaxf(d, -param), param);
  } else {
    const float ez = expf(z);
    *le = w * (ez - t * z);
    *r = w * (ez - t);
  }
}

}  // namespace
