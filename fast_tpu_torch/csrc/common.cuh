// Device code shared by the kernels: Philox4x32-10, the Cody-Waite sincos
// and the noise transforms. The detect pass that the iid kernels end with
// is in detect.cuh, the tensor-core helpers in tf32x3.cuh and wgmma.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fast {

constexpr int kThreads = 256;
constexpr int kK2 = 16;  // depth tile of the AR kernels' fp32 FMA detect

constexpr float kS3 = 1.7320508075688772f;             // sqrt(3)
constexpr float kS3Scale = 1.7320508075688772f * 1.1920928955078125e-07f;
constexpr float kTwoM24 = 5.9604644775390625e-08f;     // 2^-24
constexpr float kTwoM25 = 2.98023223876953125e-08f;    // 2^-25
constexpr float kTwoPi = 6.2831855f;                    // float32(2 pi)

struct U4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ U4 philox4x32_10(uint32_t c0, uint32_t c1,
                                            uint32_t c2, uint32_t c3,
                                            uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return {c0, c1, c2, c3};
}

__device__ __forceinline__ void sincos_cw(float phi, float* s_out,
                                          float* c_out) {
  const float q = rintf(phi * 0.6366197723675814f);
  float r = phi - q * 1.5703125f;
  r = r - q * 4.837512969970703e-4f;
  r = r - q * 7.549789948768648e-8f;
  const float r2 = r * r;
  const float s = r + r * r2 * (-1.6666654611e-1f +
                                r2 * (8.3321608736e-3f +
                                      r2 * -1.9515295891e-4f));
  const float c = 1.0f + r2 * (-0.5f +
                               r2 * (4.166664568298827e-2f +
                                     r2 * (-1.388731625493765e-3f +
                                           r2 * 2.443315711809948e-5f)));
  const int qi = static_cast<int>(q);
  float sv = (qi & 1) ? c : s;
  float cv = (qi & 1) ? s : c;
  if (qi & 2) sv = -sv;
  if ((qi + 1) & 2) cv = -cv;
  *s_out = sv;
  *c_out = cv;
}

// 'mixed' noise: a raw uniform of unit variance from the top 24 bits,
// (bits >> 8) * sqrt(3) 2^-23 - sqrt(3); rounded products, no FMA, so the
// plain torch version gets the same value.
__device__ __forceinline__ float mixed_uniform(uint32_t bits) {
  return __fadd_rn(__fmul_rn(static_cast<float>(bits >> 8), kS3Scale), -kS3);
}

// 'gauss' noise: Box-Muller from two 24-bit uniforms, u1 in (0, 1]
// shifted by 2^-25 off zero; returns (r cos, r sin).
__device__ __forceinline__ void box_muller(uint32_t b1, uint32_t b2,
                                           float* z_cos, float* z_sin) {
  const float u1 =
      __fadd_rn(__fmul_rn(static_cast<float>(b1 >> 8), kTwoM24), kTwoM25);
  const float u2 = __fmul_rn(static_cast<float>(b2 >> 8), kTwoM24);
  const float rad = sqrtf(-2.0f * logf(u1));
  float st, ct;
  sincos_cw(kTwoPi * u2, &st, &ct);
  *z_cos = rad * ct;
  *z_sin = rad * st;
}

}  // namespace fast
