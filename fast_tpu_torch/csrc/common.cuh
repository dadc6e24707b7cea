// Device code shared by the synth-detect (K2) and colfac-detect (K1)
// kernels: Philox4x32-10, the Cody-Waite sincos, the noise constants and
// the detect pass that both kernels end with.
//
// Detect pass (pass 2 of both kernels): one block per complex draw j. From
// the draw's G' (N x P, real and imaginary parts) it forms the transposed
// screens H = W G' (P x P complex; Re H and Im H are two screens), adds the
// transposed subharmonic screens if given, and reduces
//   sum(pm_t * cos/sin(Re H)), sum(pm_t * cos/sin(Im H))
// in a fixed order (warp shuffles, then the 8 warp partials), so a run is
// reproducible bit for bit on one card.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fast {

constexpr int kThreads = 256;
constexpr int kK2 = 16;  // depth tile of the detect pass

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

// The detect pass. g_re/g_im: (nbatch, N, P) per launch; sh_t: nullptr or
// (nbatch, 2, P, P), the transposed real and imaginary subharmonic
// screens; out: (nbatch, 4).
template <int PJ>
__global__ void __launch_bounds__(kThreads)
    detect_pass(const float* __restrict__ wr, const float* __restrict__ wi,
                const float* __restrict__ g_re, const float* __restrict__ g_im,
                const float* __restrict__ pm_t, const float* __restrict__ sh_t,
                float* __restrict__ out, int N) {
  constexpr int P = 16 * PJ;
  constexpr int WS = P + 1;
  __shared__ float swr[kK2 * WS], swi[kK2 * WS];
  __shared__ float sgr[kK2 * P], sgi[kK2 * P];
  __shared__ float red[kThreads / 32][4];

  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* gr = g_re + static_cast<size_t>(j) * N * P;
  const float* gi = g_im + static_cast<size_t>(j) * N * P;

  float hr[PJ][PJ], hi[PJ][PJ];
#pragma unroll
  for (int a = 0; a < PJ; ++a)
#pragma unroll
    for (int b = 0; b < PJ; ++b) hr[a][b] = hi[a][b] = 0.0f;

  for (int kb = 0; kb < N; kb += kK2) {
    __syncthreads();
    // rows of W and G' past N are zeros
    for (int e = tid; e < P * kK2; e += kThreads) {
      const int p = e / kK2, kk = e - p * kK2;
      const bool in = kb + kk < N;
      swr[kk * WS + p] = in ? wr[static_cast<size_t>(p) * N + kb + kk] : 0.0f;
      swi[kk * WS + p] = in ? wi[static_cast<size_t>(p) * N + kb + kk] : 0.0f;
    }
    for (int e = tid; e < kK2 * P; e += kThreads) {
      const bool in = kb + e / P < N;
      sgr[e] = in ? gr[static_cast<size_t>(kb) * P + e] : 0.0f;
      sgi[e] = in ? gi[static_cast<size_t>(kb) * P + e] : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kK2; ++kk) {
      float ar[PJ], ai[PJ], br[PJ], bi[PJ];
#pragma unroll
      for (int a = 0; a < PJ; ++a) {
        ar[a] = swr[kk * WS + ty + 16 * a];
        ai[a] = swi[kk * WS + ty + 16 * a];
        br[a] = sgr[kk * P + tx + 16 * a];
        bi[a] = sgi[kk * P + tx + 16 * a];
      }
#pragma unroll
      for (int a = 0; a < PJ; ++a)
#pragma unroll
        for (int b = 0; b < PJ; ++b) {
          hr[a][b] = fmaf(ar[a], br[b], hr[a][b]);
          hr[a][b] = fmaf(-ai[a], bi[b], hr[a][b]);
          hi[a][b] = fmaf(ar[a], bi[b], hi[a][b]);
          hi[a][b] = fmaf(ai[a], br[b], hi[a][b]);
        }
    }
  }

  const float* sh_r =
      sh_t == nullptr ? nullptr : sh_t + static_cast<size_t>(j) * 2 * P * P;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int a = 0; a < PJ; ++a)
#pragma unroll
    for (int b = 0; b < PJ; ++b) {
      const int idx = (ty + 16 * a) * P + tx + 16 * b;
      const float w = pm_t[idx];
      float h1 = hr[a][b], h2 = hi[a][b];
      if (sh_r != nullptr) {
        h1 += sh_r[idx];
        h2 += sh_r[P * P + idx];
      }
      float s, c;
      sincos_cw(h1, &s, &c);
      acc[0] = fmaf(w, c, acc[0]);
      acc[1] = fmaf(w, s, acc[1]);
      sincos_cw(h2, &s, &c);
      acc[2] = fmaf(w, c, acc[2]);
      acc[3] = fmaf(w, s, acc[3]);
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  if ((tid & 31) == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[tid >> 5][i] = acc[i];
  __syncthreads();
  if (tid < 4) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][tid];
    out[static_cast<size_t>(j) * 4 + tid] = s;
  }
}

}  // namespace fast
