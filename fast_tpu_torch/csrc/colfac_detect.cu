// K1: colfac-basis noise synthesis and pupil-overlap detection, for Hopper
// (sm_90a).
//
// Replaces fast_tpu/ops/pallas_synth.py::_colfac_detect_kernel_merged, the
// TPU kernel behind SYNTH='pallas_colfac'. The pruned screen W X W^T is
// drawn in the column-factored basis: the columns of G = W X are
// independent with covariance C_m = L_m L_m^H, so G[:, m] = L_m z_m with a
// white z_m of the pupil's length instead of a full grid column. Per
// complex draw j:
//
//   bits   two 32-bit words per noise lane of each column m, 128 lanes
//   noise  'mixed': raw uniforms u = (bits >> 8) sqrt(3) 2^-23 - sqrt(3);
//          the orthogonal 128 x 128 mix is folded into the factor table
//          'gauss': Box-Muller from 24-bit uniforms (live lanes only)
//   factor G'[m, :] = [u_r | u_i] S_m           (1 x K) @ (K x 2P)
//   DFT    H = W G'                           (P, N) @ (N, P), complex
//   detect sum(pm_t * cos/sin(Re H + sh_r)), sum(pm_t * cos/sin(Im H + sh_i))
//
// S_m is the real-block form of B_m = M L_m^T ('mixed', M the mixing
// matrix) or B_m = L_m^T ('gauss'), with the rows of the two noise
// components interleaved (row 2q: u_r of lane q, row 2q + 1: u_i) and the
// columns of G's real and imaginary parts interleaved (column 2p: Re G_p,
// 2p + 1: Im G_p):
//   S_m[2q, p] = (Re B[q, p], Im B[q, p]),  S_m[2q+1, p] = (-Im B, Re B).
// fast_tpu_torch/ops/colfac_detect.py::pack_tables builds it. G' = G^T is
// exactly the G' of the synth-detect kernel (K2), so pass 2 is K2's own
// detect pass (common.cuh), with the same transposed pm and screens.
//
// Mixing width. The TPU kernel mixes 128 uniforms per component per column
// (its 128-lane tile), so every z is a sum of 128 uniforms; K = 256 rows
// here too, whatever the padded pupil width. 'gauss' draws only the lanes
// that meet nonzero rows of L (K = 2 * npup rounded up to 16 lanes), from
// the same counters.
//
// What bounds it on the card: arithmetic on the CUDA cores. At 512^2 with
// an 82 px pupil (padded to 96), one 'mixed' draw costs N * 2 * 256 * 164
// = 43 MFLOP of factor products and 8 P^2 N = 27.5 MFLOP for H, against
// 86 MB of factor tables that every launch reads once. This first version
// uses fp32 FMA, no tensor cores.
//
// What the design does about it:
// * Pass 1 is one block per (64 draws, column m): a (64 x K) @ (K x 2P)
//   product with the draws as its rows. The noise of a depth slice of 32
//   rows (16 lanes) is drawn straight into shared memory; the matching 32
//   rows of S_m stream in beside it with 16-byte loads. Each thread holds
//   4 draws x PJ pupil pixels x (re, im): one 16-byte load of noise and PJ
//   8-byte loads of S per 8 PJ FMAs, without bank conflicts.
// * Blocks of one column are adjacent in launch order, so the 64 draw
//   tiles of a 4096-draw launch read S_m from L2, not from device memory.
// * The TPU kernel's on-chip (b, P, P) accumulators over sequential column
//   blocks do not carry over (blocks run in no order): pass 1 writes G'
//   (N x P per draw, 1.6 GB per 4096-draw launch at 512^2, P=96) and pass 2
//   contracts it over the columns in one block per draw.
//
// Random bits. Philox4x32-10 keyed by the 64-bit seed (k0 = low word,
// k1 = high word). Counter of lane q (0..127) of column m of draw d:
//   ctr = (m * 128 + q, d, stream, 1);  bits1 = out[0] (u_r or u1),
//   bits2 = out[1] (u_i or u2).
// The last word 1 keeps K1's streams apart from K2's (last word 0). The
// plain torch version builds the same counters, so kernel and plain
// version see identical noise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace fast;

constexpr int kDT = 64;      // draws per pass-1 block
constexpr int kKS = 32;      // depth slice: 16 lanes x 2 components
constexpr int kLanes = 128;  // Philox lanes per column

// Pass 1: one block per (64 draws, column m). Writes G'[j, m, :].
template <bool kMixed, int PJ>
__global__ void __launch_bounds__(kThreads, 2)
    colfac_pass1(uint32_t k0, uint32_t k1, uint32_t stream, int draw0,
                 int nbatch, const float* __restrict__ S,
                 float* __restrict__ g_re, float* __restrict__ g_im, int N,
                 int K) {
  constexpr int P = 16 * PJ;  // padded pupil width
  constexpr int C = 2 * P;    // columns of S_m: (pixel, re/im) interleaved
  __shared__ __align__(16) float zs[kKS * kDT];  // noise slice, [row][draw]
  __shared__ __align__(16) float ss[kKS * C];    // S_m slice, [row][col]

  const int m = blockIdx.y;
  const int j0 = blockIdx.x * kDT;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* sm = S + static_cast<size_t>(m) * K * C;

  float acc[4][PJ][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int jj = 0; jj < PJ; ++jj) acc[r][jj][0] = acc[r][jj][1] = 0.0f;

  for (int kb = 0; kb < K; kb += kKS) {
    // noise of lanes kb/2 .. kb/2 + 15 for the block's 64 draws; draws
    // past nbatch are zeros
#pragma unroll
    for (int i = 0; i < kKS / 2 * kDT / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int l = e / kDT, d = e - l * kDT;
      float z0 = 0.0f, z1 = 0.0f;
      if (j0 + d < nbatch) {
        const U4 v = philox4x32_10(
            static_cast<uint32_t>(m * kLanes + kb / 2 + l),
            static_cast<uint32_t>(draw0 + j0 + d), stream, 1u, k0, k1);
        if (kMixed) {
          z0 = mixed_uniform(v.x);
          z1 = mixed_uniform(v.y);
        } else {
          box_muller(v.x, v.y, &z0, &z1);
        }
      }
      zs[(2 * l) * kDT + d] = z0;
      zs[(2 * l + 1) * kDT + d] = z1;
    }
    const float4* src = reinterpret_cast<const float4*>(
        sm + static_cast<size_t>(kb) * C);
    float4* dst = reinterpret_cast<float4*>(ss);
    for (int e = tid; e < kKS * C / 4; e += kThreads) dst[e] = src[e];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKS; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&zs[kk * kDT + 4 * ty]);
#pragma unroll
      for (int jj = 0; jj < PJ; ++jj) {
        const float2 b =
            *reinterpret_cast<const float2*>(&ss[kk * C + 2 * (tx + 16 * jj)]);
        acc[0][jj][0] = fmaf(a.x, b.x, acc[0][jj][0]);
        acc[0][jj][1] = fmaf(a.x, b.y, acc[0][jj][1]);
        acc[1][jj][0] = fmaf(a.y, b.x, acc[1][jj][0]);
        acc[1][jj][1] = fmaf(a.y, b.y, acc[1][jj][1]);
        acc[2][jj][0] = fmaf(a.z, b.x, acc[2][jj][0]);
        acc[2][jj][1] = fmaf(a.z, b.y, acc[2][jj][1]);
        acc[3][jj][0] = fmaf(a.w, b.x, acc[3][jj][0]);
        acc[3][jj][1] = fmaf(a.w, b.y, acc[3][jj][1]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + 4 * ty + r;
    if (j >= nbatch) continue;
    const size_t base = (static_cast<size_t>(j) * N + m) * P + tx;
#pragma unroll
    for (int jj = 0; jj < PJ; ++jj) {
      g_re[base + 16 * jj] = acc[r][jj][0];
      g_im[base + 16 * jj] = acc[r][jj][1];
    }
  }
}

template <bool kMixed, int PJ>
cudaError_t launch(uint32_t k0, uint32_t k1, uint32_t stream_id, int draw0,
                   int nbatch, const float* S, const float* wr,
                   const float* wi, const float* pm_t, const float* sh_t,
                   float* g_re, float* g_im, float* out, int N, int K,
                   cudaStream_t stream) {
  const dim3 grid1((nbatch + kDT - 1) / kDT, N);
  colfac_pass1<kMixed, PJ><<<grid1, kThreads, 0, stream>>>(
      k0, k1, stream_id, draw0, nbatch, S, g_re, g_im, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  detect_pass<PJ><<<nbatch, kThreads, 0, stream>>>(wr, wi, g_re, g_im, pm_t,
                                                   sh_t, out, N);
  return cudaGetLastError();
}

template <bool kMixed>
cudaError_t dispatch(int P, uint32_t k0, uint32_t k1, uint32_t stream_id,
                     int draw0, int nbatch, const float* S, const float* wr,
                     const float* wi, const float* pm_t, const float* sh_t,
                     float* g_re, float* g_im, float* out, int N, int K,
                     cudaStream_t stream) {
#define FAST_CASE(PJ)                                                    \
  case PJ:                                                               \
    return launch<kMixed, PJ>(k0, k1, stream_id, draw0, nbatch, S, wr, wi, \
                              pm_t, sh_t, g_re, g_im, out, N, K, stream);
  switch (P / 16) {
    FAST_CASE(1)
    FAST_CASE(2)
    FAST_CASE(3)
    FAST_CASE(4)
    FAST_CASE(5)
    FAST_CASE(6)
    FAST_CASE(7)
    FAST_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef FAST_CASE
}

}  // namespace

// Shapes: S (N, K, P, 2) packed factors; wr, wi (P, N); pm_t (P, P);
// sh_t nullptr or (nbatch, 2, P, P) transposed subharmonic screens;
// g_re, g_im scratch (nbatch, N, P); out (nbatch, 4) = (sum pm cos h1,
// sum pm sin h1, sum pm cos h2, sum pm sin h2). P is a multiple of 16 and
// at most 128; K is 256 for 'mixed' noise (mixed != 0), else a multiple of
// 32 up to 256. Returns the cudaError_t of the launches (0 on success).
extern "C" int fast_colfac_detect(uint32_t k0, uint32_t k1,
                                  uint32_t stream_id, int draw0, int nbatch,
                                  const float* S, const float* wr,
                                  const float* wi, const float* pm_t,
                                  const float* sh_t, float* g_re,
                                  float* g_im, float* out, int N, int P,
                                  int K, int mixed, void* stream) {
  if (N <= 0 || N > 65535 || P % 16 != 0 || P < 16 || P > 128 ||
      nbatch <= 0 || K <= 0 || K % kKS != 0 || K > 2 * kLanes ||
      (mixed && K != 2 * kLanes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mixed)
    return static_cast<int>(dispatch<true>(P, k0, k1, stream_id, draw0, nbatch,
                                           S, wr, wi, pm_t, sh_t, g_re, g_im,
                                           out, N, K, st));
  return static_cast<int>(dispatch<false>(P, k0, k1, stream_id, draw0, nbatch,
                                          S, wr, wi, pm_t, sh_t, g_re, g_im,
                                          out, N, K, st));
}

extern "C" const char* fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
