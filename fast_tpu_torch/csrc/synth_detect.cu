// K2: fused noise synthesis and pupil-overlap detection, for Hopper (sm_90a).
//
// Replaces fast_tpu/ops/pallas_synth.py::_synth_detect_kernel, the TPU
// kernel behind SYNTH='pallas_fused'. Per complex draw j it computes, in the
// transposed formulation of that kernel:
//
//   bits   two 32-bit words per grid point from Philox4x32-10
//   noise  'mixed': u = (bits >> 8) * sqrt(3) 2^-23 - sqrt(3), z = u @ M
//          'gauss': Box-Muller from 24-bit uniforms
//   colour X' = z * s_t                       (s_t = sqrt(PSD)^T * df)
//   DFT 1  G' = X' W^T                        (N, N) @ (N, P), complex
//   DFT 2  H  = W G'                          (P, N) @ (N, P), complex
//   detect sum(pm_t * cos/sin(Re H)), sum(pm_t * cos/sin(Im H))
//
// What bounds it on the card: arithmetic on the CUDA cores. At N=256, P=82
// (padded to 96) one complex draw costs 4N^3 = 67 MFLOP of mixing product,
// 8N^2 P = 50 MFLOP for G' and 8 P^2 N = 19 MFLOP for H, against 64 KB of
// random bits that never leave the SM and 2 x 96 KB of G'. The fp32
// products are tiled through shared memory by hand; this first version
// uses no tensor cores, and its inner loops are bound by shared-memory
// bandwidth (6 loads per 8 FMAs in the mixing product).
//
// What the design does about it:
// * The (N, N) noise never reaches device memory: pass 1 keeps a block of
//   16 * RR rows of one draw's uniforms in shared memory, mixes, colours
//   and contracts it with W^T tile by tile, and writes only G' (N x P).
//   RR (rows per thread) is 2, or 1 where a grid is too wide for 32 rows
//   of uniforms to fit in shared memory.
// * The two noise components go through one after the other, so the
//   uniforms of only one component occupy shared memory (2 blocks per SM
//   at 256^2); G's real and imaginary parts take sign-swapped W tiles.
// * Any grid side N: tiles are padded to NC = N rounded up to 64 with
//   zeros (uniforms, mixing matrix, W columns), so the padding adds nothing
//   to a sum; the Philox counters use the true N.
// * Pass 2 is one block per draw: H = W G', then sincos and a fixed-order
//   block reduction, so the result is the same from run to run (no
//   atomics). The TPU kernel's k-draw batching has no counterpart here:
//   blocks run in parallel on 132 SMs instead.
//
// Random bits. Philox4x32-10 (Salmon et al., SC'11) keyed by the 64-bit
// seed (k0 = low word, k1 = high word). Counter layout, one call per grid
// point of X' (row-major element index e = row * N + col):
//   ctr = (e, draw index, stream, 0);  bits1 = out[0], bits2 = out[1].
// The plain torch version in fast_tpu_torch/ops/synth_detect.py builds the
// same counters, so kernel and plain version see identical noise.
//
// sincos is the Cody-Waite reduction with the cephes polynomials of the
// TPU kernel's _sincos, accurate to 2e-7 for |phi| <= 4096. The build uses
// no fast-math flags.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;    // column tile of X'
constexpr int kKT = 32;   // depth tile of the mixing product
constexpr int kK2 = 16;   // depth tile of pass 2

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

// Pass 1: one block per (draw, 16 * RR rows of X'). Writes G' rows.
// At least two blocks per SM: without the bound ptxas keeps the 'mixed'
// pass to 64 registers and runs it ~20% slower at 256^2 (H100).
template <bool kMixed, int PJ, int RR>
__global__ void __launch_bounds__(kThreads, 2)
    synth_pass1(uint32_t k0, uint32_t k1, uint32_t stream, int draw0,
                const float* __restrict__ s_t, const float* __restrict__ wr,
                const float* __restrict__ wi, const float* __restrict__ mix,
                float* __restrict__ g_re, float* __restrict__ g_im, int N) {
  constexpr int P = 16 * PJ;   // padded pupil width
  constexpr int R = 16 * RR;   // rows of X' per block
  constexpr int WS = P + 1;    // shared row stride of the W tiles
  constexpr int XS = kC + 1;   // shared row stride of the x tile
  const int NC = (N + kC - 1) / kC * kC;  // grid side padded to the tiles
  const int US = NC + 1;       // shared row stride of the uniforms
  extern __shared__ float smem[];
  float* xs = smem;                 // R x XS
  float* wa = xs + R * XS;          // kC x WS
  float* wb = wa + kC * WS;         // kC x WS
  float* ms = wb + kC * WS;         // kKT x kC   (mixed only)
  float* us = ms + kKT * kC;        // R x US     (mixed only)

  const int j = blockIdx.x;
  const uint32_t draw = static_cast<uint32_t>(draw0 + j);
  const int row0 = blockIdx.y * R;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int r0 = (tid >> 4) * RR;

  float acc_re[RR][PJ], acc_im[RR][PJ];
#pragma unroll
  for (int rr = 0; rr < RR; ++rr)
#pragma unroll
    for (int jj = 0; jj < PJ; ++jj) acc_re[rr][jj] = acc_im[rr][jj] = 0.0f;

  for (int comp = 0; comp < 2; ++comp) {
    if (kMixed) {
      // the previous component's last tile ended in __syncthreads()
      for (int e = tid; e < R * NC; e += kThreads) {
        const int r = e / NC, c = e - r * NC;
        float u = 0.0f;
        if (row0 + r < N && c < N) {
          const U4 v = philox4x32_10(
              static_cast<uint32_t>((row0 + r) * N + c), draw, stream, 0u,
              k0, k1);
          const uint32_t bits = comp == 0 ? v.x : v.y;
          u = __fadd_rn(__fmul_rn(static_cast<float>(bits >> 8), kS3Scale),
                        -kS3);
        }
        us[r * US + c] = u;
      }
    }
    for (int c0 = 0; c0 < NC; c0 += kC) {
      if (kMixed) {
        float z[RR][4];
#pragma unroll
        for (int rr = 0; rr < RR; ++rr)
#pragma unroll
          for (int q = 0; q < 4; ++q) z[rr][q] = 0.0f;
        for (int kb = 0; kb < NC; kb += kKT) {
          __syncthreads();
          for (int e = tid; e < kKT * kC; e += kThreads) {
            const int kk = e / kC, cc = e - kk * kC;
            ms[e] = (kb + kk < N && c0 + cc < N)
                        ? mix[static_cast<size_t>(kb + kk) * N + c0 + cc]
                        : 0.0f;
          }
          __syncthreads();
#pragma unroll 8
          for (int kk = 0; kk < kKT; ++kk) {
            float a[RR];
#pragma unroll
            for (int rr = 0; rr < RR; ++rr)
              a[rr] = us[(r0 + rr) * US + kb + kk];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float b = ms[kk * kC + tx + 16 * q];
#pragma unroll
              for (int rr = 0; rr < RR; ++rr)
                z[rr][q] = fmaf(a[rr], b, z[rr][q]);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < RR; ++rr)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = row0 + r0 + rr, col = c0 + tx + 16 * q;
            xs[(r0 + rr) * XS + tx + 16 * q] =
                (row < N && col < N)
                    ? z[rr][q] * s_t[static_cast<size_t>(row) * N + col]
                    : 0.0f;
          }
      } else {
        for (int e = tid; e < R * kC; e += kThreads) {
          const int r = e / kC, cc = e - r * kC;
          const int row = row0 + r, col = c0 + cc;
          float x = 0.0f;
          if (row < N && col < N) {
            const U4 v = philox4x32_10(static_cast<uint32_t>(row * N + col),
                                       draw, stream, 0u, k0, k1);
            const float u1 = __fadd_rn(
                __fmul_rn(static_cast<float>(v.x >> 8), kTwoM24), kTwoM25);
            const float u2 = __fmul_rn(static_cast<float>(v.y >> 8), kTwoM24);
            const float rad = sqrtf(-2.0f * logf(u1));
            float st, ct;
            sincos_cw(kTwoPi * u2, &st, &ct);
            const float zc = comp == 0 ? rad * ct : rad * st;
            x = zc * s_t[static_cast<size_t>(row) * N + col];
          }
          xs[r * XS + cc] = x;
        }
      }
      // comp 0 (x = xr): gr += x wr^T, gi += x wi^T
      // comp 1 (x = xi): gr -= x wi^T, gi += x wr^T
      for (int e = tid; e < P * kC; e += kThreads) {
        const int p = e / kC, cc = e - p * kC;
        float vr = 0.0f, vi = 0.0f;
        if (c0 + cc < N) {
          vr = wr[static_cast<size_t>(p) * N + c0 + cc];
          vi = wi[static_cast<size_t>(p) * N + c0 + cc];
        }
        wa[cc * WS + p] = comp == 0 ? vr : -vi;
        wb[cc * WS + p] = comp == 0 ? vi : vr;
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < kC; ++cc) {
        float x[RR];
#pragma unroll
        for (int rr = 0; rr < RR; ++rr) x[rr] = xs[(r0 + rr) * XS + cc];
#pragma unroll
        for (int jj = 0; jj < PJ; ++jj) {
          const float a = wa[cc * WS + tx + 16 * jj];
          const float b = wb[cc * WS + tx + 16 * jj];
#pragma unroll
          for (int rr = 0; rr < RR; ++rr) {
            acc_re[rr][jj] = fmaf(x[rr], a, acc_re[rr][jj]);
            acc_im[rr][jj] = fmaf(x[rr], b, acc_im[rr][jj]);
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int rr = 0; rr < RR; ++rr) {
    if (row0 + r0 + rr >= N) continue;
    const size_t base =
        (static_cast<size_t>(j) * N + row0 + r0 + rr) * P + tx;
#pragma unroll
    for (int jj = 0; jj < PJ; ++jj) {
      g_re[base + 16 * jj] = acc_re[rr][jj];
      g_im[base + 16 * jj] = acc_im[rr][jj];
    }
  }
}

// Pass 2: one block per draw. H = W G', sincos, weighted sums.
template <int PJ>
__global__ void __launch_bounds__(kThreads)
    synth_pass2(const float* __restrict__ wr, const float* __restrict__ wi,
                const float* __restrict__ g_re, const float* __restrict__ g_im,
                const float* __restrict__ pm_t, float* __restrict__ out,
                int N) {
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

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int a = 0; a < PJ; ++a)
#pragma unroll
    for (int b = 0; b < PJ; ++b) {
      const float w = pm_t[(ty + 16 * a) * P + tx + 16 * b];
      float s, c;
      sincos_cw(hr[a][b], &s, &c);
      acc[0] = fmaf(w, c, acc[0]);
      acc[1] = fmaf(w, s, acc[1]);
      sincos_cw(hi[a][b], &s, &c);
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

// Dynamic shared memory of pass 1. Must match _smem_bytes in
// fast_tpu_torch/ops/synth_detect.py, which picks RR and decides which
// shapes the wrapper takes.
template <bool kMixed>
size_t pass1_smem(int N, int P, int RR) {
  const int NC = (N + kC - 1) / kC * kC;
  const int R = 16 * RR;
  return sizeof(float) * (R * (kC + 1) + 2 * kC * (P + 1) +
                          (kMixed ? kKT * kC + R * (NC + 1) : 0));
}

template <bool kMixed, int PJ, int RR>
cudaError_t launch(uint32_t k0, uint32_t k1, uint32_t stream_id, int draw0,
                   int nbatch, const float* s_t, const float* wr,
                   const float* wi, const float* pm_t, const float* mix,
                   float* g_re, float* g_im, float* out, int N,
                   cudaStream_t stream) {
  constexpr int P = 16 * PJ;
  const size_t smem = pass1_smem<kMixed>(N, P, RR);
  auto* k_pass1 = synth_pass1<kMixed, PJ, RR>;
  cudaError_t err = cudaFuncSetAttribute(
      k_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int row_blocks = (N + 16 * RR - 1) / (16 * RR);
  k_pass1<<<dim3(nbatch, row_blocks), kThreads, smem, stream>>>(
      k0, k1, stream_id, draw0, s_t, wr, wi, mix, g_re, g_im, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  synth_pass2<PJ><<<nbatch, kThreads, 0, stream>>>(wr, wi, g_re, g_im, pm_t,
                                                   out, N);
  return cudaGetLastError();
}

template <bool kMixed, int RR>
cudaError_t dispatch(int P, uint32_t k0, uint32_t k1, uint32_t stream_id,
                     int draw0, int nbatch, const float* s_t, const float* wr,
                     const float* wi, const float* pm_t, const float* mix,
                     float* g_re, float* g_im, float* out, int N,
                     cudaStream_t stream) {
#define FAST_CASE(PJ)                                                       \
  case PJ:                                                                  \
    return launch<kMixed, PJ, RR>(k0, k1, stream_id, draw0, nbatch, s_t, wr, \
                                  wi, pm_t, mix, g_re, g_im, out, N, stream);
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

__global__ void sincos_kernel(const float* __restrict__ phi,
                              float* __restrict__ s, float* __restrict__ c,
                              int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) sincos_cw(phi[i], s + i, c + i);
}

}  // namespace

// Shapes: s_t, mix (N, N); wr, wi (P, N); pm_t (P, P); g_re, g_im scratch
// (nbatch, N, P); out (nbatch, 4) = (sum pm cos h1, sum pm sin h1,
// sum pm cos h2, sum pm sin h2). mix == nullptr selects 'gauss' noise.
// P must be a multiple of 16 and at most 128. rows (RR) is 1 or 2 for
// 'mixed' noise, whose pass-1 shared memory at (N, P, rows) must fit the
// card; 'gauss' keeps no uniforms in shared memory and always takes 2.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int fast_synth_detect(uint32_t k0, uint32_t k1, uint32_t stream_id,
                                 int draw0, int nbatch, const float* s_t,
                                 const float* wr, const float* wi,
                                 const float* pm_t, const float* mix,
                                 float* g_re, float* g_im, float* out, int N,
                                 int P, int rows, void* stream) {
  if (N <= 0 || P % 16 != 0 || P < 16 || P > 128 || nbatch <= 0 ||
      (rows != 1 && rows != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mix != nullptr) {
    if (rows == 2)
      return static_cast<int>(dispatch<true, 2>(P, k0, k1, stream_id, draw0,
                                                nbatch, s_t, wr, wi, pm_t, mix,
                                                g_re, g_im, out, N, st));
    return static_cast<int>(dispatch<true, 1>(P, k0, k1, stream_id, draw0,
                                              nbatch, s_t, wr, wi, pm_t, mix,
                                              g_re, g_im, out, N, st));
  }
  return static_cast<int>(dispatch<false, 2>(P, k0, k1, stream_id, draw0,
                                             nbatch, s_t, wr, wi, pm_t, mix,
                                             g_re, g_im, out, N, st));
}

// The kernel's sincos on its own, for accuracy checks against float64.
extern "C" int fast_sincos(const float* phi, float* s, float* c, int n,
                           void* stream) {
  if (n <= 0) return 0;
  sincos_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      phi, s, c, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
