// K4 / K5: AR(1)-in-Fourier frozen-flow coupling series, for Hopper (sm_90a).
//
// Replaces fast_tpu/ops/pallas_synth.py::_ar_flow_kernel (K4, the state
// resident on chip) and ::_ar_stream_kernel (K5, the state streamed from
// device memory in layer blocks), the TPU kernels behind TEMPORAL=True with
// TEMPORAL_SYNTH='ar'. Per time step t, layer l and Fourier mode e:
//
//   state  a_l <- a_l * ph_l             (ph = alpha e^{i kappa . v dt})
//   noise  a_l <- a_l + z * ns_l         (boiling only; ns = sqrt(1 -
//          alpha^2) sqrt(PSD) df; z 'uniform': (bits >> 8) sqrt(3) 2^-23 -
//          sqrt(3), or 'gauss': Box-Muller from 24-bit uniforms)
//   sum    A[t] = sum_l a_l              (N, N) complex, fixed layer order
//   DFT 1  G'[t] = A[t]^T W^T            (N, N) @ (N, P), complex
//   DFT 2  phi^T = Re(W G'[t])           (P, N) @ (N, P), real part only
//   detect sum(pm_t cos phi^T), sum(pm_t sin phi^T)
//
// so one step costs 8 P N^2 + 4 P^2 N FLOP in the two products (50 + 9
// MFLOP at N=256, P=96) against ~12 L N^2 in the recurrence (3 MFLOP at
// L=4): the products bound it, on the CUDA cores (fp32 FMA, no tensor cores
// in this first version).
//
// What the card changes. The TPU kernels walk time with a sequential grid
// and keep the (2, L N, N) state in VMEM. Here the recurrence is
// independent per mode, so time is tiled instead:
// * ar_update: one thread per mode. It holds the states, phasors and noise
//   scales of LB layers in registers, walks the tile's steps, writes the
//   layer sum A[t] for each and the state back once per tile. With LB = L
//   this is K4's counterpart (fast_ar_flow with lb = L: one read and one
//   write of the state per tile). With LB < L the host loops over layer
//   blocks and each block adds its layers into A[t] in turn, as
//   _ar_stream_kernel adds into its accumulator: K5's counterpart, for
//   profiles with more layers than fit in registers. The blocks run one
//   after the other on the stream, and every layer is added singly in
//   layer order, so both give the same A bit for bit.
// * ar_dft: one block per (step, 32 columns of A). The product with W^T is
//   tiled through shared memory by hand; each thread holds 2 columns x PJ
//   pupil pixels x (re, im). It writes G' in the layout of the iid
//   kernels' G' (N x P per step).
// * ar_detect: one block per step. The iid kernels' detect pass
//   (detect.cuh) without its imaginary half: the series is the real part
//   of the complex screen. Fixed-order block reduction, no atomics, so a
//   run is reproducible bit for bit on one card.
// A and G' go through device memory in tiles of `tile` steps (at most 134
// MB of A), which the wrapper sizes so that a tile has enough blocks for
// the card and stays near the L2 cache.
//
// Rounding. The update runs for thousands of steps before its sum passes
// through sin and cos, so it is written with __fmul_rn / __fadd_rn and the
// file is built with -fmad=false: no product-sum is contracted into an FMA
// except the explicit fmaf of the two DFT products. The plain torch version
// (fast_tpu_torch/ops/ar_flow.py) runs the same operations in the same
// order, so state and A agree with it bit for bit and only the products
// differ (sums in another order).
//
// Random bits. Philox4x32-10 keyed by the 64-bit seed (k0 = low word,
// k1 = high word). Counter of mode e = row * N + col of layer l at the
// absolute step s of the series:
//   ctr = (e, l, s, 2);  bits1 = out[0] (real part), bits2 = out[1].
// The absolute step makes a series cut into several calls the same series;
// the last word 2 keeps these streams apart from K2's (0) and K1's (1).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace fast;

constexpr int kKT = 32;   // depth tile of the first DFT product
constexpr int kCols = 32; // columns of A per ar_dft block
constexpr int kRR = 2;    // columns of A per ar_dft thread

// noise kinds
constexpr int kNone = 0, kUniform = 1, kGauss = 2;

// Advance LB layers of every mode by nsteps steps and add them into A.
// st_*, ph_*, ns: (L, N, N); a_*: (nsteps, N, N). accumulate: A already
// holds the sum of the layers below layer0.
template <int LB, int kNoise>
__global__ void __launch_bounds__(kThreads)
    ar_update(uint32_t k0, uint32_t k1, uint32_t step0, int nsteps, int layer0,
              int accumulate, float* __restrict__ st_re,
              float* __restrict__ st_im, const float* __restrict__ ph_re,
              const float* __restrict__ ph_im, const float* __restrict__ ns,
              float* __restrict__ a_re, float* __restrict__ a_im, int NN) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= NN) return;
  float sr[LB], si[LB], pr[LB], pi[LB], nz[LB];
#pragma unroll
  for (int l = 0; l < LB; ++l) {
    const size_t idx = static_cast<size_t>(layer0 + l) * NN + e;
    sr[l] = st_re[idx];
    si[l] = st_im[idx];
    pr[l] = ph_re[idx];
    pi[l] = ph_im[idx];
    nz[l] = kNoise != kNone ? ns[idx] : 0.0f;
  }
  for (int t = 0; t < nsteps; ++t) {
    const size_t ai = static_cast<size_t>(t) * NN + e;
    float sum_r = 0.0f, sum_i = 0.0f;
    if (accumulate) {
      sum_r = a_re[ai];
      sum_i = a_im[ai];
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      float nr = __fsub_rn(__fmul_rn(sr[l], pr[l]), __fmul_rn(si[l], pi[l]));
      float ni = __fadd_rn(__fmul_rn(sr[l], pi[l]), __fmul_rn(si[l], pr[l]));
      if (kNoise != kNone) {
        const U4 v = philox4x32_10(static_cast<uint32_t>(e),
                                   static_cast<uint32_t>(layer0 + l),
                                   step0 + static_cast<uint32_t>(t), 2u, k0,
                                   k1);
        float z1, z2;
        if (kNoise == kUniform) {
          z1 = mixed_uniform(v.x);
          z2 = mixed_uniform(v.y);
        } else {
          box_muller(v.x, v.y, &z1, &z2);
        }
        nr = __fadd_rn(nr, __fmul_rn(z1, nz[l]));
        ni = __fadd_rn(ni, __fmul_rn(z2, nz[l]));
      }
      sr[l] = nr;
      si[l] = ni;
      sum_r = __fadd_rn(sum_r, nr);
      sum_i = __fadd_rn(sum_i, ni);
    }
    a_re[ai] = sum_r;
    a_im[ai] = sum_i;
  }
#pragma unroll
  for (int l = 0; l < LB; ++l) {
    const size_t idx = static_cast<size_t>(layer0 + l) * NN + e;
    st_re[idx] = sr[l];
    st_im[idx] = si[l];
  }
}

// G'[t][m][p] = sum_k A[t][k][m] W[p][k], complex. One block per (step t,
// kCols columns m); thread (ty, tx) holds columns ty * kRR + {0, 1} and
// pupil pixels tx + 16 jj.
template <int PJ>
__global__ void __launch_bounds__(kThreads)
    ar_dft(const float* __restrict__ wr, const float* __restrict__ wi,
           const float* __restrict__ a_re, const float* __restrict__ a_im,
           float* __restrict__ g_re, float* __restrict__ g_im, int N) {
  constexpr int P = 16 * PJ;
  constexpr int WS = P + 1;
  __shared__ float xr[kKT * kCols], xi[kKT * kCols];
  __shared__ float swr[kKT * WS], swi[kKT * WS];

  const int t = blockIdx.x;
  const int m0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int r0 = (tid >> 4) * kRR;
  const float* ar = a_re + static_cast<size_t>(t) * N * N;
  const float* ai = a_im + static_cast<size_t>(t) * N * N;

  float acc_re[kRR][PJ], acc_im[kRR][PJ];
#pragma unroll
  for (int rr = 0; rr < kRR; ++rr)
#pragma unroll
    for (int jj = 0; jj < PJ; ++jj) acc_re[rr][jj] = acc_im[rr][jj] = 0.0f;

  for (int kb = 0; kb < N; kb += kKT) {
    __syncthreads();
    // rows of A and columns of W past N are zeros
    for (int e = tid; e < kKT * kCols; e += kThreads) {
      const int kk = e / kCols, mm = e - kk * kCols;
      const bool in = kb + kk < N && m0 + mm < N;
      const size_t idx = static_cast<size_t>(kb + kk) * N + m0 + mm;
      xr[e] = in ? ar[idx] : 0.0f;
      xi[e] = in ? ai[idx] : 0.0f;
    }
    for (int e = tid; e < P * kKT; e += kThreads) {
      const int p = e / kKT, kk = e - p * kKT;
      const bool in = kb + kk < N;
      swr[kk * WS + p] = in ? wr[static_cast<size_t>(p) * N + kb + kk] : 0.0f;
      swi[kk * WS + p] = in ? wi[static_cast<size_t>(p) * N + kb + kk] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKT; ++kk) {
      float x_r[kRR], x_i[kRR];
#pragma unroll
      for (int rr = 0; rr < kRR; ++rr) {
        x_r[rr] = xr[kk * kCols + r0 + rr];
        x_i[rr] = xi[kk * kCols + r0 + rr];
      }
#pragma unroll
      for (int jj = 0; jj < PJ; ++jj) {
        const float a = swr[kk * WS + tx + 16 * jj];
        const float b = swi[kk * WS + tx + 16 * jj];
#pragma unroll
        for (int rr = 0; rr < kRR; ++rr) {
          acc_re[rr][jj] = fmaf(x_r[rr], a, acc_re[rr][jj]);
          acc_re[rr][jj] = fmaf(-x_i[rr], b, acc_re[rr][jj]);
          acc_im[rr][jj] = fmaf(x_r[rr], b, acc_im[rr][jj]);
          acc_im[rr][jj] = fmaf(x_i[rr], a, acc_im[rr][jj]);
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRR; ++rr) {
    const int m = m0 + r0 + rr;
    if (m >= N) continue;
    const size_t base = (static_cast<size_t>(t) * N + m) * P + tx;
#pragma unroll
    for (int jj = 0; jj < PJ; ++jj) {
      g_re[base + 16 * jj] = acc_re[rr][jj];
      g_im[base + 16 * jj] = acc_im[rr][jj];
    }
  }
}

// The detect pass of detect.cuh for one real screen per step: h = Re(W G')
// (P x P, the transposed screen), then sum(pm_t cos h), sum(pm_t sin h) in
// a fixed order. g_re/g_im: (nsteps, N, P); out: (nsteps, 2).
template <int PJ>
__global__ void __launch_bounds__(kThreads)
    ar_detect(const float* __restrict__ wr, const float* __restrict__ wi,
              const float* __restrict__ g_re, const float* __restrict__ g_im,
              const float* __restrict__ pm_t, float* __restrict__ out, int N) {
  constexpr int P = 16 * PJ;
  constexpr int WS = P + 1;
  __shared__ float swr[kK2 * WS], swi[kK2 * WS];
  __shared__ float sgr[kK2 * P], sgi[kK2 * P];
  __shared__ float red[kThreads / 32][2];

  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* gr = g_re + static_cast<size_t>(j) * N * P;
  const float* gi = g_im + static_cast<size_t>(j) * N * P;

  float hr[PJ][PJ];
#pragma unroll
  for (int a = 0; a < PJ; ++a)
#pragma unroll
    for (int b = 0; b < PJ; ++b) hr[a][b] = 0.0f;

  for (int kb = 0; kb < N; kb += kK2) {
    __syncthreads();
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
        }
    }
  }

  float acc[2] = {0.f, 0.f};
#pragma unroll
  for (int a = 0; a < PJ; ++a)
#pragma unroll
    for (int b = 0; b < PJ; ++b) {
      const float w = pm_t[(ty + 16 * a) * P + tx + 16 * b];
      float s, c;
      sincos_cw(hr[a][b], &s, &c);
      acc[0] = fmaf(w, c, acc[0]);
      acc[1] = fmaf(w, s, acc[1]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  if ((tid & 31) == 0) {
    red[tid >> 5][0] = acc[0];
    red[tid >> 5][1] = acc[1];
  }
  __syncthreads();
  if (tid < 2) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][tid];
    out[static_cast<size_t>(j) * 2 + tid] = s;
  }
}

struct UpdateArgs {
  uint32_t k0, k1, step0;
  int nsteps, layer0, accumulate;
  float *st_re, *st_im;
  const float *ph_re, *ph_im, *ns;
  float *a_re, *a_im;
  int NN;
  cudaStream_t stream;
};

template <int LB, int kNoise>
cudaError_t launch_update(const UpdateArgs& u) {
  ar_update<LB, kNoise><<<(u.NN + kThreads - 1) / kThreads, kThreads, 0,
                          u.stream>>>(u.k0, u.k1, u.step0, u.nsteps, u.layer0,
                                      u.accumulate, u.st_re, u.st_im, u.ph_re,
                                      u.ph_im, u.ns, u.a_re, u.a_im, u.NN);
  return cudaGetLastError();
}

template <int LB>
cudaError_t update_noise(int noise, const UpdateArgs& u) {
  switch (noise) {
    case kNone:
      return launch_update<LB, kNone>(u);
    case kUniform:
      return launch_update<LB, kUniform>(u);
    case kGauss:
      return launch_update<LB, kGauss>(u);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t update_layers(int lb, int noise, const UpdateArgs& u) {
#define FAST_CASE(LB) \
  case LB:            \
    return update_noise<LB>(noise, u);
  switch (lb) {
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

template <int PJ>
cudaError_t launch_products(int nsteps, const float* wr, const float* wi,
                            const float* pm_t, const float* a_re,
                            const float* a_im, float* g_re, float* g_im,
                            float* out, int N, cudaStream_t stream) {
  ar_dft<PJ><<<dim3(nsteps, (N + kCols - 1) / kCols), kThreads, 0, stream>>>(
      wr, wi, a_re, a_im, g_re, g_im, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ar_detect<PJ><<<nsteps, kThreads, 0, stream>>>(wr, wi, g_re, g_im, pm_t, out,
                                                 N);
  return cudaGetLastError();
}

cudaError_t products(int P, int nsteps, const float* wr, const float* wi,
                     const float* pm_t, const float* a_re, const float* a_im,
                     float* g_re, float* g_im, float* out, int N,
                     cudaStream_t stream) {
#define FAST_CASE(PJ)                                                       \
  case PJ:                                                                  \
    return launch_products<PJ>(nsteps, wr, wi, pm_t, a_re, a_im, g_re, g_im, \
                               out, N, stream);
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

// One call advances the series by nsteps steps from the absolute step
// step0. Shapes: st_re, st_im (L, N, N), the state, updated in place;
// ph_re, ph_im (L, N, N); ns (L, N, N), read only with noise != 0; wr, wi
// (P, N); pm_t (P, P), the transposed pupil * mode; scratch a_re, a_im
// (tile, N, N) and g_re, g_im (tile, N, P); out (nsteps, 2) = (sum pm cos
// phi, sum pm sin phi) per step. lb: layers per thread of the update pass,
// 1..8; lb >= L is K4's counterpart (every layer in one pass), lb < L
// K5's (layer blocks in turn). noise: 0 none, 1 'uniform', 2 'gauss'. P
// must be a multiple of 16 and at most 128. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int fast_ar_flow(uint32_t k0, uint32_t k1, uint32_t step0,
                            int nsteps, int tile, int L, int lb, int noise,
                            float* st_re, float* st_im, const float* ph_re,
                            const float* ph_im, const float* ns,
                            const float* wr, const float* wi,
                            const float* pm_t, float* a_re, float* a_im,
                            float* g_re, float* g_im, float* out, int N, int P,
                            void* stream) {
  if (N <= 0 || N > 32768 || P % 16 != 0 || P < 16 || P > 128 ||
      nsteps <= 0 || tile <= 0 || L <= 0 || lb < 1 || lb > 8 || noise < 0 ||
      noise > 2 || (noise != 0 && ns == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int t0 = 0; t0 < nsteps; t0 += tile) {
    const int nt = nsteps - t0 < tile ? nsteps - t0 : tile;
    for (int l0 = 0; l0 < L; l0 += lb) {
      const UpdateArgs u = {k0,    k1,    step0 + static_cast<uint32_t>(t0),
                            nt,    l0,    l0 > 0,
                            st_re, st_im, ph_re,
                            ph_im, ns,    a_re,
                            a_im,  N * N, st};
      const cudaError_t err = update_layers(L - l0 < lb ? L - l0 : lb, noise, u);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const cudaError_t err =
        products(P, nt, wr, wi, pm_t, a_re, a_im, g_re, g_im,
                 out + static_cast<size_t>(t0) * 2, N, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
