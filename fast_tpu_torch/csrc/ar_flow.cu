// K4 / K5 / K6: AR(1)-in-Fourier frozen-flow coupling series, for Hopper
// (sm_90a).
//
// Replaces fast_tpu/ops/pallas_synth.py::_ar_flow_kernel (K4, the state
// resident on chip), ::_ar_stream_kernel (K5, the state streamed from
// device memory in layer blocks) and ::_ar_flow_kernel_batch (K6, B
// independent series that share W, one per orbit sample of a temporal
// parameter scan), the TPU kernels behind TEMPORAL=True with
// TEMPORAL_SYNTH='ar' and behind the temporal AR scan. Per time step t,
// series s, layer l and Fourier mode e:
//
//   state  a_sl <- a_sl * ph_sl          (ph = alpha e^{i kappa . v dt})
//   noise  a_sl <- a_sl + z * ns_sl      (boiling only; ns = sqrt(1 -
//          alpha^2) sqrt(PSD) df; z 'uniform': (bits >> 8) sqrt(3) 2^-23 -
//          sqrt(3), or 'gauss': Box-Muller from 24-bit uniforms)
//   sum    A[t, s] = sum_l a_sl          (N, N) complex, fixed layer order
//   DFT 1  G'[t, s] = A[t, s]^T W^T      (N, N) @ (N, P), complex
//   DFT 2  phi^T = Re(W G'[t, s])        (P, N) @ (N, P), real part only
//   detect sum(pm_s cos phi^T), sum(pm_s sin phi^T)
//
// so one step of one series costs 8 P N^2 + 4 P^2 N FLOP in the two
// products (50 + 9 MFLOP at N=256, P=96) against ~12 L N^2 in the
// recurrence (3 MFLOP at L=4): the products bound it, on the CUDA cores
// (fp32 FMA, no tensor cores in this first version). K4 and K5 are the
// case B = 1 of the same passes.
//
// What the card changes. The TPU kernels walk time with a sequential grid
// and keep the (2, B L N, N) state in VMEM. Here the recurrence is
// independent per mode, so time is tiled instead:
// * ar_update: one thread per (mode, series). It holds the states, phasors
//   and noise scales of LB layers in registers, walks the tile's steps,
//   writes the layer sum A[t, s] for each and the state back once per
//   tile. With LB = L this is K4's counterpart (one read and one write of
//   the state per tile). With LB < L the host loops over layer blocks and
//   each block adds its layers into A[t, s] in turn, as _ar_stream_kernel
//   adds into its accumulator: K5's counterpart, for profiles with more
//   layers than fit in registers. The blocks run one after the other on
//   the stream, and every layer is added singly in layer order, so both
//   give the same A bit for bit. K6 is the same pass with a grid axis of
//   B series (the state series-major: (B, L, N, N)).
// * ar_dft: one block per ((step, series), 32 columns of A, pupil column
//   group). The product with W^T is tiled through shared memory by hand;
//   each thread holds 2 columns x PJ pupil pixels x (re, im) of one group.
//   A pupil of up to 128 px (padded to P = 16 PJ) is one group; a wider
//   one is cut as the detect pass of detect.cuh cuts it, T = ceil(P / 128)
//   groups of width 16 ceil(P / 16 / T), the last ragged and masked. It
//   writes G' in the layout of the iid kernels' G' (N x P per step and
//   series).
// * ar_detect: one block per ((step, series), pupil tile) with each
//   series' own pupil * mode. The iid kernels' detect pass (detect.cuh)
//   without its imaginary half: the series is the real part of the
//   complex screen. One tile (a pupil of up to 128 px) writes the step's
//   two sums itself; T x T tiles write partial sums that ar_sum_tiles adds
//   in tile order. Fixed-order reductions, no atomics, so a run is
//   reproducible bit for bit on one card.
// A and G' go through device memory in tiles of `tile` steps of all B
// series, which the wrapper sizes so that a tile has enough blocks for the
// card and A and G' stay bounded (at most 134 MB of A, 2 GiB of G').
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
// k1 = high word). Counter of mode e = row * N + col of layer l of series
// s at the absolute step t of the series:
//   ctr = (e, s * L + l, t, 2);  bits1 = out[0] (real part), bits2 = out[1].
// The series-major row s * L + l is the TPU kernel's row order, and makes
// series 0 of a batch the single series of K4 from the same seed. The
// absolute step makes a series cut into several calls the same series;
// the last word 2 keeps these streams apart from K2's (0), K1's (1) and
// K3's (3).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "detect.cuh"

namespace {

using namespace fast;

constexpr int kKT = 32;   // depth tile of the first DFT product
constexpr int kCols = 32; // columns of A per ar_dft block
constexpr int kRR = 2;    // columns of A per ar_dft thread

// noise kinds
constexpr int kNone = 0, kUniform = 1, kGauss = 2;

// Advance LB layers of every mode of series s = blockIdx.y (of B =
// gridDim.y) by nsteps steps and add them into A. st_*, ph_*, ns: (B, L,
// N, N); a_*: (nsteps, B, N, N). accumulate: A already holds the sum of
// the layers below layer0.
template <int LB, int kNoise>
__global__ void __launch_bounds__(kThreads)
    ar_update(uint32_t k0, uint32_t k1, uint32_t step0, int nsteps, int L,
              int layer0, int accumulate, float* __restrict__ st_re,
              float* __restrict__ st_im, const float* __restrict__ ph_re,
              const float* __restrict__ ph_im, const float* __restrict__ ns,
              float* __restrict__ a_re, float* __restrict__ a_im, int NN) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= NN) return;
  const int s = blockIdx.y, B = gridDim.y;
  // the state row of the block's first layer, and its Philox counter word
  const int row0 = s * L + layer0;
  float sr[LB], si[LB], pr[LB], pi[LB], nz[LB];
#pragma unroll
  for (int l = 0; l < LB; ++l) {
    const size_t idx = static_cast<size_t>(row0 + l) * NN + e;
    sr[l] = st_re[idx];
    si[l] = st_im[idx];
    pr[l] = ph_re[idx];
    pi[l] = ph_im[idx];
    nz[l] = kNoise != kNone ? ns[idx] : 0.0f;
  }
  for (int t = 0; t < nsteps; ++t) {
    const size_t ai = (static_cast<size_t>(t) * B + s) * NN + e;
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
                                   static_cast<uint32_t>(row0 + l),
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
    const size_t idx = static_cast<size_t>(row0 + l) * NN + e;
    st_re[idx] = sr[l];
    st_im[idx] = si[l];
  }
}

// G'[j][m][p] = sum_k A[j][k][m] W[p][k], complex, for j = (step, series).
// One block per (j, kCols columns m, pupil column group g = blockIdx.z of
// width 16 PJ); thread (ty, tx) holds columns ty * kRR + {0, 1} and pupil
// pixels p0 + tx + 16 jj. Rows of W past P read as zeros and G' is written
// only below P. kOne: the group is the whole pupil, P = 16 PJ, known to the
// compiler.
template <int PJ, bool kOne>
__global__ void __launch_bounds__(kThreads)
    ar_dft(const float* __restrict__ wr, const float* __restrict__ wi,
           const float* __restrict__ a_re, const float* __restrict__ a_im,
           float* __restrict__ g_re, float* __restrict__ g_im, int N,
           int P_rt) {
  constexpr int GW = 16 * PJ;
  constexpr int WS = GW + 1;
  __shared__ float xr[kKT * kCols], xi[kKT * kCols];
  __shared__ float swr[kKT * WS], swi[kKT * WS];

  const int P = kOne ? GW : P_rt;
  const int p0 = kOne ? 0 : blockIdx.z * GW;
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
    for (int e = tid; e < GW * kKT; e += kThreads) {
      const int p = e / kKT, kk = e - p * kKT;
      const bool in = kb + kk < N && (kOne || p0 + p < P);
      const size_t at = static_cast<size_t>(p0 + p) * N + kb + kk;
      swr[kk * WS + p] = in ? wr[at] : 0.0f;
      swi[kk * WS + p] = in ? wi[at] : 0.0f;
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
    const size_t base = (static_cast<size_t>(t) * N + m) * P + p0 + tx;
#pragma unroll
    for (int jj = 0; jj < PJ; ++jj) {
      if (!kOne && p0 + tx + 16 * jj >= P) continue;
      g_re[base + 16 * jj] = acc_re[rr][jj];
      g_im[base + 16 * jj] = acc_im[rr][jj];
    }
  }
}

// The detect pass of detect.cuh for one real screen per (step, series) j =
// blockIdx.x: h = Re(W G') (P x P, the transposed screen) on the (16 PJ x
// 16 PJ) tile blockIdx.y of T x T, then sum(pm_t cos h), sum(pm_t sin h)
// over the tile in a fixed order, with pm_t the pupil * mode of series j %
// B. g_re/g_im: (nj, N, P); pm_t: (B, P, P); out: (nj, T * T, 2), the
// tile's sums (the step's own where T = 1).
template <int PJ, bool kOne>
__global__ void __launch_bounds__(kThreads)
    ar_detect(const float* __restrict__ wr, const float* __restrict__ wi,
              const float* __restrict__ g_re, const float* __restrict__ g_im,
              const float* __restrict__ pm_t, float* __restrict__ out, int N,
              int P_rt, int T, int B) {
  constexpr int TP = 16 * PJ;
  constexpr int WS = TP + 1;
  __shared__ float swr[kK2 * WS], swi[kK2 * WS];
  __shared__ float sgr[kK2 * TP], sgi[kK2 * TP];
  __shared__ float red[kThreads / 32][2];

  const int P = kOne ? TP : P_rt;
  const int j = blockIdx.x;
  const int tile = kOne ? 0 : blockIdx.y;
  const int r0 = kOne ? 0 : tile / T * TP, c0 = kOne ? 0 : tile % T * TP;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* gr = g_re + static_cast<size_t>(j) * N * P;
  const float* gi = g_im + static_cast<size_t>(j) * N * P;
  const float* pm = pm_t + static_cast<size_t>(j % B) * P * P;

  float hr[PJ][PJ];
#pragma unroll
  for (int a = 0; a < PJ; ++a)
#pragma unroll
    for (int b = 0; b < PJ; ++b) hr[a][b] = 0.0f;

  for (int kb = 0; kb < N; kb += kK2) {
    __syncthreads();
    for (int e = tid; e < TP * kK2; e += kThreads) {
      const int p = e / kK2, kk = e - p * kK2;
      const bool in = kb + kk < N && (kOne || r0 + p < P);
      const size_t at = static_cast<size_t>(r0 + p) * N + kb + kk;
      swr[kk * WS + p] = in ? wr[at] : 0.0f;
      swi[kk * WS + p] = in ? wi[at] : 0.0f;
    }
    for (int e = tid; e < kK2 * TP; e += kThreads) {
      const int kk = e / TP, pp = e - kk * TP;
      const bool in = kb + kk < N && (kOne || c0 + pp < P);
      const size_t at = static_cast<size_t>(kb + kk) * P + c0 + pp;
      sgr[e] = in ? gr[at] : 0.0f;
      sgi[e] = in ? gi[at] : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kK2; ++kk) {
      float ar[PJ], ai[PJ], br[PJ], bi[PJ];
#pragma unroll
      for (int a = 0; a < PJ; ++a) {
        ar[a] = swr[kk * WS + ty + 16 * a];
        ai[a] = swi[kk * WS + ty + 16 * a];
        br[a] = sgr[kk * TP + tx + 16 * a];
        bi[a] = sgi[kk * TP + tx + 16 * a];
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
      const int p1 = r0 + ty + 16 * a, p2 = c0 + tx + 16 * b;
      if (!kOne && (p1 >= P || p2 >= P)) continue;
      const float w = pm[p1 * P + p2];
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
    out[(static_cast<size_t>(j) * gridDim.y + tile) * 2 + tid] = s;
  }
}

// out[j][c] = sum over the tiles, in tile order, of part[j][tile][c].
__global__ void ar_sum_tiles(const float* __restrict__ part,
                             float* __restrict__ out, int n2, int ntiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const float* p = part + static_cast<size_t>(i >> 1) * ntiles * 2 + (i & 1);
  float s = 0.0f;
  for (int t = 0; t < ntiles; ++t) s += p[2 * t];
  out[i] = s;
}

struct UpdateArgs {
  uint32_t k0, k1, step0;
  int nsteps, L, layer0, accumulate;
  float *st_re, *st_im;
  const float *ph_re, *ph_im, *ns;
  float *a_re, *a_im;
  int NN, B;
  cudaStream_t stream;
};

template <int LB, int kNoise>
cudaError_t launch_update(const UpdateArgs& u) {
  const dim3 grid((u.NN + kThreads - 1) / kThreads, u.B);
  ar_update<LB, kNoise><<<grid, kThreads, 0, u.stream>>>(
      u.k0, u.k1, u.step0, u.nsteps, u.L, u.layer0, u.accumulate, u.st_re,
      u.st_im, u.ph_re, u.ph_im, u.ns, u.a_re, u.a_im, u.NN);
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

// The two products and the detect pass of nj = (steps x B series) layer
// sums: G' into g_re/g_im (nj, N, P), the sums into out (nj, 2), through
// part (nj, T * T, 2) for a pupil over 128 px.
cudaError_t products(int P, int nj, int B, const float* wr, const float* wi,
                     const float* pm_t, const float* a_re, const float* a_im,
                     float* g_re, float* g_im, float* part, float* out, int N,
                     cudaStream_t stream) {
  const PupilTiles t = pupil_tiles(P);
  const dim3 gd(nj, (N + kCols - 1) / kCols, t.T);
#define FAST_DFT(PJ, ONE)                                                \
  ar_dft<PJ, ONE><<<gd, kThreads, 0, stream>>>(wr, wi, a_re, a_im, g_re, \
                                               g_im, N, P)
  FAST_TILE_SWITCH(t, FAST_DFT)
#undef FAST_DFT
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gt(nj, t.T * t.T);
  float* sums = t.T == 1 ? out : part;
#define FAST_DETECT(PJ, ONE)                         \
  ar_detect<PJ, ONE><<<gt, kThreads, 0, stream>>>(   \
      wr, wi, g_re, g_im, pm_t, sums, N, P, t.T, B)
  FAST_TILE_SWITCH(t, FAST_DETECT)
#undef FAST_DETECT
  err = cudaGetLastError();
  if (err != cudaSuccess || t.T == 1) return err;
  ar_sum_tiles<<<(2 * nj + 255) / 256, 256, 0, stream>>>(part, out, 2 * nj,
                                                         t.T * t.T);
  return cudaGetLastError();
}

}  // namespace

// One call advances B series by nsteps steps from the absolute step
// step0. Shapes: st_re, st_im (B, L, N, N), the states, updated in place;
// ph_re, ph_im (B, L, N, N); ns (B, L, N, N), read only with noise != 0;
// wr, wi (P, N), shared; pm_t (B, P, P), each series' transposed pupil *
// mode; scratch a_re, a_im (tile * B, N, N), g_re, g_im (tile * B, N, P)
// and, for a pupil over 128 px, part (tile * B, T * T, 2) with T =
// ceil(P / 128) (else unused, may be null); out (nsteps, B, 2) = (sum pm
// cos phi, sum pm sin phi) per step and series. lb: layers per thread of
// the update pass, 1..8; lb >= L is K4's counterpart (every layer in one
// pass), lb < L K5's (layer blocks in turn); B > 1 is K6's. noise: 0 none,
// 1 'uniform', 2 'gauss'. P must be a multiple of 16. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int fast_ar_flow(uint32_t k0, uint32_t k1, uint32_t step0,
                            int nsteps, int tile, int B, int L, int lb,
                            int noise, float* st_re, float* st_im,
                            const float* ph_re, const float* ph_im,
                            const float* ns, const float* wr,
                            const float* wi, const float* pm_t, float* a_re,
                            float* a_im, float* g_re, float* g_im,
                            float* part, float* out, int N, int P,
                            void* stream) {
  if (N <= 0 || N > 32768 || !pass2_takes(P) || nsteps <= 0 || tile <= 0 ||
      B <= 0 || B > 65535 || L <= 0 ||
      static_cast<long long>(B) * L > 0x7fffffffLL || lb < 1 || lb > 8 ||
      noise < 0 || noise > 2 || (noise != 0 && ns == nullptr) ||
      (pupil_tiles(P).T > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int t0 = 0; t0 < nsteps; t0 += tile) {
    const int nt = nsteps - t0 < tile ? nsteps - t0 : tile;
    for (int l0 = 0; l0 < L; l0 += lb) {
      const UpdateArgs u = {k0,    k1,    step0 + static_cast<uint32_t>(t0),
                            nt,    L,     l0,
                            l0 > 0, st_re, st_im,
                            ph_re, ph_im, ns,
                            a_re,  a_im,  N * N,
                            B,     st};
      const cudaError_t err = update_layers(L - l0 < lb ? L - l0 : lb, noise, u);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const cudaError_t err =
        products(P, nt * B, B, wr, wi, pm_t, a_re, a_im, g_re, g_im, part,
                 out + static_cast<size_t>(t0) * B * 2, N, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
