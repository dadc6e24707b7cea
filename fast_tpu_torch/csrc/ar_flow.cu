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
// recurrence (3 MFLOP at L=4): the products bound it. K4 and K5 are the
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
// * ar_dft, the first product, on the tensor cores: one block of 8 warps
//   per ((step, series), 128 columns of A, pupil column group). A pupil of
//   up to 128 px (padded to P = 16 PJ) is one group; a wider one is cut as
//   the detect pass of detect.cuh cuts it, T = ceil(P / 128) groups of
//   width 16 ceil(P / 16 / T), the last ragged and masked. It writes G' in
//   the layout of the iid kernels' G' (N x P per step and series).
//   (ar_split_w splits W for it once per call.)
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
// The first product on the tensor cores. It was 61% of K4's and K6's
// device time as fp32 FMA on the CUDA cores (~23 TFLOP/s at 256^2 over
// the pupil's 82 px, H100): each thread loaded 4 values of A and 2 PJ of
// W from shared memory for 8 PJ FMA, so the issue of shared loads and FMA
// set its pace, and every block of 32 columns staged all of W again. Now
// it runs as warp-level mma.sync.m16n8k8 TF32 products in three passes
// (3xTF32, the arithmetic of K2's pass 1, tf32x3.cuh): every operand
// element x is split once into hi = tf32(x) and lo = tf32(x - hi), and
// each 8-deep step adds a_lo b_hi + a_hi b_lo + a_hi b_hi. What the
// design does about its costs:
// * W is the same for every step and series of a call, so ar_split_w
//   splits it once, into the order of the B fragments: one 16-byte shared
//   load gives a lane the hi and lo of one n8 tile. Nothing in the loop
//   splits W.
// * A is read from device memory, raw, in 32-deep slices by cp.async, two
//   buffers (the next slice lands while one is used). Each element of a
//   slice is read by one warp, once, and split as its fragment is formed;
//   the fragment then serves all 4 PJ n8 tiles of the group (Re G' and
//   Im G'), 24 at P = 96: 144 mma a warp per 8-deep step against 24
//   16-byte loads of W and 8 of A.
// * 128 columns of A a block, 16 a warp, so W is staged a quarter as
//   often per step as with 32; 256^2 tiles of 256 (step, series) pairs
//   give 512 blocks of 8 warps, about four per SM.
// * The tensor cores round their sums toward zero, so a sum kept in their
//   accumulators shrinks coherently (K2's first design read 10x its
//   limit). Each 8-deep step's six products of one output tile (the small
//   terms first, then a_hi b_hi of re and im) are a sum of their own in
//   fresh accumulators, added to the block's accumulators in fp32 (round
//   to nearest). Nothing stays in the tensor cores' accumulators from one
//   step to the next, which also keeps 4 registers an output tile, not
//   K2's 8: 16 PJ accumulators a thread.
// What bounds it now (H100, scripts/torch_ar_dft_variants.py: the stage
// beside copies of itself with one part taken out): the shared loads of
// W's fragments, then the mma. At 256^2 it takes 0.239 ms a tile of 256
// (step, series) pairs (46 TFLOP/s of fp32-accurate products, counted
// over the pupil's 82 px, not the padded 96; 49 inside K4), 0.103 with
// one load of W a step for all tiles, 0.154 with one TF32 pass, 0.124
// with FFMA in place of the mma; the split of A costs nothing measurable.
// ptxas gives it 255 registers and spills 76-116 bytes (PJ = 6; 60-84 at
// PJ = 7): the accumulators of all 2 PJ tiles fill the register file.
// Each W fragment serves one A fragment, since a warp owns 16 columns; a
// warp of 32 or 48 columns would halve the loads, but its accumulators
// only fit with fewer pupil tiles a warp, whose A fragments several warps
// would then split (A stored split in shared memory).
//
// Rounding. The update runs for thousands of steps before its sum passes
// through sin and cos, so it is written with __fmul_rn / __fadd_rn and the
// file is built with -fmad=false: no product-sum is contracted into an FMA
// except the explicit fmaf of the second DFT product. The plain torch
// version (fast_tpu_torch/ops/ar_flow.py) runs the same operations in the
// same order, so state and A agree with it bit for bit and only the
// products differ (other roundings and sums in another order).
//
// Random bits. Philox4x32-10 keyed by the 64-bit seed (k0 = low word,
// k1 = high word). Counter of mode e = row * N + col of layer l of series
// s at the absolute step t of the series:
//   ctr = (e, (s0 + s) * L + l, t, 2);  bits1 = out[0] (real part),
//   bits2 = out[1],
// with s0 the call's series offset (0 unless the caller says). The
// series-major row is the TPU kernel's row order, and makes series 0 of a
// batch the single series of K4 from the same seed; the offset lets a
// rank that holds series s0 .. s0 + B - 1 of a scan draw the noise those
// series draw in one call over the whole scan (state rows stay local). The
// absolute step makes a series cut into several calls the same series;
// the last word 2 keeps these streams apart from K2's (0), K1's (1) and
// K3's (3).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "detect.cuh"
#include "tf32x3.cuh"

namespace {

using namespace fast;

constexpr int kDK = 32;        // depth of one staged slice of ar_dft
constexpr int kDM = 128;       // columns of A per ar_dft block, 16 a warp
constexpr int kAS = kDM + 4;   // shared row stride of ar_dft's A slices

// noise kinds
constexpr int kNone = 0, kUniform = 1, kGauss = 2;

// Advance LB layers of every mode of series s = blockIdx.y (of B =
// gridDim.y) by nsteps steps and add them into A. st_*, ph_*, ns: (B, L,
// N, N); a_*: (nsteps, B, N, N). accumulate: A already holds the sum of
// the layers below layer0. series0: the series offset of the Philox row.
template <int LB, int kNoise>
__global__ void __launch_bounds__(kThreads)
    ar_update(uint32_t k0, uint32_t k1, uint32_t step0, int nsteps, int L,
              int layer0, int series0, int accumulate,
              float* __restrict__ st_re,
              float* __restrict__ st_im, const float* __restrict__ ph_re,
              const float* __restrict__ ph_im, const float* __restrict__ ns,
              float* __restrict__ a_re, float* __restrict__ a_im, int NN) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= NN) return;
  const int s = blockIdx.y, B = gridDim.y;
  // the state row of the block's first layer, and its Philox counter word
  const int row0 = s * L + layer0;
  const int prow0 = (series0 + s) * L + layer0;
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
                                   static_cast<uint32_t>(prow0 + l),
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

// W split for ar_dft, once per call: for each pupil tile of 8 rows nt < P / 8
// and 8-deep depth step ks < NK (the depth N zero padded to a multiple of
// kDK), two runs of 32 lanes x 4 words, q = 0 for wr and 1 for wi; lane
// (g, t) = (lane >> 2, lane & 3) holds the hi and lo of W[8 nt + g][8 ks +
// 2t] and W[8 nt + g][8 ks + 2t + 1], in the order (hi, hi, lo, lo): one
// 16-byte load of a warp's run gives every lane its B fragments, hi and
// lo, and the warp reads 512 consecutive bytes. ws[((nt NK + ks) 2 + q)
// 128 + 4 lane + v], one thread per (nt, ks, q, lane).
__global__ void ar_split_w(const float* __restrict__ wr,
                           const float* __restrict__ wi,
                           uint4* __restrict__ ws, int N, int NK, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lane = i & 31, q = (i >> 5) & 1;
  const int ks = (i >> 6) % NK, nt = (i >> 6) / NK;
  const int k = 8 * ks + 2 * (lane & 3);
  const float* w = (q ? wi : wr) + static_cast<size_t>(8 * nt + (lane >> 2)) * N;
  uint32_t h0, l0, h1, l1;
  split(k < N ? w[k] : 0.0f, h0, l0);
  split(k + 1 < N ? w[k + 1] : 0.0f, h1, l1);
  ws[i] = make_uint4(h0, h1, l0, l1);
}

// Words of ar_dft's dynamic shared memory: two W slices (the group's 2 PJ
// pupil tiles, kDK deep, re and im, hi and lo) and two slices of A (kDK
// rows of kDM columns, re and im).
__host__ __device__ constexpr int dft_w_words(int PJ) {
  return 2 * PJ * (kDK / 8) * 256;
}
constexpr int kDftAWords = 2 * kDK * kAS;

// G'[j][m][p] = sum_k A[j][k][m] W[p][k], complex, for j = (step, series),
// on the tensor cores (3xTF32 mma.sync.m16n8k8). One block per (j, kDM =
// 128 columns m of A, pupil column group blockIdx.z of width GW = 16 PJ);
// warp w owns the 16 columns m0 + 16 w .. and every n8 tile of the group's
// Re G' and Im G' (2 x 2 PJ tiles, 24 at P = 96), so each A fragment, split
// once, serves all of them. The depth runs in slices of kDK, two buffers
// of A (raw fp32, copied with cp.async) and of the pre-split W (ws, from
// ar_split_w), the next slice copied while one is used. Rows of W past P
// and depth past N are zeros; G' is written only below P. kOne: the group
// is the whole pupil, P = 16 PJ, known to the compiler.
template <int PJ, bool kOne>
__global__ void __launch_bounds__(kThreads, 1)
    ar_dft(const uint4* __restrict__ ws, const float* __restrict__ a_re,
           const float* __restrict__ a_im, float* __restrict__ g_re,
           float* __restrict__ g_im, int N, int P_rt) {
  constexpr int NT = 2 * PJ;                 // n8 pupil tiles of a group
  constexpr int KS = kDK / 8;                // 8-deep steps of a slice
  constexpr int WW = dft_w_words(PJ);
  extern __shared__ __align__(16) float smem[];
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem);  // 2 x WW
  float* sa = smem + 2 * WW;                         // 2 x kDftAWords

  const int P = kOne ? 16 * PJ : P_rt;
  const int nt0 = kOne ? 0 : blockIdx.z * NT;  // the group's first tile
  const int j = blockIdx.x, m0 = blockIdx.y * kDM;
  const int NK = (N + kDK - 1) / kDK * KS;     // 8-deep steps, padded
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* ar = a_re + static_cast<size_t>(j) * N * N;
  const float* ai = a_im + static_cast<size_t>(j) * N * N;
  // rows of A 16-byte aligned: copy them in 16-byte pieces
  const bool vec = (N & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(a_re) |
                     reinterpret_cast<uintptr_t>(a_im)) & 15) == 0;

  // slice s into buffer s & 1: the group's runs of ws (KS steps x 256
  // words a tile, tiles past P as zeros), then kDK rows of A
  const auto stage = [&](int s) {
    uint32_t* wb = sw + (s & 1) * WW;
    for (int e = tid; e < NT * KS * 64; e += kThreads) {
      const int nt = e / (KS * 64), c = e - nt * (KS * 64);
      const bool in = kOne || (nt0 + nt) * 8 < P;
      const uint4* src = ws + (static_cast<size_t>(nt0 + nt) * NK + s * KS) *
                                  64 + c;
      cp_async(wb + 4 * e, in ? src : ws, in, true);
    }
    float* ab = sa + (s & 1) * kDftAWords;
    stage_tile<kAS, kDM>(ab, ar, s * kDK, kDK, N, N, m0, vec);
    stage_tile<kAS, kDM>(ab + kDK * kAS, ai, s * kDK, kDK, N, N, m0, vec);
    cp_async_commit();
  };

  float acc[2][NT][4];  // [0] Re G', [1] Im G'
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[c][nt][v] = 0.0f;

  const int nsl = NK / KS;
  stage(0);
  for (int s = 0; s < nsl; ++s) {
    if (s + 1 < nsl) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice s visible to all
    const uint32_t* wb = sw + (s & 1) * WW + 4 * lane;
    const float* ab = sa + (s & 1) * kDftAWords + 16 * warp + g;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // A fragments of re and im: columns m (the fragment's rows) g and
      // g + 8 of the warp's 16, depths 2t (slots t) and 2t + 1 (slots
      // t + 4), each element split once; nh, nl: -A_im, sign bits flipped
      uint32_t ah[2][4], al[2][4], nh[4], nl[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float* a = ab + c * kDK * kAS + (8 * ks + 2 * t) * kAS;
        split(a[0], ah[c][0], al[c][0]);
        split(a[8], ah[c][1], al[c][1]);
        split(a[kAS], ah[c][2], al[c][2]);
        split(a[kAS + 8], ah[c][3], al[c][3]);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        nh[v] = ah[1][v] ^ 0x80000000u;
        nl[v] = al[1][v] ^ 0x80000000u;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4 r4 = *reinterpret_cast<const uint4*>(
            wb + ((nt * KS + ks) * 2) * 128);
        const uint4 i4 = *reinterpret_cast<const uint4*>(
            wb + ((nt * KS + ks) * 2 + 1) * 128);
        const uint32_t rh[2] = {r4.x, r4.y}, rl[2] = {r4.z, r4.w};
        const uint32_t ih[2] = {i4.x, i4.y}, il[2] = {i4.z, i4.w};
        // Re G' += Ar Wr - Ai Wi and Im G' += Ar Wi + Ai Wr: each step's
        // products a sum of their own, the small terms first, then the
        // large ones, added to acc in fp32
        float d[4];
        mma_tf32_new(d, al[0], rh);
        mma_tf32(d, ah[0], rl);
        mma_tf32(d, nl, ih);
        mma_tf32(d, nh, il);
        mma_tf32(d, ah[0], rh);
        mma_tf32(d, nh, ih);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[0][nt][v] += d[v];
        mma_tf32_new(d, al[0], ih);
        mma_tf32(d, ah[0], il);
        mma_tf32(d, al[1], rh);
        mma_tf32(d, ah[1], rl);
        mma_tf32(d, ah[0], ih);
        mma_tf32(d, ah[1], rh);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[1][nt][v] += d[v];
      }
    }
    __syncthreads();  // buffer s & 1 is refilled at s + 2
  }
  // fragment (column m = g | g + 8 of the warp's, pupil 2t, 2t + 1 of tile
  // nt)
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float* gout = c ? g_im : g_re;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int p = (nt0 + nt) * 8 + 2 * t;
      if (!kOne && p >= P) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * warp + g + 8 * h;
        if (m >= N) continue;
        *reinterpret_cast<float2*>(
            gout + (static_cast<size_t>(j) * N + m) * P + p) =
            make_float2(acc[c][nt][2 * h], acc[c][nt][2 * h + 1]);
      }
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
  int nsteps, L, layer0, series0, accumulate;
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
      u.k0, u.k1, u.step0, u.nsteps, u.L, u.layer0, u.series0, u.accumulate,
      u.st_re, u.st_im, u.ph_re, u.ph_im, u.ns, u.a_re, u.a_im, u.NN);
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

// W's split into ws, for every ar_dft launch of a call.
cudaError_t split_w(int P, const float* wr, const float* wi, uint32_t* ws,
                    int N, cudaStream_t stream) {
  const int NK = (N + kDK - 1) / kDK * (kDK / 8);
  const int n = P / 8 * NK * 64;
  ar_split_w<<<(n + 255) / 256, 256, 0, stream>>>(
      wr, wi, reinterpret_cast<uint4*>(ws), N, NK, n);
  return cudaGetLastError();
}

// The first product of nj = (steps x B series) layer sums: G' into g_re,
// g_im (nj, N, P), from ws as split_w leaves it.
cudaError_t first_product(int P, int nj, const uint32_t* ws,
                          const float* a_re, const float* a_im, float* g_re,
                          float* g_im, int N, cudaStream_t stream) {
  const PupilTiles t = pupil_tiles(P);
  const dim3 gd(nj, (N + kDM - 1) / kDM, t.T);
  cudaError_t err = cudaSuccess;
#define FAST_DFT(PJ, ONE)                                                  \
  {                                                                        \
    const int smem = static_cast<int>(                                     \
        sizeof(float) * (2 * dft_w_words(PJ) + 2 * kDftAWords));           \
    auto* k_dft = ar_dft<PJ, ONE>;                                         \
    err = cudaFuncSetAttribute(                                            \
        k_dft, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);         \
    if (err != cudaSuccess) return err;                                    \
    k_dft<<<gd, kThreads, smem, stream>>>(                                 \
        reinterpret_cast<const uint4*>(ws), a_re, a_im, g_re, g_im, N, P); \
  }
  FAST_TILE_SWITCH(t, FAST_DFT)
#undef FAST_DFT
  return cudaGetLastError();
}

// The two products and the detect pass of nj = (steps x B series) layer
// sums: G' into g_re/g_im (nj, N, P), the sums into out (nj, 2), through
// part (nj, T * T, 2) for a pupil over 128 px.
cudaError_t products(int P, int nj, int B, const float* wr, const float* wi,
                     const uint32_t* ws, const float* pm_t,
                     const float* a_re, const float* a_im, float* g_re,
                     float* g_im, float* part, float* out, int N,
                     cudaStream_t stream) {
  const PupilTiles t = pupil_tiles(P);
  cudaError_t err =
      first_product(P, nj, ws, a_re, a_im, g_re, g_im, N, stream);
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
// step0; series s draws the Philox rows of series series0 + s. Shapes:
// st_re, st_im (B, L, N, N), the states, updated in place;
// ph_re, ph_im (B, L, N, N); ns (B, L, N, N), read only with noise != 0;
// wr, wi (P, N), shared; pm_t (B, P, P), each series' transposed pupil *
// mode; scratch ws (P x (N rounded up to 32) x 4 words, W split for the
// tensor cores, written first), a_re, a_im (tile * B, N, N), g_re, g_im
// (tile * B, N, P) and, for a pupil over 128 px, part (tile * B, T * T, 2)
// with T = ceil(P / 128) (else unused, may be null); out (nsteps, B, 2) =
// (sum pm cos phi, sum pm sin phi) per step and series. lb: layers per
// thread of the update pass, 1..8; lb >= L is K4's counterpart (every
// layer in one pass), lb < L K5's (layer blocks in turn); B > 1 is K6's.
// noise: 0 none, 1 'uniform', 2 'gauss'. P must be a multiple of 16.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int fast_ar_flow(uint32_t k0, uint32_t k1, uint32_t step0,
                            int nsteps, int tile, int B, int series0,
                            int L, int lb, int noise, float* st_re,
                            float* st_im,
                            const float* ph_re, const float* ph_im,
                            const float* ns, const float* wr,
                            const float* wi, const float* pm_t,
                            uint32_t* ws, float* a_re, float* a_im,
                            float* g_re, float* g_im, float* part,
                            float* out, int N, int P, void* stream) {
  if (N <= 0 || N > 32768 || !pass2_takes(P) || nsteps <= 0 || tile <= 0 ||
      B <= 0 || B > 65535 || series0 < 0 || L <= 0 ||
      (static_cast<long long>(series0) + B) * L > 0x7fffffffLL || lb < 1 ||
      lb > 8 || noise < 0 || noise > 2 || (noise != 0 && ns == nullptr) ||
      (pupil_tiles(P).T > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = split_w(P, wr, wi, ws, N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int t0 = 0; t0 < nsteps; t0 += tile) {
    const int nt = nsteps - t0 < tile ? nsteps - t0 : tile;
    for (int l0 = 0; l0 < L; l0 += lb) {
      const UpdateArgs u = {k0,      k1,     step0 + static_cast<uint32_t>(t0),
                            nt,      L,      l0,
                            series0, l0 > 0, st_re,
                            st_im,   ph_re,  ph_im,
                            ns,      a_re,   a_im,
                            N * N,   B,      st};
      err = update_layers(L - l0 < lb ? L - l0 : lb, noise, u);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    err = products(P, nt * B, B, wr, wi, ws, pm_t, a_re, a_im, g_re, g_im,
                   part, out + static_cast<size_t>(t0) * B * 2, N, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The first DFT product alone, as fast_ar_flow runs it: W split into ws,
// then G' = A^T W^T of nj layer sums a_re, a_im (nj, N, N) into g_re,
// g_im (nj, N, P). For timing the stage and holding it element by element
// against its plain version. Other arguments as fast_ar_flow's.
extern "C" int fast_ar_dft(int nj, const float* wr, const float* wi,
                           const float* a_re, const float* a_im,
                           uint32_t* ws, float* g_re, float* g_im, int N,
                           int P, void* stream) {
  if (N <= 0 || N > 32768 || !pass2_takes(P) || nj <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = split_w(P, wr, wi, ws, N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      first_product(P, nj, ws, a_re, a_im, g_re, g_im, N, st));
}

extern "C" const char* fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
