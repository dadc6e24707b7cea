// K2 and K7: fused noise synthesis with pupil-overlap detection (K2) or
// with the screens written out (K7), for Hopper (sm_90a).
//
// K2 replaces fast_tpu/ops/pallas_synth.py::_synth_detect_kernel, the TPU
// kernel behind SYNTH='pallas_fused'; K7 replaces ::_synth_kernel, the one
// behind SYNTH='pallas' (fused_synthesis), which is K2 without the detector:
// Box-Muller noise whatever MC_NOISE says, no subharmonics inside, and the
// screens Re H^T, Im H^T (un-transposed, un-padded, real parts first) as its
// output. Both share pass 1; from one seed K7's screens are the ones K2
// with 'gauss' noise detects. Per complex draw j, in the transposed
// formulation of the TPU kernel:
//
//   bits   two 32-bit words per grid point from Philox4x32-10
//   noise  'mixed': u = (bits >> 8) * sqrt(3) 2^-23 - sqrt(3), z = u @ M
//          'gauss': Box-Muller from 24-bit uniforms
//   colour X' = z * s_t                       (s_t = sqrt(PSD)^T * df)
//   DFT 1  G' = X' W^T                        (N, N) @ (N, P), complex
//   DFT 2  H  = W G'                          (P, N) @ (N, P), complex
//   detect sum(pm_t * cos/sin(Re H + sh_r)), sum(pm_t * cos/sin(Im H + sh_i))
//          with the transposed subharmonic screens sh, if given
//
// Pass 1 (noise, mixing product, colour, DFT 1) is one kernel, synth_pass1,
// and the bulk of the work: at N=256, P=82 (padded to 96) one complex draw
// costs 4N^3 = 67 MFLOP of mixing product and 8N^2 P = 50 MFLOP for G',
// against 8 P^2 N = 19 MFLOP for H in pass 2; at N=1024 with a 402 px
// pupil (padded to 416) 4.3 and 3.4 GFLOP against 1.3. Pass 2 is
// detect_pass of detect.cuh (shared with K1 and K3) or K7's screens_pass,
// fp32 FMA on the CUDA cores.
//
// Pass 1 on the tensor cores. Both of its products run as warp-level
// mma.sync.m16n8k8 TF32 products, each in three passes (3xTF32): every
// operand element x is split once into hi = tf32(x) and lo = tf32(x - hi),
// rounded as cvt.rna.tf32.f32 rounds (nearest, ties away), and each 8-deep
// step computes a_lo b_hi + a_hi b_lo (the small terms) and a_hi b_hi.
// hi + lo carries 22 of fp32's 24 bits and the dropped lo lo term is below
// fp32's rounding. The tensor cores round their sums toward zero, so a sum
// kept in their accumulators shrinks by about half an ulp a step, the same
// way for every element of a screen: kept over a 64-deep tile (24 steps)
// that drifted the 256^2 flagship's sums past the kernel-vs-plain limit.
// So each step's a_hi b_hi is a sum of its own, added in fp32 (round to
// nearest), and only the small terms, 2^-11 of it, stay in the tensor
// cores' accumulators; the card then reads 0.03-0.23 of the limit, fp32
// FMA 0.03-0.08 (tests/test_torch_tf32x3.py emulates the operand rounding
// on the CPU: 0.02-0.05; one TF32 pass reads 2-7x the limit). Every
// PRECISION value means this arithmetic.
//
// What bounds pass 1 now (H100, scripts/torch_pass1_variants.py: the
// kernel beside copies of itself with one part taken out): not the tensor
// cores. At 256^2 'mixed' it takes 16.6 ms a 4096 draws (29 TFLOP/s of
// fp32-accurate products), 11.9 ms with the three mma of each step
// replaced by four FFMA, 15.0 without the split, 15.0 with Philox replaced
// by a hash: the time is the issue and latency of the fragment loads,
// splits, address arithmetic and barriers around the mma, with 16 warps a
// SM. At 1024^2 with the 402 px pupil (one block of 8 warps a SM: the
// uniforms of 32 rows and 4 column groups of accumulators fill it) the
// mma are 15% of its 256 ms.
//
// Why mma.sync and not wgmma + TMA: the operands are formed in the block
// (random bits, mixed and coloured), not read from device memory, and the
// G' tile of one block is narrow (at most 32 rows by 2 x 128 columns), so
// warp-level fragments from padded shared rows need no descriptors,
// swizzled layouts or asynchronous warpgroup pipeline. That is the next
// redesign's lever, with fewer instructions around each product.
//
// The design, a block of 8 warps per (draw, R = 16 RR rows of X', NG
// column groups of the padded pupil):
// * The (N, N) noise never reaches device memory. With 'mixed' noise the
//   block keeps R rows of one component's uniforms (R x NC, NC = N rounded
//   up to 64) in shared memory; for each 64-column tile of X' it runs the
//   mixing product z = u @ M[:, c0:c0+64] over the whole depth, M staged
//   in 64-row slices with cp.async, a ring of three, then writes the tile
//   x = z * s_t, split into hi and lo. With 'gauss' noise one Philox call
//   and one Box-Muller give both components of a grid point, so both x
//   tiles are formed at once and share the W slices.
// * G' += x W^T per 64-column tile, for each column group of the pupil,
//   over two 32-deep W slices (the group's rows of wr, then of wi) in two
//   buffers: the next slice is copied (cp.async) while one is used, the
//   first while the x tile is formed. A warp owns one 16-row slice of the
//   block and one of Re G' or Im G' (the G' tile of a group read as 2 GW
//   columns, real and imaginary 8-column blocks interleaved), FW m16n8
//   fragments of it: RR = 2 gives FW = PJ, 4 PJ accumulators a thread (32
//   at a 128 px pupil). The imaginary component adds -xi wi^T to Re G':
//   the warps of Re G' flip the sign bits of their A fragments, exactly.
// * Strides: the x, W-slice, mixing-slice and uniform rows are 4 words
//   past a multiple of 32 (68, 36, 68, NC + 4), so the 64-bit fragment
//   loads hit every bank once. The mixing slices and the W slices are
//   never live at once and share their shared memory; 'mixed' grids up to
//   2304 px at a 128 px pupil fit (RR = 1 past about 1200 px).
// * A pupil over 128 px (a 4 m telescope: 402 px at 1024^2). The x tile is
//   the expensive operand, so a block makes it once and contracts it with
//   NG = 4 column groups of 16 PJ <= 128 px in turn, each with its own
//   accumulators (one block per SM, up to 255 registers); up to 512 px
//   that is the whole pupil, wider pupils go to further blocks
//   (blockIdx.z) that make the x tile again. P <= 128 is NG = 1, with two
//   blocks per SM.
// * Pass 2 is a block per (draw, tile of H of at most 128 x 128): H = W G',
//   then sincos and a fixed-order reduction, so the result is the same
//   from run to run (no atomics); K7 ends in screens_pass, the same tiles
//   written out.
//
// Random bits. Philox4x32-10 (Salmon et al., SC'11) keyed by the 64-bit
// seed (k0 = low word, k1 = high word). Counter layout, one call per grid
// point of X' (row-major element index e = row * N + col):
//   ctr = (e, draw index, stream, 0);  bits1 = out[0], bits2 = out[1].
// The last word keeps the kernels' streams apart: 0 here (K2 and K7), 1 in
// K1, 2 in the AR kernels, 3 in K3.
// The plain torch version in fast_tpu_torch/ops/synth_detect.py builds the
// same counters, so kernel and plain version see identical noise.
//
// sincos is the Cody-Waite reduction with the cephes polynomials of the
// TPU kernel's _sincos, accurate to 2e-7 for |phi| <= 4096. The build uses
// no fast-math flags.


#include <cuda_runtime.h>
#include <stdint.h>

#include "detect.cuh"
#include "tf32x3.cuh"

namespace {

using namespace fast;

constexpr int kC = 64;         // column tile of X', the depth of G' += x W^T
constexpr int kKT = 64;        // depth of one staged slice of the mixing matrix
constexpr int kStages = 3;     // mixing slices in the ring (2 in flight)
constexpr int kWD = 32;        // depth of one staged slice of the W tile
constexpr int kXS = kC + 4;    // shared row stride of the x tile
constexpr int kWS = kWD + 4;   // ... of the W slices
constexpr int kMS = kC + 4;    // ... of the mixing slices

// How pass 1 covers the padded pupil P: NG column groups of width 16 PJ per
// block and nz blocks along the pupil. P <= 128 is one group of the whole
// width; wider pupils take 4 groups a block, up to 512 px, split evenly
// over the nz blocks. _pass1_geom of fast_tpu_torch/ops/synth_detect.py
// is the same rule.
struct Pass1Geom {
  int PJ, NG, nz;
};

Pass1Geom pass1_geom(int P) {
  if (P <= 128) return {P / 16, 1, 1};
  const int nz = (P + 511) / 512;
  const int per = (P / 16 + nz - 1) / nz;
  return {(per + 3) / 4, 4, nz};
}

// Words of pass 1's shared memory: two W slices (a column group's rows of
// wr and wi, 32 deep), or the ring of mixing slices in the same place;
// the x tiles (one component's for 'mixed', both for 'gauss'), each as hi
// and lo; and one component's uniforms ('mixed').
__host__ __device__ constexpr int pass1_tile_words(bool mixed, int GW) {
  return (2 * 2 * GW * kWS > (mixed ? kStages * kKT * kMS : 0))
             ? 2 * 2 * GW * kWS : kStages * kKT * kMS;
}

__host__ __device__ constexpr int pass1_x_words(bool mixed, int R) {
  return (mixed ? 2 : 4) * R * kXS;
}

// ---- tensor-core arithmetic (tf32x3.cuh): K2's sums of a step -----------

// One 8-deep step of a 3xTF32 product, a 16 x 8 and b 8 x 8 as hi and lo
// fragments: small += a_lo b_hi + a_hi b_lo on the tensor cores, and
// big += a_hi b_hi, the step's 8 products summed on the tensor cores and
// added to big in fp32. The tensor cores round their sums toward zero:
// a long sum kept in their accumulators shrinks by about half an ulp a
// step (the 256^2 flagship's sums drifted past KERNEL_REL, H100), while
// the small terms' sum, 2^-11 of the large one's, may stay there.
// Depth slots: in A and B alike, lane t of a quad holds depths 2t and
// 2t + 1 of the step (fragment slots t and t + 4), so that its part of a
// row is one 64-bit load; the same relabelling of depth in both operands
// leaves the sum as it is.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(small, al, bh);
  mma_tf32(small, ah, bl);
  float d[4];
  mma_tf32_new(d, ah, bh);
#pragma unroll
  for (int v = 0; v < 4; ++v) big[v] += d[v];
}

// Pass 1: one block per (draw, R = 16 RR rows of X', NG column groups of
// the pupil). Writes G' rows. NG = 1: two blocks per SM.
template <bool kMixed, int PJ, int RR, int NG>
__global__ void __launch_bounds__(kThreads, NG == 1 ? 2 : 1)
    synth_pass1(uint32_t k0, uint32_t k1, uint32_t stream, int draw0,
                const float* __restrict__ s_t, const float* __restrict__ wr,
                const float* __restrict__ wi, const float* __restrict__ mix,
                float* __restrict__ g_re, float* __restrict__ g_im, int N,
                int P_rt) {
  constexpr int GW = 16 * PJ;            // width of a column group
  constexpr int R = 16 * RR;             // rows of X' per block
  constexpr int NX = kMixed ? 1 : 2;     // x tiles (components) at once
  constexpr int FW = (RR * PJ + 1) / 2;  // G' fragments a warp, per group
  constexpr int CBS = 4 / RR;            // between a warp's column blocks
  const int P = NG == 1 ? GW : P_rt;     // padded pupil, G's row stride
  const int NC = (N + kC - 1) / kC * kC; // grid side padded to the tiles
  const int US = NC + 4;                 // shared row stride of uniforms
  // rows of M and W 16-byte aligned: copy them in 16-byte pieces
  const bool vec = (N & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(wr) |
                     reinterpret_cast<uintptr_t>(wi) |
                     reinterpret_cast<uintptr_t>(mix)) & 15) == 0;
  extern __shared__ __align__(16) float smem[];
  float* wt = smem;                      // W slices | mixing slices
  uint32_t* xs = reinterpret_cast<uint32_t*>(
      smem + pass1_tile_words(kMixed, GW));  // NX x {hi, lo} x R x kXS
  float* us = smem + pass1_tile_words(kMixed, GW) +
              pass1_x_words(kMixed, R);      // R x US ('mixed')

  const int j = blockIdx.x;
  const uint32_t draw = static_cast<uint32_t>(draw0 + j);
  const int row0 = blockIdx.y * R;
  const int pz = NG == 1 ? 0 : blockIdx.z * NG * GW;  // first pupil column
  const int ngroups = NG == 1 ? 1 : min(NG, (P - pz + GW - 1) / GW);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
  const int mf = warp % RR;              // the warp's 16-row slice
  const int out = (warp / RR) & 1;       // its part of G': 0 Re, 1 Im
  const int cb0 = warp / RR / 2;         // its first 8-column block

  float acc[NG][FW][4];
#pragma unroll
  for (int q = 0; q < NG; ++q)
#pragma unroll
    for (int f = 0; f < FW; ++f)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[q][f][v] = 0.0f;

  for (int comp = 0; comp < (kMixed ? 2 : 1); ++comp) {
    if (kMixed) {
      // the previous component's last tile ended in __syncthreads()
      for (int r = 0; r < R; ++r)
        for (int c = tid; c < NC; c += kThreads) {
          float u = 0.0f;
          if (row0 + r < N && c < N) {
            const U4 v = philox4x32_10(
                static_cast<uint32_t>((row0 + r) * N + c), draw, stream, 0u,
                k0, k1);
            u = mixed_uniform(comp == 0 ? v.x : v.y);
          }
          us[r * US + c] = u;
        }
      __syncthreads();
    }
    for (int c0 = 0; c0 < NC; c0 += kC) {
      // W slice i of this tile: group i / 2, depth half i % 2
      const auto stage_w_slice = [&](int i) {
        float* buf = wt + (i & 1) * 2 * GW * kWS;
        const int p0 = pz + (i >> 1) * GW, c = c0 + (i & 1) * kWD;
        stage_tile<kWS, kWD>(buf, wr, p0, GW, P, N, c, vec);
        stage_tile<kWS, kWD>(buf + GW * kWS, wi, p0, GW, P, N, c, vec);
        cp_async_commit();
      };
      if (kMixed) {
        // z = u @ M[:, c0:c0+64] over the ring of mixing slices: the
        // warp's 16 rows, column blocks warp / RR + 8 / RR * i; the small
        // terms in zl
        float z[RR][4], zl[RR][4];
#pragma unroll
        for (int i = 0; i < RR; ++i)
#pragma unroll
          for (int v = 0; v < 4; ++v) z[i][v] = zl[i][v] = 0.0f;
        const int nst = NC / kKT;
#pragma unroll
        for (int s = 0; s < kStages - 1; ++s) {
          if (s < nst)
            stage_tile<kMS, kC>(wt + s * kKT * kMS, mix, s * kKT, kKT, N, N,
                                c0, vec);
          cp_async_commit();
        }
        for (int s = 0; s < nst; ++s) {
          cp_async_wait<kStages - 2>();
          __syncthreads();  // slice s landed; slice s - 1 read by all
          const int sn = s + kStages - 1;
          if (sn < nst)
            stage_tile<kMS, kC>(wt + (sn % kStages) * kKT * kMS, mix,
                                sn * kKT, kKT, N, N, c0, vec);
          cp_async_commit();
          const float* ms = wt + (s % kStages) * kKT * kMS;
          const float* ua = us + (mf * 16 + g) * US + s * kKT + 2 * t;
#pragma unroll
          for (int k8 = 0; k8 < kKT; k8 += 8) {
            uint32_t ah[4], al[4];
            const float2 u0 = *reinterpret_cast<const float2*>(ua + k8);
            const float2 u1 =
                *reinterpret_cast<const float2*>(ua + 8 * US + k8);
            split(u0.x, ah[0], al[0]);
            split(u1.x, ah[1], al[1]);
            split(u0.y, ah[2], al[2]);
            split(u1.y, ah[3], al[3]);
#pragma unroll
            for (int i = 0; i < RR; ++i) {
              const float* mb = ms + (k8 + 2 * t) * kMS +
                                (warp / RR + 8 / RR * i) * 8 + g;
              uint32_t bh[2], bl[2];
              split(mb[0], bh[0], bl[0]);
              split(mb[kMS], bh[1], bl[1]);
              mma3(z[i], zl[i], ah, al, bh, bl);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RR; ++i)
#pragma unroll
          for (int v = 0; v < 4; ++v) z[i][v] += zl[i][v];
        __syncthreads();  // the ring is read: the W slices take its place
        stage_w_slice(0);
        // x = z * s_t into the x tile, split
#pragma unroll
        for (int i = 0; i < RR; ++i)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int r = mf * 16 + g + (v >> 1) * 8;
            const int cc = (warp / RR + 8 / RR * i) * 8 + 2 * t + (v & 1);
            const int row = row0 + r, col = c0 + cc;
            const float x =
                (row < N && col < N)
                    ? z[i][v] * s_t[static_cast<size_t>(row) * N + col]
                    : 0.0f;
            split(x, xs[r * kXS + cc], xs[(R + r) * kXS + cc]);
          }
      } else {
        stage_w_slice(0);
        // both components of a grid point from one Philox call
        for (int e = tid; e < R * kC; e += kThreads) {
          const int r = e / kC, cc = e - r * kC;
          const int row = row0 + r, col = c0 + cc;
          float xr = 0.0f, xi = 0.0f;
          if (row < N && col < N) {
            const U4 v = philox4x32_10(static_cast<uint32_t>(row * N + col),
                                       draw, stream, 0u, k0, k1);
            float zc, zs;
            box_muller(v.x, v.y, &zc, &zs);
            const float s = s_t[static_cast<size_t>(row) * N + col];
            xr = zc * s;
            xi = zs * s;
          }
          split(xr, xs[r * kXS + cc], xs[(R + r) * kXS + cc]);
          split(xi, xs[(2 * R + r) * kXS + cc], xs[(3 * R + r) * kXS + cc]);
        }
      }
      // G' += x W^T per column group, over two W slices of 32 in a ring.
      // Component 0 (x = xr): Re += xr wr^T, Im += xr wi^T; component 1
      // (x = xi): Re -= xi wi^T (the A fragment negated, exactly),
      // Im += xi wr^T. The small terms of each group's tile in `small`,
      // added to acc at the tile's end.
      const int nsl = 2 * ngroups;
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        if (q >= ngroups) break;
        float small[FW][4];
#pragma unroll
        for (int f = 0; f < FW; ++f)
#pragma unroll
          for (int v = 0; v < 4; ++v) small[f][v] = 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * q + h;
          if (i + 1 < nsl) {
            stage_w_slice(i + 1);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();  // slice i (and the x tile) visible to all
          const float* wsl = wt + (i & 1) * 2 * GW * kWS;
#pragma unroll
          for (int x = 0; x < NX; ++x) {
            const int cp = kMixed ? comp : x;  // the tile's component
            const uint32_t sgn = (cp == 1 && out == 0) ? 0x80000000u : 0u;
            const uint32_t* xh =
                xs + (2 * x * R + mf * 16 + g) * kXS + h * kWD + 2 * t;
            const uint32_t* xl = xh + R * kXS;
            const float* wb =
                wsl + ((out == cp ? 0 : GW) + cb0 * 8 + g) * kWS + 2 * t;
#pragma unroll
            for (int k8 = 0; k8 < kWD; k8 += 8) {
              const uint2 h0 = *reinterpret_cast<const uint2*>(xh + k8);
              const uint2 h1 =
                  *reinterpret_cast<const uint2*>(xh + 8 * kXS + k8);
              const uint2 l0 = *reinterpret_cast<const uint2*>(xl + k8);
              const uint2 l1 =
                  *reinterpret_cast<const uint2*>(xl + 8 * kXS + k8);
              const uint32_t ah[4] = {h0.x ^ sgn, h1.x ^ sgn, h0.y ^ sgn,
                                      h1.y ^ sgn};
              const uint32_t al[4] = {l0.x ^ sgn, l1.x ^ sgn, l0.y ^ sgn,
                                      l1.y ^ sgn};
#pragma unroll
              for (int f = 0; f < FW; ++f) {
                if (cb0 + CBS * f >= 2 * PJ) break;  // RR = 1, PJ odd
                const float2 b = *reinterpret_cast<const float2*>(
                    wb + CBS * f * 8 * kWS + k8);
                uint32_t bh[2], bl[2];
                split(b.x, bh[0], bl[0]);
                split(b.y, bh[1], bl[1]);
                mma3(acc[q][f], small[f], ah, al, bh, bl);
              }
            }
          }
          __syncthreads();  // slice i's buffer is refilled at i + 2
        }
#pragma unroll
        for (int f = 0; f < FW; ++f)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[q][f][v] += small[f][v];
      }
    }
  }
  // fragment (row g | g + 8, columns 2t, 2t + 1) of column block cb
  float* gout = out ? g_im : g_re;
#pragma unroll
  for (int q = 0; q < NG; ++q)
#pragma unroll
    for (int f = 0; f < FW; ++f) {
      const int cb = cb0 + CBS * f;
      const int p = pz + q * GW + cb * 8 + 2 * t;
      if (cb >= 2 * PJ || (NG > 1 && p >= P)) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mf * 16 + g + 8 * h;
        if (row >= N) continue;
        *reinterpret_cast<float2*>(
            gout + (static_cast<size_t>(j) * N + row) * P + p) =
            make_float2(acc[q][f][2 * h], acc[q][f][2 * h + 1]);
      }
    }
}

// Dynamic shared memory of pass 1 in bytes. Must match _smem_bytes in
// fast_tpu_torch/ops/synth_detect.py, which picks RR and decides which
// shapes the wrapper takes.
template <bool kMixed>
size_t pass1_smem(int N, int GW, int RR) {
  const int NC = (N + kC - 1) / kC * kC;
  const int R = 16 * RR;
  return sizeof(float) * (pass1_tile_words(kMixed, GW) +
                          pass1_x_words(kMixed, R) +
                          (kMixed ? R * (NC + 4) : 0));
}

struct Pass1Args {
  uint32_t k0, k1, stream_id;
  int draw0, nbatch;
  const float *s_t, *wr, *wi, *mix;
  float *g_re, *g_im;
  int N, P;
  cudaStream_t stream;
};

template <bool kMixed, int PJ, int RR, int NG>
cudaError_t launch_pass1(const Pass1Args& a, int nz) {
  const size_t smem = pass1_smem<kMixed>(a.N, 16 * PJ, RR);
  auto* k_pass1 = synth_pass1<kMixed, PJ, RR, NG>;
  cudaError_t err = cudaFuncSetAttribute(
      k_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int row_blocks = (a.N + 16 * RR - 1) / (16 * RR);
  k_pass1<<<dim3(a.nbatch, row_blocks, nz), kThreads, smem, a.stream>>>(
      a.k0, a.k1, a.stream_id, a.draw0, a.s_t, a.wr, a.wi, a.mix, a.g_re,
      a.g_im, a.N, a.P);
  return cudaGetLastError();
}

template <bool kMixed, int RR>
cudaError_t dispatch_pass1(const Pass1Args& a) {
  const Pass1Geom g = pass1_geom(a.P);
#define FAST_CASE(PJ, NG) \
  case PJ:                \
    return launch_pass1<kMixed, PJ, RR, NG>(a, g.nz);
  if (g.NG == 1) {
    switch (g.PJ) {
      FAST_CASE(1, 1)
      FAST_CASE(2, 1)
      FAST_CASE(3, 1)
      FAST_CASE(4, 1)
      FAST_CASE(5, 1)
      FAST_CASE(6, 1)
      FAST_CASE(7, 1)
      FAST_CASE(8, 1)
    }
  } else {
    switch (g.PJ) {  // 144 px in 4 groups of 48 up to 512 px in 4 of 128
      FAST_CASE(3, 4)
      FAST_CASE(4, 4)
      FAST_CASE(5, 4)
      FAST_CASE(6, 4)
      FAST_CASE(7, 4)
      FAST_CASE(8, 4)
    }
  }
#undef FAST_CASE
  return cudaErrorInvalidValue;
}

cudaError_t pass1(const Pass1Args& a, int rows) {
  if (a.N <= 0 || !pass2_takes(a.P) || a.nbatch <= 0 ||
      (rows != 1 && rows != 2) || pass1_geom(a.P).nz > 65535 ||
      (a.N + 16 * rows - 1) / (16 * rows) > 65535)
    return cudaErrorInvalidValue;
  if (a.mix == nullptr) return dispatch_pass1<false, 2>(a);
  return rows == 2 ? dispatch_pass1<true, 2>(a) : dispatch_pass1<true, 1>(a);
}

// The screens pass: the tiles of the detect pass, written out. scr_re and
// scr_im: (nbatch, npup, npup) un-padded, un-transposed screens,
// scr[j][p2][p1] = H[p1][p2]; the tile is formed transposed (kSwap), so
// neighbouring threads write neighbouring addresses.
template <int PJ, bool kOne>
__global__ void __launch_bounds__(kThreads)
    screens_pass(const float* __restrict__ wr, const float* __restrict__ wi,
                 const float* __restrict__ g_re,
                 const float* __restrict__ g_im, float* __restrict__ scr_re,
                 float* __restrict__ scr_im, int N, int P_rt, int T,
                 int npup) {
  constexpr int TP = 16 * PJ;
  const int P = kOne ? TP : P_rt;
  const int j = blockIdx.x;
  const int tile = kOne ? 0 : blockIdx.y;
  const int r0 = kOne ? 0 : tile / T * TP, c0 = kOne ? 0 : tile % T * TP;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float hr[PJ][PJ], hi[PJ][PJ];
  tile_product<PJ, true, kOne>(wr, wi, g_re + static_cast<size_t>(j) * N * P,
                               g_im + static_cast<size_t>(j) * N * P, N, P,
                               r0, c0, hr, hi);
#pragma unroll
  for (int a = 0; a < PJ; ++a)
#pragma unroll
    for (int b = 0; b < PJ; ++b) {
      const int p2 = c0 + ty + 16 * a, p1 = r0 + tx + 16 * b;
      if (p1 >= npup || p2 >= npup) continue;
      const size_t at = (static_cast<size_t>(j) * npup + p2) * npup + p1;
      scr_re[at] = hr[a][b];
      scr_im[at] = hi[a][b];
    }
}

// Launch the screens pass for a padded pupil P: the screens of nbatch
// draws into scr_re and scr_im (nbatch, npup, npup).
cudaError_t launch_screens(int P, int nbatch, const float* wr,
                                  const float* wi, const float* g_re,
                                  const float* g_im, float* scr_re,
                                  float* scr_im, int N, int npup,
                                  cudaStream_t stream) {
  const PupilTiles t = pupil_tiles(P);
  if (!pass2_takes(P) || npup <= 0 || npup > P) return cudaErrorInvalidValue;
  const dim3 grid(nbatch, t.T * t.T);
#define FAST_SCREENS(PJ, ONE)                            \
  screens_pass<PJ, ONE><<<grid, kThreads, 0, stream>>>(  \
      wr, wi, g_re, g_im, scr_re, scr_im, N, P, t.T, npup)
  FAST_TILE_SWITCH(t, FAST_SCREENS)
#undef FAST_SCREENS
  return cudaGetLastError();
}

__global__ void sincos_kernel(const float* __restrict__ phi,
                              float* __restrict__ s, float* __restrict__ c,
                              int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) sincos_cw(phi[i], s + i, c + i);
}

}  // namespace

// K2. Shapes: s_t, mix (N, N); wr, wi (P, N); pm_t (P, P); g_re, g_im
// scratch (nbatch, N, P); out (nbatch, 4) = (sum pm cos h1, sum pm sin h1,
// sum pm cos h2, sum pm sin h2); part: scratch (nbatch, T * T, 4) for a
// pupil over 128 px (T = ceil(P / 128)), else unused. mix == nullptr
// selects 'gauss' noise. sh_t: nullptr, or (nbatch, 2, P, P) transposed
// subharmonic screens added to (Re H, Im H) before the detector. P must be
// a multiple of 16. rows (RR) is 1 or 2 for 'mixed' noise, whose pass-1
// shared memory at (N, P, rows) must fit the card; 'gauss' keeps no
// uniforms in shared memory and always takes 2. Returns the cudaError_t of
// the launches (0 on success).
extern "C" int fast_synth_detect(uint32_t k0, uint32_t k1, uint32_t stream_id,
                                 int draw0, int nbatch, const float* s_t,
                                 const float* wr, const float* wi,
                                 const float* pm_t, const float* mix,
                                 const float* sh_t, float* g_re, float* g_im,
                                 float* part, float* out, int N, int P,
                                 int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = pass1({k0, k1, stream_id, draw0, nbatch, s_t, wr, wi, mix,
                           g_re, g_im, N, P, st}, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_detect(P, nbatch, wr, wi, g_re, g_im, pm_t,
                                        sh_t, part, out, N, st));
}

// Pass 1 alone: G' = X' W^T of nbatch draws into g_re, g_im (nbatch, N,
// P), as K2 (mix != nullptr: 'mixed' noise) or K7 (mix == nullptr) make it
// before their second pass. For timing pass 1 and for holding it element
// by element against its plain version. Other arguments as K2's.
extern "C" int fast_synth_pass1(uint32_t k0, uint32_t k1, uint32_t stream_id,
                                int draw0, int nbatch, const float* s_t,
                                const float* wr, const float* wi,
                                const float* mix, float* g_re, float* g_im,
                                int N, int P, int rows, void* stream) {
  return static_cast<int>(pass1({k0, k1, stream_id, draw0, nbatch, s_t, wr,
                                 wi, mix, g_re, g_im, N, P,
                                 static_cast<cudaStream_t>(stream)},
                                rows));
}

// K7. Pass 1 with Box-Muller noise, then the screens of the nbatch draws:
// scr_re, scr_im (nbatch, npup, npup), the real and imaginary parts of
// W X W^T cropped to the npup <= P pupil pixels. Other arguments as K2's.
extern "C" int fast_synth_screens(uint32_t k0, uint32_t k1, uint32_t stream_id,
                                  int draw0, int nbatch, const float* s_t,
                                  const float* wr, const float* wi,
                                  float* g_re, float* g_im, float* scr_re,
                                  float* scr_im, int N, int P, int npup,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = pass1({k0, k1, stream_id, draw0, nbatch, s_t, wr, wi,
                           nullptr, g_re, g_im, N, P, st}, 2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_screens(P, nbatch, wr, wi, g_re, g_im,
                                         scr_re, scr_im, N, npup, st));
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
