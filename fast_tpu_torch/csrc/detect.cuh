// The second pass of the iid kernels: the detect pass that K1, K2 and K3
// end with and K7's screens pass, one tensor-core product on Hopper's
// wgmma (sm_90a).
//
// Both form, for each draw, the transposed screens from its G' (N x P,
// real and imaginary parts, P contiguous, as pass 1 writes it):
//   H^T = G'^T W^T,  Re H^T = Gr^T Wr^T - Gi^T Wi^T,
//                    Im H^T = Gr^T Wi^T + Gi^T Wr^T
// (H = W G', P x P complex; Re H and Im H are two screens). The detect
// pass adds the transposed subharmonic screens if given and reduces
//   sum(pm_t * cos/sin(Re H)), sum(pm_t * cos/sin(Im H))
// in a fixed order; the screens pass writes Re H^T and Im H^T, un-padded.
//
// One GEMM with the draws stacked. The rows of the product are the (draw,
// p2) pairs of a launch, flattened: M = nbatch P. A block of work is 64
// rows (wgmma's M; P is a multiple of 16, so each warp's 16 rows belong to
// one draw, and a group of 64 / gcd(P, 64) draws fills whole blocks: no
// rows are padded, where one draw a block would pad 96 to 128) by one
// slice of PB <= 208 p1 columns (w_slices: one slice up to 208 px, two of
// 208 at 416), over the depth N. Its shape is pass 1's (synth_detect.cu):
// two consumer warpgroups and a producer warpgroup (setmaxnreg); consumer
// warpgroup 0 forms Re H^T, 1 Im H^T. One block a SM runs blocks of work
// in turn (persistent), so the producers stream the next one's operands
// while the consumers end this one.
// * B = W^T is the same for every draw: the laid W table, split once per
//   configuration into TF32 hi and lo and laid out in wgmma's core-matrix
//   order (ops/synth_detect.py, laid_w: pass 1's own wpack, read here
//   too). One producer thread streams its 8-deep steps into a ring with
//   cp.async.bulk on mbarriers; the kernel splits no B operand.
// * A = G'^T from G' as pass 1 writes it. Three producer warps copy each
//   64-deep tile's rows [k][p2] in 16-byte cp.async pieces into shared
//   memory at a row stride of 68 floats, two or three tiles in flight,
//   each thread's arrival on the tile's mbarrier waiting for its pieces.
//   The consumers load each A fragment (rows p2, depths k) from there,
//   conflict-free, split it into hi and lo in registers and flip -Gi's
//   sign in the fragment (exactly: the sign bit). One bulk copy per depth,
//   part and run of one draw's rows (a first version) made the A supply
//   the bound: 2.03 against 1.25 ms at 256^2, its requests a few hundred
//   bytes each.
// * Sums: 3xTF32 in fold groups of two 8-deep steps, each a fresh
//   accumulator (the small terms first, then a_hi b_hi) added to an fp32
//   sum: the tensor cores round toward zero (synth_detect.cu), so nothing
//   long stays in their accumulators. The products are tile_products of
//   wgmma.cuh, pass 1's.
// * Epilogues. Each accumulator element is H^T[p2][p1]. Detect: add sh_t,
//   sincos_cw (common.cuh), weight by pm_t[p1 P + p2]; each thread sums its
//   terms, a warp its lanes by shuffles, and lane 0 writes the warp's two
//   sums (warpgroup 0 sums 0 and 1, warpgroup 1 sums 2 and 3) into a
//   scratch per (draw, 16 rows, slice), which sum_tiles adds per draw in
//   that order: no atomics, the same sums from run to run. Screens: each
//   thread stores its column pairs (2t, 2t + 1) of rows p2 as
//   scr[j][p2][p1], 8 bytes a store at an even pupil width.
//
// What bounds it (H100 80GB HBM3, 700 W; scripts/torch_detect_ab.py and
// scripts/torch_detect_variants.py): at 1024^2 with the 402 px pupil the
// detect pass takes 10.4-10.5 ms a 630 draws (80 TFLOP/s over the 402 px;
// on mma.sync 21.0), 6.5 with no products at all and 8.7 without the
// epilogue's sincos: the products, the work around them (A fragments and
// their split, folds, barriers) and the epilogue add up, two consumer
// warpgroups a SM leaving little to overlap. K7's screens pass takes 10.2
// there (on fp32 FMA 42.1): ptxas serializes its wgmma at the 208 px
// slice (C7511), which the detect pass escapes with a third A tile. At
// the flagships' 82 px (P = 96) 1.26-1.28 ms a 4096 draws at 256^2 (on
// mma.sync 1.72), 2.37-2.38 at 512^2 (3.25-3.28): the work around the
// products (0.89 ms at 256^2 with none), the A supply (one A tile in
// flight: 1.56 ms) and the epilogue (0.1). G' is read once (2.1 GB at
// 1024^2 per 630 draws, 0.64 ms at 3.35 TB/s), W from L2 by every block.

#pragma once

#include "common.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace fast {

// The tiles of the pupil axis: T tiles of width 16 * PJ cover the padded
// width P (a multiple of 16). The AR kernels' detect (ar_flow.cu) tiles the
// pupil so; pass2_takes bounds P by it for every kernel.
struct PupilTiles {
  int T, PJ;
};

inline PupilTiles pupil_tiles(int P) {
  const int T = (P + 127) / 128;
  return {T, (P / 16 + T - 1) / T};
}

// The switch over the tile geometry t of a padded pupil: LAUNCH(PJ, ONE)
// is the kernel launch of one case. One tile: PJ = P / 16; more tiles:
// 16 PJ T >= P > 128 (T - 1), so PJ is 5 to 8.
#define FAST_TILE_SWITCH(t, LAUNCH)   \
  if ((t).T == 1) {                   \
    switch ((t).PJ) {                 \
      case 1: LAUNCH(1, true); break; \
      case 2: LAUNCH(2, true); break; \
      case 3: LAUNCH(3, true); break; \
      case 4: LAUNCH(4, true); break; \
      case 5: LAUNCH(5, true); break; \
      case 6: LAUNCH(6, true); break; \
      case 7: LAUNCH(7, true); break; \
      case 8: LAUNCH(8, true); break; \
      default: return cudaErrorInvalidValue; \
    }                                 \
  } else {                            \
    switch ((t).PJ) {                 \
      case 5: LAUNCH(5, false); break; \
      case 6: LAUNCH(6, false); break; \
      case 7: LAUNCH(7, false); break; \
      case 8: LAUNCH(8, false); break; \
      default: return cudaErrorInvalidValue; \
    }                                 \
  }

inline bool pass2_takes(int P) {
  return P % 16 == 0 && P >= 16 && pupil_tiles(P).T <= 255;
}

// ---- the laid W table's slices ----------------------------------------------

constexpr int kWSliceMax = 208;  // widest slice of the pupil a block covers

// How W^T's columns are cut: nz slices of PB <= 208 columns (a multiple of
// 16). Pass 1 of K2 and K7 and the second pass share the rule, and so the
// laid W table (_pass1_geom of ops/synth_detect.py is the same rule).
struct WSlices {
  int PB, nz;
};

__host__ __device__ inline WSlices w_slices(int P) {
  const int nz = (P + kWSliceMax - 1) / kWSliceMax;
  return {(P / 16 + nz - 1) / nz * 16, nz};
}

// The switch over a slice width PB: CASE(PB) is the launch of one width.
#define FAST_PB_SWITCH(pb, CASE)                                          \
  switch (pb) {                                                           \
    CASE(16) CASE(32) CASE(48) CASE(64) CASE(80) CASE(96) CASE(112)       \
    CASE(128) CASE(144) CASE(160) CASE(176) CASE(192) CASE(208)           \
    default: return cudaErrorInvalidValue;                                \
  }

// ---- the second pass on wgmma ------------------------------------------------

constexpr int kDetRows = 64;    // stacked (draw, p2) rows a block
constexpr int kDetDepth = 64;   // depth of an A tile: 8 steps, 4 fold groups
constexpr int kDetAS = kDetRows + 4;  // shared row stride of an A tile
constexpr int kDetAPart = kDetDepth * kDetAS;  // words of Re or Im
constexpr int kDetATile = 2 * kDetAPart;
constexpr int kDetConsumers = 256;                  // two warpgroups
constexpr int kDetThreads = kDetConsumers + 128;    // and the producer's
constexpr int kDetAWarps = 3;   // producer warps that copy A

// By slice width PB (H100 80GB HBM3, 700 W; copies of the pass timed as
// scripts/torch_detect_variants.py times them): W steps in the ring, 8 up
// to 128 columns (a fold group's products are short there), 4 above; A
// tiles in flight, 3 above 128 columns (else ptxas serializes the wgmma
// of the 208-column slice: 11.88 against 10.56 ms at 1024^2), 2 up to it
// (where a third squeezes L1, which the epilogue's pm_t loads use: 0.92
// against 1.17 ms at 102^2); registers of a consumer and of a producer
// thread (2 x 128 x c + 128 x p <= 65536), 232 and 40 up to 128 columns
// (no spills), 240 and 24 above.
__host__ __device__ constexpr int det_stages(int PB) {
  return PB <= 128 ? 8 : 4;
}
__host__ __device__ constexpr int det_atiles(int PB) {
  return PB <= 128 ? 2 : 3;
}
__host__ __device__ constexpr int det_consumer_regs(int PB) {
  return PB <= 128 ? 232 : 240;
}
__host__ __device__ constexpr int det_producer_regs(int PB) {
  return PB <= 128 ? 40 : 24;
}

// Bytes of the second pass's shared memory at slice width PB: the ring of
// W steps (wr hi, lo, wi hi, lo over PB columns, 32 PB words each), the A
// tiles and the mbarriers.
__host__ __device__ constexpr int detect_smem(int PB) {
  return 4 * (det_stages(PB) * 32 * PB + det_atiles(PB) * kDetATile) +
         8 * (2 * det_stages(PB) + 2 * det_atiles(PB));
}

// An A tile of the second pass: G' rows [k][p2] of 64 depths, Re then Im,
// at a row stride of kDetAS words.
struct KTile {
  const float* a;
};

// Its A fragment at 8-deep step `step` for the thread's rows r, r + 8 and
// quad lane t (depths 2t and 2t + 1 in slots t and t + 4, as the laid
// table's B), split and negated if neg. With the stride 68 (= 4 mod 16)
// the 32 lanes of each of the four loads hit 32 banks.
__device__ __forceinline__ Frag a_frag(const KTile& x, int part, int step,
                                       int r, int t, bool neg) {
  const float* p = x.a + part * kDetAPart + (8 * step + 2 * t) * kDetAS + r;
  return split_frag({p[0], p[8], p[kDetAS], p[kDetAS + 8]}, neg);
}

// p, opaque to the compiler's code motion: loads through it stay after the
// (volatile) products before this move, so the epilogue's table loads are
// not hoisted into the product loop, where their registers would starve
// the wgmma pipeline (ptxas C7511).
__device__ __forceinline__ const float* after_products(const float* p) {
  asm volatile("mov.b64 %0, %0;" : "+l"(p));
  return p;
}

// The second pass's blocks: 64 stacked rows by one W slice each, block b
// taking rows b / nz and slice b % nz.
__host__ __device__ inline int second_pass_blocks(int P, int nbatch) {
  return (nbatch * P + kDetRows - 1) / kDetRows * w_slices(P).nz;
}

// H^T = G'^T W^T, block after block: the block runs blocks blockIdx.x,
// + gridDim.x, ... of the launch's second_pass_blocks, each the stacked
// rows 64 rb.. of the launch's draws (G' in g_re, g_im: nbatch x N x P)
// against slice zb of the laid W table (wpack: nz x N64 / 8 x 4 x 8 PB, N64
// = N rounded up to 64). The producers stream every block's operands in
// turn, running ahead into the next block's while the consumers end this
// one. A consumer thread calls epi(rb, zb, gb, gt) after each block with,
// in gb and gt, rows r and r + 8 of part wg of that block's H^T (wg =
// threadIdx.x / 128, r = 16 (warp % 4) + lane / 4): columns 64 c + 8 i +
// 2t and + 1 of chunk c in gb[c][4 i + 2 h] and [4 i + 2 h + 1] for row
// r + 8 h, the tail's in gt alike (t = lane % 4).
template <int NCH, int TAIL, class Epilogue>
__device__ __forceinline__ void second_pass(
    float* smem, const float* __restrict__ wpack,
    const float* __restrict__ g_re, const float* __restrict__ g_im,
    int nbatch, int N, int P, int nz, Epilogue epi) {
  constexpr int PB = 64 * NCH + TAIL;
  constexpr int kStages = det_stages(PB);
  constexpr int kATiles = det_atiles(PB);
  constexpr int SW = 32 * PB;  // words of a W step
  float* as = smem + kStages * SW;
  uint64_t* bars = reinterpret_cast<uint64_t*>(as + kATiles * kDetATile);
  const Ring<kStages> ring{smem, bars, bars + kStages, SW};
  uint64_t* afull = bars + 2 * kStages;  // A tile s landed
  uint64_t* aempty = afull + kATiles;    // A tile s read by the 8 warps
  const int tid = threadIdx.x;
  const int NC = (N + kDetDepth - 1) / kDetDepth;  // A tiles a block
  const int nblk = second_pass_blocks(P, nbatch);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kDetConsumers / 32);
    }
    for (int s = 0; s < kATiles; ++s) {
      mbar_init(&afull[s], 32 * kDetAWarps);
      mbar_init(&aempty[s], kDetConsumers / 32);
    }
    mbar_init_fence();
  }
  // what no copy writes (depths past N, rows past the last draw) must be
  // finite: it meets W's zero padding or a masked row
  for (int e = tid; e < kATiles * kDetATile; e += kDetThreads) as[e] = 0.0f;
  __syncthreads();

  if (tid >= kDetConsumers) {
    setmaxnreg_dec<det_producer_regs(PB)>();
    const int pw = (tid - kDetConsumers) >> 5, lane = tid & 31;
    if (pw == 0 && lane == 0) {
      // W: each block's slice, its 8-deep steps in the consumers' order
      uint32_t it = 0;
      for (int b = blockIdx.x; b < nblk; b += gridDim.x) {
        const float* wz = wpack + static_cast<size_t>(b % nz) * NC * 8 * SW;
        for (int q = 0; q < 8 * NC; ++q, ++it)
          ring.load(it, wz + static_cast<size_t>(q) * SW, 4 * SW);
      }
    } else if (pw >= 1) {
      // A: 16-byte pieces by the three other warps; piece e of a tile is
      // part e & 1, rows 4 ((e >> 1) & 15).. of the block, depth e >> 5.
      // Each thread's arrival on the tile's full barrier waits for its
      // pieces to land.
      const int ta = tid - kDetConsumers - 32;
      uint32_t at_tile = 0;
      for (int b = blockIdx.x; b < nblk; b += gridDim.x) {
        const int R0 = b / nz * kDetRows;
        const int rows = min(kDetRows, nbatch * P - R0);
        for (int c = 0; c < NC; ++c, ++at_tile) {
          const int s = at_tile % kATiles;
          mbar_wait(&aempty[s], ((at_tile / kATiles) & 1) ^ 1);
          const int kn = min(kDetDepth, N - c * kDetDepth);
          float* dst = as + s * kDetATile;
          for (int e = ta; e < 32 * kn; e += 32 * kDetAWarps) {
            const int q = 4 * ((e >> 1) & 15), k = e >> 5;
            if (q >= rows) continue;
            const int j = (R0 + q) / P, p2 = R0 + q - j * P;
            cp_async(dst + (e & 1) * kDetAPart + k * kDetAS + q,
                     ((e & 1) ? g_im : g_re) +
                         (static_cast<size_t>(j) * N + c * kDetDepth + k) * P +
                         p2,
                     true, true);
          }
          cp_async_mbar_arrive(&afull[s]);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<det_consumer_regs(PB)>();
  const int wg = tid >> 7, lane = tid & 31, t = lane & 3;
  const int r = ((tid >> 5) & 3) * 16 + (lane >> 2);
  float gb[NCH > 0 ? NCH : 1][32], gt[(TAIL > 0 ? TAIL : 16) / 2];
  uint32_t it = 0, at_tile = 0;
  for (int b = blockIdx.x; b < nblk; b += gridDim.x) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int v = 0; v < 32; ++v) gb[c][v] = 0.0f;
#pragma unroll
    for (int v = 0; v < TAIL / 2; ++v) gt[v] = 0.0f;
    for (int c = 0; c < NC; ++c, ++at_tile, it += 8) {
      const int s = at_tile % kATiles;
      mbar_wait(&afull[s], (at_tile / kATiles) & 1);
      tile_products<NCH, TAIL>(gb, gt, KTile{as + s * kDetATile}, ring, it,
                               wg, r, t, [](int) {});
      __syncwarp();
      if (lane == 0) mbar_arrive(&aempty[s]);
    }
    epi(b / nz, b % nz, gb, gt);
  }
}

// Calls f(col, v0, v1, h) for each column pair the thread holds after a
// block of the second pass: values v0, v1 at columns col, col + 1 of the
// slice, row r + 8 h.
template <int NCH, int TAIL, class F>
__device__ __forceinline__ void for_each_ht(
    const float (&gb)[NCH > 0 ? NCH : 1][32],
    const float (&gt)[(TAIL > 0 ? TAIL : 16) / 2], int t, F f) {
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(64 * c + 8 * i + 2 * t, gb[c][4 * i + 2 * h],
          gb[c][4 * i + 2 * h + 1], h);
#pragma unroll
  for (int i = 0; i < TAIL / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f(64 * NCH + 8 * i + 2 * t, gt[4 * i + 2 * h], gt[4 * i + 2 * h + 1],
        h);
}

// The detect pass: a persistent block a SM (second_pass), detect_smem(PB)
// bytes of dynamic shared memory. pm_t (P, P); sh_t nullptr or (nbatch, 2,
// P, P), the transposed real and imaginary subharmonic screens; part
// (nbatch, P / 16, nz, 4): each warp's sums of its 16 rows over a slice.
template <int NCH, int TAIL>
__global__ void __launch_bounds__(kDetThreads, 1)
    detect_pass(const float* __restrict__ wpack,
                const float* __restrict__ g_re,
                const float* __restrict__ g_im,
                const float* __restrict__ pm_t,
                const float* __restrict__ sh_t, float* __restrict__ part,
                int nbatch, int N, int P, int nz) {
  constexpr int PB = 64 * NCH + TAIL;
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x, wg = (tid >> 7) & 1, lane = tid & 31;
  const auto epi = [&](int rb, int zb, const auto& gb, const auto& gt) {
    const int R = rb * kDetRows + ((tid >> 5) & 3) * 16;  // the warp's rows
    const int j = R / P, p2w = R - j * P;
    if (j >= nbatch) return;  // the whole warp: rows past the last draw
    const float* pm = after_products(pm_t);
    const float* sh =
        sh_t == nullptr
            ? nullptr
            : after_products(sh_t) + (static_cast<size_t>(j) * 2 + wg) * P * P;
    const int p2 = p2w + (lane >> 2);
    float acc[2] = {0.0f, 0.0f};
    for_each_ht<NCH, TAIL>(gb, gt, lane & 3, [&](int col, float v0, float v1,
                                                 int h) {
      const int p1 = zb * PB + col;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (p1 + e >= P) continue;
        const int idx = (p1 + e) * P + p2 + 8 * h;
        float v = e ? v1 : v0;
        if (sh != nullptr) v += sh[idx];
        float s, c;
        sincos_cw(v, &s, &c);
        const float w = pm[idx];
        acc[0] = fmaf(w, c, acc[0]);
        acc[1] = fmaf(w, s, acc[1]);
      }
    });
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    if (lane == 0) {
      float* o =
          part +
          ((static_cast<size_t>(j) * (P / 16) + p2w / 16) * nz + zb) * 4 +
          2 * wg;
      o[0] = acc[0];
      o[1] = acc[1];
    }
  };
  second_pass<NCH, TAIL>(smem, wpack, g_re, g_im, nbatch, N, P, nz, epi);
}

// The screens pass: blocks as the detect pass's; scr_re and scr_im
// (nbatch, npup, npup) un-padded, un-transposed screens, scr[j][p2][p1] =
// H[p1][p2] = H^T[p2][p1].
template <int NCH, int TAIL>
__global__ void __launch_bounds__(kDetThreads, 1)
    screens_pass(const float* __restrict__ wpack,
                 const float* __restrict__ g_re,
                 const float* __restrict__ g_im, float* __restrict__ scr_re,
                 float* __restrict__ scr_im, int nbatch, int N, int P,
                 int nz, int npup) {
  constexpr int PB = 64 * NCH + TAIL;
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x, wg = (tid >> 7) & 1, lane = tid & 31;
  const bool even = (npup & 1) == 0;  // column pairs 8-byte aligned
  const auto epi = [&](int rb, int zb, const auto& gb, const auto& gt) {
    const int R = rb * kDetRows + ((tid >> 5) & 3) * 16;
    const int j = R / P, p2w = R - j * P;
    if (j >= nbatch) return;
    float* out =
        (wg ? scr_im : scr_re) + static_cast<size_t>(j) * npup * npup;
    const int p2 = p2w + (lane >> 2);
    for_each_ht<NCH, TAIL>(gb, gt, lane & 3, [&](int col, float v0, float v1,
                                                 int h) {
      const int p1 = zb * PB + col;
      if (p1 >= npup || p2 + 8 * h >= npup) return;
      float* o = out + static_cast<size_t>(p2 + 8 * h) * npup + p1;
      if (even) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (p1 + 1 < npup) o[1] = v1;
      }
    });
  };
  second_pass<NCH, TAIL>(smem, wpack, g_re, g_im, nbatch, N, P, nz, epi);
}

// out[j][c] = sum over the tiles, in tile order, of part[j][tile][c].
__global__ void sum_tiles(const float* __restrict__ part,
                          float* __restrict__ out, int n4, int ntiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float* p = part + static_cast<size_t>(i >> 2) * ntiles * 4 + (i & 3);
  float s = 0.0f;
  for (int t = 0; t < ntiles; ++t) s += p[4 * t];
  out[i] = s;
}

// Partial sums a draw of the detect pass: one per 16 rows and slice.
inline int detect_parts(int P) { return P / 16 * w_slices(P).nz; }

// Whether the second pass takes nbatch draws of an (N, P) G' at these
// addresses (bulk copies: 16-byte aligned).
inline bool second_pass_takes(int P, int nbatch, int N, const float* wpack,
                              const float* g_re, const float* g_im) {
  return pass2_takes(P) && nbatch > 0 && N > 0 && wpack != nullptr &&
         static_cast<long long>(nbatch) * P <= 0x7fffffffLL - kDetRows &&
         ((reinterpret_cast<uintptr_t>(wpack) |
           reinterpret_cast<uintptr_t>(g_re) |
           reinterpret_cast<uintptr_t>(g_im)) & 15) == 0;
}

// The second pass's grid: one persistent block a SM (a block takes one
// SM's registers), at most one a block of work.
inline dim3 second_pass_grid(int P, int nbatch) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int nblk = second_pass_blocks(P, nbatch);
  return dim3(nblk < sms ? nblk : sms);
}

// Launch the detect pass for a padded pupil P: the sums of nbatch draws
// into out (nbatch, 4), through part, a (nbatch, detect_parts(P), 4)
// scratch. wpack: the laid W table (ops/synth_detect.py, laid_w). A
// template, so that only the sources that launch it build its kernels
// (ar_flow.cu includes this header for pupil_tiles).
template <int kUnused = 0>
cudaError_t launch_detect(int P, int nbatch, const float* wpack,
                          const float* g_re, const float* g_im,
                          const float* pm_t, const float* sh_t, float* part,
                          float* out, int N, cudaStream_t stream) {
  if (!second_pass_takes(P, nbatch, N, wpack, g_re, g_im) || part == nullptr)
    return cudaErrorInvalidValue;
  const WSlices w = w_slices(P);
  const dim3 grid = second_pass_grid(P, nbatch);
  cudaError_t err = cudaSuccess;
#define FAST_DETECT(PB)                                                     \
  case PB: {                                                                \
    auto* k = detect_pass<PB / 64, PB % 64>;                                \
    err = cudaFuncSetAttribute(                                             \
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, detect_smem(PB));   \
    if (err != cudaSuccess) return err;                                     \
    k<<<grid, kDetThreads, detect_smem(PB), stream>>>(                      \
        wpack, g_re, g_im, pm_t, sh_t, part, nbatch, N, P, w.nz);           \
    break;                                                                  \
  }
  FAST_PB_SWITCH(w.PB, FAST_DETECT)
#undef FAST_DETECT
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_tiles<<<(4 * nbatch + 255) / 256, 256, 0, stream>>>(
      part, out, 4 * nbatch, detect_parts(P));
  return cudaGetLastError();
}

// Launch the screens pass for a padded pupil P: the screens of nbatch
// draws into scr_re and scr_im (nbatch, npup, npup), npup <= P.
template <int kUnused = 0>
cudaError_t launch_screens(int P, int nbatch, const float* wpack,
                           const float* g_re, const float* g_im,
                           float* scr_re, float* scr_im, int N, int npup,
                           cudaStream_t stream) {
  if (!second_pass_takes(P, nbatch, N, wpack, g_re, g_im) || npup <= 0 ||
      npup > P)
    return cudaErrorInvalidValue;
  const WSlices w = w_slices(P);
  const dim3 grid = second_pass_grid(P, nbatch);
  cudaError_t err = cudaSuccess;
#define FAST_SCREENS(PB)                                                    \
  case PB: {                                                                \
    auto* k = screens_pass<PB / 64, PB % 64>;                               \
    err = cudaFuncSetAttribute(                                             \
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, detect_smem(PB));   \
    if (err != cudaSuccess) return err;                                     \
    k<<<grid, kDetThreads, detect_smem(PB), stream>>>(                      \
        wpack, g_re, g_im, scr_re, scr_im, nbatch, N, P, w.nz, npup);       \
    break;                                                                  \
  }
  FAST_PB_SWITCH(w.PB, FAST_SCREENS)
#undef FAST_SCREENS
  return cudaGetLastError();
}

}  // namespace fast
