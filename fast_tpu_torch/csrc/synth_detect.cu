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
// pupil (padded to 416) 4.3 and 3.4 GFLOP against 1.3. Pass 2 is the
// second pass of detect.cuh, H^T = G'^T W^T on wgmma with the draws
// stacked along the 64-row axis: detect_pass (shared with K1 and K3) for
// K2, screens_pass for K7, which stores Re H^T and Im H^T.
//
// Pass 1 on the tensor cores. Both of its products run as Hopper's
// warpgroup products, wgmma.mma_async m64nNk8 TF32 (wgmma.cuh), each in
// three passes (3xTF32) at PRECISION 'high' and 'highest': every operand
// element x is split once into hi = tf32(x) and lo = tf32(x - hi), rounded
// as cvt.rna.tf32.f32 rounds (nearest, ties away), and each 8-deep step
// computes a_lo b_hi + a_hi b_lo (the small terms) and a_hi b_hi. hi + lo
// carries 22 of fp32's 24 bits and the dropped lo lo term is below fp32's
// rounding. At 'default' each product is one TF32 pass, a_hi b_hi, from
// tables laid out with their hi planes alone (the JAX package's 'default'
// is one bf16 pass). The C entries take the pass count, 1 or 3.
//
// Sums. The tensor cores round their sums toward zero, so a sum kept in
// their accumulators shrinks by about half an ulp a step, the same way for
// every element of a screen (kept over 64-deep tiles, 24 products, that
// drifted the 256^2 flagship's sums past the kernel-vs-plain limit, H100).
// So a fold group of two 8-deep steps is a fresh accumulator that takes
// the small terms of both steps first and then their a_hi b_hi, and is
// added to an fp32 sum (round to nearest) when it lands; two groups are in
// flight, so the fold of one overlaps the other's products
// (wgmma.wait_group 1): the two groups of a chunk of the mixing product,
// the column chunks of a G' step pair. Not across chunks: ptxas cannot
// follow a group in flight around the loop and then serializes every
// wgmma of the kernel (its warning C7514; 256^2 'mixed' 8.97 ms against
// 7.23 in scripts/torch_pass1_variants.py). The A fragments and
// accumulators are fenced (fence_regs) before each group's wgmma.fence,
// else ptxas injects fences of its own. tests/test_torch_tf32x3.py models
// this order of sums (pass1_sums): K2's sums at 0.05-0.09 of the limit at
// 64^2 and 128^2, G' at 0.05-0.10 of its own; the hi products kept over
// the whole depth read over the limit where the fold groups read 0.26 of
// it. On the card K2 reads 0.05-0.29 of the limit (chip_smoke.py).
//
// The design, a block per (draw, 64 rows of X', slice of PB <= 208 pupil
// columns): two consumer warpgroups and a producer warpgroup (setmaxnreg:
// 240 registers a consumer thread, 24 a producer thread).
// * B operands pre-split and pre-laid, once per configuration
//   (ops/synth_detect.py, laid_w; the engine keeps the LaidW on the card,
//   a wrapper given plain wr, wi lays them out for the call): the mixing
//   matrix in 64-column tiles of 32-deep slices and wr^T, wi^T in 8-deep
//   steps of the block's pupil slice, each as hi and lo in wgmma's
//   core-matrix layout, so a stage of the ring is one contiguous block.
//   The second pass reads the same W table. The kernel splits no B
//   operand.
// * Asynchronous copies. One producer thread streams the stages into a
//   ring of 4 slots with cp.async.bulk; each completes on its slot's full
//   mbarrier, and the 8 consumer warps release the slot on its empty one
//   once their products that read it have landed.
// * A from registers. The noise is formed per 64 x 64 tile of X' (column
//   tile c): with 'mixed' noise, warpgroup w makes component w's z = u @
//   M[:, 64c:64c + 64] over the whole depth, u read from chunks of both
//   components' uniforms that all 256 consumer threads make in shared
//   memory, one Philox call per grid point; then x = z * s_t goes to the
//   x tile. With 'gauss' noise the consumers make the next x tile
//   (Box-Muller * s_t) while the products of this one run. Then G' += x
//   W^T over the tile's 64-deep slice: warpgroup 0 Re G' (xr wr^T and
//   -xi wi^T, the sign flipped in the A fragment, exactly), warpgroup 1
//   Im G' (xr wi^T + xi wr^T), in column chunks of 64 and a tail. A
//   fragments come from shared tiles whose float pairs are swizzled by row
//   (conflict-free 64-bit loads) and are split in registers.
// * Depth slots. Lane t of a quad holds depths 2t and 2t + 1 of a step in
//   A slots t and t + 4, one 64-bit load; the tables put the same depths
//   in B's slots (the same relabelling of depth in both operands leaves
//   the sum as it is).
// * Uniforms. The flagship's grid (N <= 256 at a 96 px pupil) keeps all
//   chunks of its 64 rows' uniforms in shared memory, made once during
//   the first column tile; wider grids keep two and remake them for every
//   column tile (Philox is counter-based: the same bits).
// * A pupil over 208 px is cut into nz slices, each its own block. With
//   'mixed' noise and two slices (the 4 m link: 416 px in two of 208) the
//   two blocks of a draw's rows are a cluster: each makes every other
//   column tile's x and writes it into both blocks' shared memory
//   (st.shared::cluster), with an mbarrier pair per x slot, so the noise
//   and the mixing product are made once for the pupil.
// * Pass 2 is a block per (64 stacked (draw, p2) rows, W slice): H^T =
//   G'^T W^T, then sincos and a fixed-order reduction, so the result is the
//   same from run to run (no atomics); K7 ends in screens_pass, the same
//   product written out (detect.cuh). On wgmma it takes K2 at 256^2 from
//   9.17-9.27 to 8.59-8.62 ms a 4096 draws and K7 at 1024^2 with the
//   402 px pupil from 75.9-76.0 to 44.3-44.4 ms a 630, its screens pass
//   from 42.1-42.4 to 10.2 (scripts/torch_detect_ab.py; H100 80GB HBM3,
//   700 W).
//
// What bounds pass 1 (H100 80GB HBM3, 700 W; scripts/torch_pass1_variants
// .py: the kernel beside copies of itself with one part taken out): the
// work around the products, not the tensor cores nor the copies. At 256^2
// 'mixed' it takes 7.27 ms a 4096 draws (65 TFLOP/s of fp32-accurate
// products), 5.03 with one TF32 product a step, 4.34 with no products at
// all, 6.92 without the split, 5.92 with Philox replaced by a hash and
// 7.04 with half the bytes copied: the tensor cores' time (about 1.1 ms a
// TF32 pass, ~87% of their peak while they run) and the rest (noise,
// fragment loads and splits, folds, barriers, with two consumer
// warpgroups a SM) add up rather than overlap. At 1024^2 with the 402 px
// pupil, 139.0 ms a 630 draws, the uniforms remade for every column tile
// cost most: 81.5 with a hash for Philox, 80.7 with no products, 99.5
// with one product.
//
// The noise a tile ahead (synth_pass1_ahead). At one TF32 pass the
// products of a block (64 rows of one draw at 256^2 with the 82 px
// pupil: 29.4 MFLOP, ~7.8 us of the tensor cores at peak) take less time
// than its noise (16,384 Philox4x32-10 calls, ~5.7 us at the integer
// multipliers' rate) and the work around both, and in synth_pass1 the
// consumers make every uniform in the first column tile's mixing loop,
// between their own products. So 'mixed' noise at one pass over one
// pupil slice of at most 96 columns, where every chunk of uniforms is
// kept (the flagship's case), takes a kernel of its own: warps of three
// roles in a persistent block an SM that walks the launch's (draw, 64
// rows) tiles.
// * Two noise warpgroups (48 registers a thread) make the uniforms of the
//   block's tiles, chunk after chunk, into a ring of nkc + 2 chunk slots
//   where they fit (10 at the flagship: 160 KB of the 229,600 B), each
//   slot on a full and an empty mbarrier, rounded to TF32 as the
//   consumers' one-pass A fragments take them. A slot is free once the
//   last column tile's mixing loop has read its chunk, so the noise
//   warps make the next tile's first two chunks while this tile's column
//   tiles run and the other six as the last one releases this tile's:
//   about a quarter of a tile, which is why they are 8 warps, not 4.
// * The two consumer warpgroups (176 registers a thread) only load A
//   fragments, issue wgmma and fold, write x = z * s_t (as TF32) and G';
//   a chunk is a wait on its full barrier, not a Philox loop and a named
//   barrier.
// * One producer thread streams the ring's stages, tile after tile.
// The arithmetic is synth_pass1's: the same Philox counters and bits, the
// same fold groups folded in the same order, the same x and G'; only who
// makes the noise and when differ, so G' is the same bit for bit
// (scripts/torch_pass1_ab.py compares digests of G' across checkouts).
// takes_ahead is the rule; ops/synth_detect.py, pass1_route, mirrors it.
// On the H100 (700 W), per 4,096 draws at 256^2, 'default' (ms): with
// one noise warpgroup at 72 registers and the consumers at 208, 4.549
// against synth_pass1's 5.009, 3.454 with no products and 3.384 with a
// hash for Philox (scripts/torch_pass1_variants.py --cell): the noise
// bounded it; with two noise warpgroups 3.85-3.94 (at 176/48 and
// 168/56), while one at 72 with the consumers at 184 or 168 read 4.34-4.56.

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
#include "wgmma.cuh"

namespace {

using namespace fast;

constexpr int kRows = 64;       // rows of X' a block: a warpgroup's wgmma M
constexpr int kZC = 64;         // column tile of X' (and of z), the depth of
                                // G' += x W^T per tile
constexpr int kKU = 32;         // depth of a chunk of uniforms and of a staged
                                // slice of the mixing matrix
constexpr int kStages = 4;      // B stages in the ring
constexpr int kConsumers = 256;                  // two warpgroups
constexpr int kPass1Threads = kConsumers + 128;  // and the producer's
constexpr int kConsumerRegs = 240;  // registers a thread: 2 x 128 x 240 +
constexpr int kProducerRegs = 24;   // 128 x 24 <= 65536
constexpr int kUChunk = 2 * kRows * kKU;  // words of a chunk of uniforms
constexpr int kSmemLimit = 232448;        // bytes of shared memory a block

// Words of a mixing slice: 4 steps x {hi, lo} (or {hi} at one pass) x 64
// columns x 8.
__host__ __device__ constexpr int mix_stage_words(int kPasses) {
  return 4 * b_planes(kPasses) * kZC * 8;
}

// Words of a W stage: one 8-deep step of wr and wi, hi and lo (or hi at
// one pass), over PB columns.
__host__ __device__ constexpr int w_stage_words(int PB, int kPasses) {
  return 16 * b_planes(kPasses) * PB;
}

// Words of one ring slot: a W stage or, with 'mixed' noise, a slice of
// the mixing matrix, whichever is larger.
__host__ __device__ constexpr int pass1_slot_words(bool mixed, int PB,
                                                   int kPasses) {
  return (mixed && mix_stage_words(kPasses) > w_stage_words(PB, kPasses))
             ? mix_stage_words(kPasses)
             : w_stage_words(PB, kPasses);
}

// x tiles a block holds: one with 'mixed' noise, two with 'gauss' (the
// next tile is made while one is used) or for a pair of blocks (each makes
// every other tile, for both).
__host__ __device__ constexpr int pass1_x_tiles(bool mixed, bool pair) {
  return mixed && !pair ? 1 : 2;
}

constexpr int kBars = 2 * kStages + 4;  // the ring's and the x slots'

// Bytes of pass 1's shared memory: the ring, the x tiles, nbuf chunks of
// uniforms ('mixed') and the mbarriers. _smem_bytes of
// fast_tpu_torch/ops/synth_detect.py mirrors it.
__host__ __device__ constexpr int pass1_smem(bool mixed, int PB, int nbuf,
                                             bool pair, int kPasses) {
  return 4 * (kStages * pass1_slot_words(mixed, PB, kPasses) +
              pass1_x_tiles(mixed, pair) * kXTile +
              (mixed ? nbuf * kUChunk : 0)) +
         8 * kBars;
}

// Chunks of uniforms a block keeps: all of them (made once, in its first
// column tile) where they fit, else two, remade for every column tile.
int pass1_u_chunks(int N, int PB, bool pair, int kPasses) {
  const int nkc = (N + kKU - 1) / kKU;
  return pass1_smem(true, PB, nkc, pair, kPasses) <= kSmemLimit ? nkc : 2;
}

// ---- the noise -------------------------------------------------------------

// Pairs i0 and i0 + kStride of a 'mixed' chunk of uniforms: rows row0..,
// grid columns col0.. (32 a chunk, 16 pairs a row), both components from
// one Philox call per grid point, into chunk buffer u (component 0, then
// 1); kTf32: each rounded to TF32 (to_tf32) as a one-pass A fragment
// takes it, so that its reader need not round it.
template <int kStride = kConsumers, bool kTf32 = false>
__device__ __forceinline__ void make_uniforms(float* u, int i0, int row0,
                                              int col0, int N, uint32_t draw,
                                              uint32_t stream, uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = i0 + h * kStride;
    const int r = e >> 4, f = e & 15;
    const int row = row0 + r;
    float a[2] = {0.0f, 0.0f}, b[2] = {0.0f, 0.0f};
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int col = col0 + 2 * f + v;
      if (row < N && col < N) {
        const U4 w = philox4x32_10(static_cast<uint32_t>(row * N + col),
                                   draw, stream, 0u, k0, k1);
        a[v] = mixed_uniform(w.x);
        b[v] = mixed_uniform(w.y);
        if (kTf32) {
          a[v] = __uint_as_float(to_tf32(a[v]));
          b[v] = __uint_as_float(to_tf32(b[v]));
        }
      }
    }
    *reinterpret_cast<float2*>(u + swz(r, f, kKU)) = make_float2(a[0], a[1]);
    *reinterpret_cast<float2*>(u + kRows * kKU + swz(r, f, kKU)) =
        make_float2(b[0], b[1]);
  }
}

// Pairs i0 and i0 + 256 of a 'gauss' x tile: x = Box-Muller noise * s_t,
// both components from one Philox call per grid point, into x (Re, then
// Im; 32 pairs a row).
__device__ __forceinline__ void make_gauss(float* x, int i0, int row0,
                                           int col0, int N, uint32_t draw,
                                           uint32_t stream, uint32_t k0,
                                           uint32_t k1,
                                           const float* __restrict__ s_t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = i0 + h * kConsumers;
    const int r = e >> 5, f = e & 31;
    const int row = row0 + r;
    float a[2] = {0.0f, 0.0f}, b[2] = {0.0f, 0.0f};
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int col = col0 + 2 * f + v;
      if (row < N && col < N) {
        const U4 w = philox4x32_10(static_cast<uint32_t>(row * N + col),
                                   draw, stream, 0u, k0, k1);
        float zc, zs;
        box_muller(w.x, w.y, &zc, &zs);
        const float s = s_t[static_cast<size_t>(row) * N + col];
        a[v] = zc * s;
        b[v] = zs * s;
      }
    }
    *reinterpret_cast<float2*>(x + swz(r, f, kZC)) = make_float2(a[0], a[1]);
    *reinterpret_cast<float2*>(x + kRows * kZC + swz(r, f, kZC)) =
        make_float2(b[0], b[1]);
  }
}

// ---- pass 1 ----------------------------------------------------------------

// G' rows r, r + 8 (of the tile at row0) of draw j into gout (nbatch, N,
// P) from a consumer's sums: columns p0 + 64c + 8i + 2t, + 1 of each
// 64-column chunk c (gb) and of the tail (gt).
template <int NCH, int TAIL>
__device__ __forceinline__ void store_gprime(
    float* __restrict__ gout, const float (&gb)[NCH > 0 ? NCH : 1][32],
    const float (&gt)[(TAIL > 0 ? TAIL : 16) / 2], int j, int row0, int r,
    int t, int p0, int N, int P) {
  const auto put = [&](int col, float v0, float v1, int h) {
    const int row = row0 + r + 8 * h, p = p0 + col;
    if (row < N && p < P)
      *reinterpret_cast<float2*>(
          gout + (static_cast<size_t>(j) * N + row) * P + p) =
          make_float2(v0, v1);
  };
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put(64 * c + 8 * i + 2 * t, gb[c][4 * i + 2 * h],
            gb[c][4 * i + 2 * h + 1], h);
#pragma unroll
  for (int i = 0; i < TAIL / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      put(64 * NCH + 8 * i + 2 * t, gt[4 * i + 2 * h], gt[4 * i + 2 * h + 1],
          h);
}

// Pass 1: one block per (draw, 64 rows of X', slice of PB = 64 NCH + TAIL
// pupil columns). Consumer warpgroup w makes component w of the noise's
// mixing product and then part w of G' (0 Re, 1 Im) for the slice; one
// thread of the producer warpgroup streams the B stages in the consumers'
// order. kPair: the block and the other slice's block of the same rows
// are a cluster and make every other column tile's x for both. Products
// in kPasses TF32 passes from tables laid out for them. Writes G'.
template <bool kMixed, bool kPair, int NCH, int TAIL, int kPasses>
__global__ void __launch_bounds__(kPass1Threads, 1)
    synth_pass1(uint32_t k0, uint32_t k1, uint32_t stream, int draw0,
                const float* __restrict__ s_t,
                const float* __restrict__ wpack,
                const float* __restrict__ mpack, float* __restrict__ g_re,
                float* __restrict__ g_im, int N, int P, int nbuf) {
  constexpr int PB = 64 * NCH + TAIL;
  constexpr int TW = TAIL > 0 ? TAIL : 16;  // the tail's wgmma width
  constexpr int kPl = b_planes(kPasses);
  constexpr int kMStage = mix_stage_words(kPasses);
  constexpr int kWStage = w_stage_words(PB, kPasses);
  extern __shared__ __align__(128) float smem[];
  const int slot_words = pass1_slot_words(kMixed, PB, kPasses);
  float* xs = smem + kStages * slot_words;          // x tiles
  float* us = xs + pass1_x_tiles(kMixed, kPair) * kXTile;  // uniforms
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      us + (kMixed ? nbuf * kUChunk : 0));
  const Ring<kStages> ring{smem, bars, bars + kStages, slot_words};
  // a pair: x tile c in slot c % 2, made by the pair's block of rank
  // c % 2; xfull[s] completes when its maker has written it into both
  // blocks, xempty[s] when the 16 consumer warps of both have read it
  uint64_t* xfull = bars + 2 * kStages;
  uint64_t* xempty = xfull + 2;
  const int rank = kPair ? cluster_rank() : 0;
  const int cstep = kPair ? 2 : 1;  // column tiles a round

  const int j = blockIdx.x;
  const uint32_t draw = static_cast<uint32_t>(draw0 + j);
  const int row0 = blockIdx.y * kRows;
  const int zb = blockIdx.z;
  const int NC = (N + kZC - 1) / kZC;               // column tiles
  const int nkc = (N + kKU - 1) / kKU;              // chunks of the depth
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumers / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&xfull[s], kConsumers);
      mbar_init(&xempty[s], 2 * kConsumers / 32);
    }
    mbar_init_fence();
  }
  if (kPair)
    cluster_sync();  // the peer's barriers are set up
  else
    __syncthreads();

  if (tid >= kConsumers) {
    // the producer: one thread walks the schedule, each round the mixing
    // slices of the block's own column tile, then the W steps of the
    // round's tiles
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      const float* wz = wpack + static_cast<size_t>(zb) * NC * 8 * kWStage;
      uint32_t it = 0;
      for (int c0 = 0; c0 < NC; c0 += cstep) {
        const int c = c0 + rank;
        if (kMixed && c < NC)
          for (int kc = 0; kc < nkc; ++kc)
            ring.load(it++, mpack + static_cast<size_t>(c * nkc + kc) *
                                        kMStage,
                      4 * kMStage);
        for (int cc = c0; cc < min(c0 + cstep, NC); ++cc)
          for (int q = 0; q < 8; ++q)
            ring.load(it++, wz + static_cast<size_t>(cc * 8 + q) * kWStage,
                      4 * kWStage);
      }
    }
    if (kPair) cluster_sync();  // no block leaves while its peer may write
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid >> 7;                   // component / part of G'
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r = ((tid >> 5) & 3) * 16 + g;   // the thread's rows r, r + 8
  float gb[NCH > 0 ? NCH : 1][32], gt[TW / 2];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int v = 0; v < 32; ++v) gb[c][v] = 0.0f;
#pragma unroll
  for (int v = 0; v < TAIL / 2; ++v) gt[v] = 0.0f;

  // G' += x W^T over the x tile at `x`, stages it.. of the ring
  // (wgmma.cuh): Re G' = xr wr^T - xi wi^T, Im G' = xr wi^T + xi wr^T
  const auto gprime = [&](const float* x, uint32_t it, auto between) {
    tile_products<NCH, TAIL, kPasses>(gb, gt, x, ring, it, wg, r, t,
                                      between);
  };

  uint32_t it = 0;
  if (kMixed) {
    // all chunks of uniforms kept (made in the block's first column tile)
    // or two, remade for every tile
    const bool keep = nbuf >= nkc;
    make_uniforms(us, tid, row0, 0, N, draw, stream, k0, k1);
    make_uniforms(us, tid + 2 * kConsumers, row0, 0, N, draw, stream, k0,
                  k1);
    named_sync(1, kConsumers);
    int q = 0;  // chunks of uniforms used so far
    // a round: the block's own column tile (a pair's blocks make every
    // other one), then G' over the round's tiles
    for (int c0 = 0; c0 < NC; c0 += cstep) {
      const int c = c0 + rank;
      if (c < NC) {
        // z = u @ M[:, 64c : 64c + 64] for component wg
        float z[32];
#pragma unroll
        for (int v = 0; v < 32; ++v) z[v] = 0.0f;
        // a fold group: the A fragments of steps 2h, 2h + 1 of a chunk of
        // uniforms, against the mixing slice ms, into d
        const auto issue = [&](const float* uc, const float* ms, int h,
                               Frag (&a)[1][2], float (&d)[32]) {
          uint64_t bh[1][2], bl[1][2];
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int step = 2 * h + s;
            a[0][s] = load_frag<kPasses>(uc + wg * kRows * kKU, r,
                                         4 * step + t, kKU, false);
            bh[0][s] = b_desc(ms + (kPl * step) * kZC * 8);
            bl[0][s] = b_desc(ms + (kPl * step + 1) * kZC * 8);
          }
          mma_group<64, 1, kPasses>(d, a, bh, bl);
        };
        // both fold groups of a chunk in flight: group 1 is issued before
        // group 0 is folded
        Frag a0[1][2], a1[1][2];
        float d0[32], d1[32];
        for (int kc = 0; kc < nkc; ++kc, ++q, ++it) {
          const float* u = us + (keep ? kc : q & 1) * kUChunk;
          const bool last = kc + 1 == nkc;
          const bool make =
              keep ? (c == rank && !last) : (!last || c + cstep < NC);
          float* un = us + (keep ? kc + 1 : (q + 1) & 1) * kUChunk;
          const int coln = last ? 0 : (kc + 1) * kKU;
          const float* ms = ring.take(it);
          issue(u, ms, 0, a0, d0);
          issue(u, ms, 1, a1, d1);
          if (make)
            make_uniforms(un, tid, row0, coln, N, draw, stream, k0, k1);
          fold<1>(z, d0);
          if (make)
            make_uniforms(un, tid + 2 * kConsumers, row0, coln, N, draw,
                          stream, k0, k1);
          fold(z, d1);
          ring.release(it);
          if (make) named_sync(1, kConsumers);  // the next chunk is made
        }
        // x = z * s_t into the x tile (and the peer's): the thread's z
        // holds rows r, r + 8, columns 8i + 2t, 8i + 2t + 1 of the tile
        float* x = xs + rank * kXTile + wg * kRows * kZC;
        if (kPair)  // both blocks have read the slot's previous tile
          mbar_wait_cluster(&xempty[rank], ((c >> 1) & 1) ^ 1);
        else
          named_sync(1, kConsumers);  // the previous tile's x is read
        const uint32_t xp = kPair ? peer_addr(x, rank ^ 1) : 0u;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + r + 8 * h, col = c * kZC + 8 * i + 2 * t;
            float s0 = 0.0f, s1 = 0.0f;
            if (row < N) {
              const float* sr = s_t + static_cast<size_t>(row) * N;
              if (col < N) s0 = sr[col];
              if (col + 1 < N) s1 = sr[col + 1];
            }
            const int at = swz(r + 8 * h, 4 * i + t, kZC);
            const float2 v =
                make_float2(z[4 * i + 2 * h] * s0, z[4 * i + 2 * h + 1] * s1);
            *reinterpret_cast<float2*>(x + at) = v;
            if (kPair) st_peer(xp + 4 * at, v);
          }
        if (kPair) {
          mbar_arrive(&xfull[rank]);
          mbar_arrive_peer(peer_addr(&xfull[rank], rank ^ 1));
        } else {
          named_sync(1, kConsumers);  // both components written
        }
      }
      for (int cc = c0; cc < min(c0 + cstep, NC); ++cc, it += 8) {
        const int sl = cc & (cstep - 1);  // the x slot (and its maker)
        if (kPair) mbar_wait_cluster(&xfull[sl], (cc >> 1) & 1);
        gprime(xs + sl * kXTile, it, [](int) {});
        if (kPair) {
          __syncwarp();
          if (lane == 0) {
            if (sl == rank)
              mbar_arrive(&xempty[sl]);
            else
              mbar_arrive_peer(peer_addr(&xempty[sl], sl));
          }
        }
      }
    }
  } else {
    // the x tile of column tile c + 1 is made, a quarter a fold group,
    // while tile c's products run
    make_gauss(xs, tid, row0, 0, N, draw, stream, k0, k1, s_t);
    make_gauss(xs, tid + 2 * kConsumers, row0, 0, N, draw, stream, k0, k1,
               s_t);
    make_gauss(xs, tid + 4 * kConsumers, row0, 0, N, draw, stream, k0, k1,
               s_t);
    make_gauss(xs, tid + 6 * kConsumers, row0, 0, N, draw, stream, k0, k1,
               s_t);
    named_sync(1, kConsumers);
    for (int c = 0; c < NC; ++c, it += 8) {
      float* xn = xs + ((c + 1) & 1) * kXTile;
      const bool more = c + 1 < NC;
      gprime(xs + (c & 1) * kXTile, it, [&](int h) {
        if (more)
          make_gauss(xn, tid + 2 * h * kConsumers, row0, (c + 1) * kZC, N,
                     draw, stream, k0, k1, s_t);
      });
      named_sync(1, kConsumers);
    }
  }

  store_gprime<NCH, TAIL>(wg ? g_im : g_re, gb, gt, j, row0, r, t,
                          zb * PB, N, P);
  if (kPair) cluster_sync();
}

// ---- pass 1 with the noise a tile ahead --------------------------------------

constexpr int kNoiseThreads = 256;  // two noise warpgroups
constexpr int kAheadThreads = kConsumers + 128 + kNoiseThreads;
// Registers a thread, within the 96 a thread of 640 starts with:
// 256 x 176 + 128 x 24 + 256 x 48 <= 640 x 96
constexpr int kAheadConsumerRegs = 176;
constexpr int kNoiseRegs = 48;

// Bytes of synth_pass1_ahead's shared memory: the ring, one x tile, nslots
// chunk slots of uniforms and the mbarriers (the ring's and a full and an
// empty one a chunk slot). _ahead_smem_bytes of
// fast_tpu_torch/ops/synth_detect.py mirrors it.
__host__ __device__ constexpr int ahead_smem(int PB, int nslots) {
  return 4 * (kStages * pass1_slot_words(true, PB, 1) + kXTile +
              nslots * kUChunk) +
         8 * (2 * kStages + 2 * nslots);
}

// Whether 'mixed' noise at one TF32 pass over one pupil slice takes
// synth_pass1_ahead: where synth_pass1 keeps every chunk of uniforms and
// the slice is at most 96 columns (the flagship's), the widths measured
// on the card; wider slices keep more G' sums live in the consumers' 176
// registers (ptxas spilled 36 bytes at 112). pass1_route of
// fast_tpu_torch/ops/synth_detect.py mirrors it.
bool takes_ahead(int N, int PB, int nz) {
  return nz == 1 && PB <= 96 &&
         pass1_u_chunks(N, PB, false, 1) >= (N + kKU - 1) / kKU;
}

// Chunk slots of synth_pass1_ahead: the grid's chunks and up to two more,
// as many as fit, so that the next tile's first chunks are made while
// this tile's column tiles still read all of its own.
int ahead_slots(int N, int PB) {
  const int nkc = (N + kKU - 1) / kKU;
  int n = nkc + 2;
  while (n > nkc && ahead_smem(PB, n) > kSmemLimit) --n;
  return n;
}

// A one-pass A fragment of load_frag's rows and slots from a tile whose
// values are TF32 already: the bits as stored (to_tf32 leaves them as
// they are), negated if neg.
__device__ __forceinline__ Frag load_tf32(const float* tile, int r, int f,
                                          int words, bool neg) {
  const float2 v0 = *reinterpret_cast<const float2*>(tile + swz(r, f, words));
  const float2 v1 =
      *reinterpret_cast<const float2*>(tile + swz(r + 8, f, words));
  const uint32_t s = neg ? 0x80000000u : 0u;
  Frag a;
  a.h[0] = __float_as_uint(v0.x) ^ s;
  a.h[1] = __float_as_uint(v1.x) ^ s;
  a.h[2] = __float_as_uint(v0.y) ^ s;
  a.h[3] = __float_as_uint(v1.y) ^ s;
#pragma unroll
  for (int v = 0; v < 4; ++v) a.l[v] = 0u;
  return a;
}

// An x tile written as TF32 values; tile_products takes its A through
// this a_frag overload.
struct Tf32X {
  const float* x;
};

template <int kPasses>
__device__ __forceinline__ Frag a_frag(const Tf32X& x, int part, int step,
                                       int r, int t, bool neg) {
  static_assert(kPasses == 1, "a TF32 tile is read at one pass");
  return load_tf32(x.x + part * kXRows * kXDepth, r, 4 * step + t, kXDepth,
                   neg);
}

// Pass 1 for 'mixed' noise at one TF32 pass over one pupil slice of PB =
// 64 NCH + TAIL columns, where every chunk of uniforms is kept: the
// arithmetic of synth_pass1<true, false, NCH, TAIL, 1>, in warps of three
// roles. The block is persistent: block b takes tiles b, b + gridDim.x,
// .. of the launch's nbatch x ceil(N / 64) (draw, 64 rows of X') tiles.
// * Warpgroups 0 and 1, the consumers: per column tile c, component wg's
//   z = u @ M[:, 64c:64c + 64] from the chunk slots, then x = z * s_t into
//   the x tile and part wg of G' over it, as synth_pass1 does; they wait
//   on a chunk's full mbarrier in the first column tile and release it on
//   its empty one after the last, and write the tile's G'.
// * Warpgroup 2: one thread streams the ring's stages, tile after tile.
// * Warpgroups 3 and 4, the noise: the uniforms of the block's tiles chunk
//   after chunk into a ring of nslots chunk slots (chunk q of the block's
//   walk in slot q % nslots), each once its slot is released, rounded to
//   TF32.
//   With nslots = nkc + 2 it makes the next tile's first two chunks while
//   this tile's column tiles run, and the rest as the last column tile
//   releases this tile's.
template <int NCH, int TAIL>
__global__ void __launch_bounds__(kAheadThreads, 1)
    synth_pass1_ahead(uint32_t k0, uint32_t k1, uint32_t stream, int draw0,
                      int nbatch, const float* __restrict__ s_t,
                      const float* __restrict__ wpack,
                      const float* __restrict__ mpack,
                      float* __restrict__ g_re, float* __restrict__ g_im,
                      int N, int P, int nslots) {
  constexpr int PB = 64 * NCH + TAIL;
  constexpr int TW = TAIL > 0 ? TAIL : 16;  // the tail's wgmma width
  constexpr int kMStage = mix_stage_words(1);
  constexpr int kWStage = w_stage_words(PB, 1);
  extern __shared__ __align__(128) float smem[];
  const int slot_words = pass1_slot_words(true, PB, 1);
  float* xs = smem + kStages * slot_words;  // the x tile
  float* us = xs + kXTile;                  // the chunk slots
  uint64_t* bars = reinterpret_cast<uint64_t*>(us + nslots * kUChunk);
  const Ring<kStages> ring{smem, bars, bars + kStages, slot_words};
  uint64_t* ufull = bars + 2 * kStages;  // slot s made
  uint64_t* uempty = ufull + nslots;     // slot s read for the last time

  const int NR = (N + kRows - 1) / kRows;  // row tiles a draw
  const int ntiles = nbatch * NR;
  const int NC = (N + kZC - 1) / kZC;   // column tiles
  const int nkc = (N + kKU - 1) / kKU;  // chunks of the depth
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumers / 32);
    }
    for (int s = 0; s < nslots; ++s) {
      mbar_init(&ufull[s], kNoiseThreads);
      mbar_init(&uempty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers + 128) {
    // the noise: every chunk of every tile in turn, into the next slot
    setmaxnreg_dec<kNoiseRegs>();
    const int i0 = tid - (kConsumers + 128);
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const uint32_t draw = static_cast<uint32_t>(draw0 + tile / NR);
      const int row0 = (tile % NR) * kRows;
      for (int kc = 0; kc < nkc; ++kc) {
        mbar_wait(&uempty[s], ph ^ 1);
        float* u = us + s * kUChunk;
#pragma unroll 1
        for (int m = 0; m < kUChunk / 4; m += 2 * kNoiseThreads)
          make_uniforms<kNoiseThreads, true>(u, i0 + m, row0, kc * kKU, N,
                                             draw, stream, k0, k1);
        mbar_arrive(&ufull[s]);
        if (++s == nslots) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }
  if (tid >= kConsumers) {
    // the producer: one thread walks the schedule, per tile and column
    // tile the mixing slices, then the W steps
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
        for (int c = 0; c < NC; ++c) {
          for (int kc = 0; kc < nkc; ++kc)
            ring.load(it++, mpack + static_cast<size_t>(c * nkc + kc) *
                                        kMStage,
                      4 * kMStage);
          for (int q = 0; q < 8; ++q)
            ring.load(it++, wpack + static_cast<size_t>(c * 8 + q) * kWStage,
                      4 * kWStage);
        }
    }
    return;
  }

  setmaxnreg_inc<kAheadConsumerRegs>();
  const int wg = tid >> 7;                   // component / part of G'
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r = ((tid >> 5) & 3) * 16 + g;   // the thread's rows r, r + 8
  float gb[NCH > 0 ? NCH : 1][32], gt[TW / 2];
  uint32_t it = 0;
  int s0 = 0;        // the slot of the tile's first chunk
  uint32_t ph0 = 0;  // and its phase
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int j = tile / NR;
    const int row0 = (tile % NR) * kRows;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int v = 0; v < 32; ++v) gb[c][v] = 0.0f;
#pragma unroll
    for (int v = 0; v < TAIL / 2; ++v) gt[v] = 0.0f;

    for (int c = 0; c < NC; ++c) {
      // z = u @ M[:, 64c : 64c + 64] for component wg
      float z[32];
#pragma unroll
      for (int v = 0; v < 32; ++v) z[v] = 0.0f;
      // a fold group: the A fragments of steps 2h, 2h + 1 of a chunk of
      // uniforms, against the mixing slice ms, into d
      const auto issue = [&](const float* uc, const float* ms, int h,
                             Frag (&a)[1][2], float (&d)[32]) {
        uint64_t bh[1][2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int step = 2 * h + s;
          a[0][s] = load_tf32(uc + wg * kRows * kKU, r, 4 * step + t, kKU,
                              false);
          bh[0][s] = b_desc(ms + step * kZC * 8);
        }
        mma_group<64, 1, 1>(d, a, bh, bh);
      };
      // both fold groups of a chunk in flight: group 1 is issued before
      // group 0 is folded
      Frag a0[1][2], a1[1][2];
      float d0[32], d1[32];
      const bool last = c + 1 == NC;
      for (int kc = 0; kc < nkc; ++kc, ++it) {
        int s = s0 + kc;
        uint32_t ph = ph0;
        if (s >= nslots) {
          s -= nslots;
          ph ^= 1;
        }
        if (c == 0) mbar_wait(&ufull[s], ph);  // the chunk is made
        const float* u = us + s * kUChunk;
        const float* ms = ring.take(it);
        issue(u, ms, 0, a0, d0);
        issue(u, ms, 1, a1, d1);
        fold<1>(z, d0);
        fold(z, d1);
        ring.release(it);
        if (last) {  // the slot may take the next tile's chunk
          __syncwarp();
          if (lane == 0) mbar_arrive(&uempty[s]);
        }
      }
      // x = z * s_t into the x tile, as TF32: the thread's z holds rows r,
      // r + 8, columns 8i + 2t, 8i + 2t + 1 of the tile; its s_t is loaded
      // before the barrier, so that the loads overlap the wait (loaded
      // after it, pass 1 took 4.615 ms against 3.85-3.89 at the flagship)
      float sv[8][2][2];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + r + 8 * h, col = c * kZC + 8 * i + 2 * t;
          sv[i][h][0] = sv[i][h][1] = 0.0f;
          if (row < N) {
            const float* sr = s_t + static_cast<size_t>(row) * N;
            if (col < N) sv[i][h][0] = sr[col];
            if (col + 1 < N) sv[i][h][1] = sr[col + 1];
          }
        }
      named_sync(1, kConsumers);  // the previous tile's x is read
      float* x = xs + wg * kRows * kZC;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(x + swz(r + 8 * h, 4 * i + t, kZC)) =
              make_float2(
                  __uint_as_float(to_tf32(z[4 * i + 2 * h] * sv[i][h][0])),
                  __uint_as_float(
                      to_tf32(z[4 * i + 2 * h + 1] * sv[i][h][1])));
      named_sync(1, kConsumers);  // both components written
      tile_products<NCH, TAIL, 1>(gb, gt, Tf32X{xs}, ring, it, wg, r, t,
                                  [](int) {});
      it += 8;
    }
    s0 += nkc;
    if (s0 >= nslots) {
      s0 -= nslots;
      ph0 ^= 1;
    }

    store_gprime<NCH, TAIL>(wg ? g_im : g_re, gb, gt, j, row0, r, t, 0, N,
                            P);
  }
}

struct Pass1Args {
  uint32_t k0, k1, stream_id;
  int draw0, nbatch;
  const float *s_t, *wpack, *mpack;
  float *g_re, *g_im;
  int N, P, passes;
  cudaStream_t stream;
};

template <bool kMixed, bool kPair, int NCH, int TAIL, int kPasses>
cudaError_t launch_pass1(const Pass1Args& a, int nz) {
  constexpr int PB = 64 * NCH + TAIL;
  const int nbuf = kMixed ? pass1_u_chunks(a.N, PB, kPair, kPasses) : 0;
  const int smem = pass1_smem(kMixed, PB, nbuf, kPair, kPasses);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto* k_pass1 = synth_pass1<kMixed, kPair, NCH, TAIL, kPasses>;
  cudaError_t err = cudaFuncSetAttribute(
      k_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nbatch, (a.N + kRows - 1) / kRows, nz);
  cfg.blockDim = dim3(kPass1Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = kPair ? 2 : 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, k_pass1, a.k0, a.k1, a.stream_id, a.draw0,
                            a.s_t, a.wpack, a.mpack, a.g_re, a.g_im, a.N,
                            a.P, nbuf);
}

// synth_pass1_ahead over the launch's tiles: one block an SM, or one a
// tile where there are fewer.
template <int NCH, int TAIL>
cudaError_t launch_ahead(const Pass1Args& a) {
  constexpr int PB = 64 * NCH + TAIL;
  const int nslots = ahead_slots(a.N, PB);
  const int smem = ahead_smem(PB, nslots);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto* k_ahead = synth_pass1_ahead<NCH, TAIL>;
  cudaError_t err = cudaFuncSetAttribute(
      k_ahead, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long ntiles =
      static_cast<long long>(a.nbatch) * ((a.N + kRows - 1) / kRows);
  if (ntiles > 0x7FFFFFFF) return cudaErrorInvalidValue;
  k_ahead<<<static_cast<int>(ntiles < sms ? ntiles : sms), kAheadThreads,
            smem, a.stream>>>(a.k0, a.k1, a.stream_id, a.draw0, a.nbatch,
                              a.s_t, a.wpack, a.mpack, a.g_re, a.g_im, a.N,
                              a.P, nslots);
  return cudaGetLastError();
}

// How pass 1 covers the padded pupil P: nz blocks along it, each a slice
// of PB <= 208 columns, the laid W table's (w_slices of detect.cuh).
// 'mixed' noise over two pupil slices (nz = 2, slices of 112 to 208 px)
// runs as pairs: the two slices' blocks of a draw's rows, a cluster of
// two, make the noise once between them. 'mixed' noise at one TF32 pass
// over one slice whose uniforms are all kept takes synth_pass1_ahead
// (takes_ahead), every other case synth_pass1.
template <bool kMixed, int kPasses>
cudaError_t dispatch_pass1(const Pass1Args& a) {
  const WSlices g = w_slices(a.P);
  if constexpr (kMixed && kPasses == 1) {
#define FAST_AHEAD(PB) \
  case PB:             \
    return launch_ahead<PB / 64, PB % 64>(a);
    if (takes_ahead(a.N, g.PB, g.nz)) {
      switch (g.PB) {
        FAST_AHEAD(16)
        FAST_AHEAD(32)
        FAST_AHEAD(48)
        FAST_AHEAD(64)
        FAST_AHEAD(80)
        FAST_AHEAD(96)
      }
      return cudaErrorInvalidValue;
    }
#undef FAST_AHEAD
  }
#define FAST_CASE(PAIR, PB) \
  case PB:                  \
    return launch_pass1<kMixed, PAIR, PB / 64, PB % 64, kPasses>(a, g.nz);
  if constexpr (kMixed) {
    if (g.nz == 2) {
      switch (g.PB) {
        FAST_CASE(true, 112)
        FAST_CASE(true, 128)
        FAST_CASE(true, 144)
        FAST_CASE(true, 160)
        FAST_CASE(true, 176)
        FAST_CASE(true, 192)
        FAST_CASE(true, 208)
      }
      return cudaErrorInvalidValue;
    }
  }
  switch (g.PB) {
    FAST_CASE(false, 16)
    FAST_CASE(false, 32)
    FAST_CASE(false, 48)
    FAST_CASE(false, 64)
    FAST_CASE(false, 80)
    FAST_CASE(false, 96)
    FAST_CASE(false, 112)
    FAST_CASE(false, 128)
    FAST_CASE(false, 144)
    FAST_CASE(false, 160)
    FAST_CASE(false, 176)
    FAST_CASE(false, 192)
    FAST_CASE(false, 208)
  }
#undef FAST_CASE
  return cudaErrorInvalidValue;
}

cudaError_t pass1(const Pass1Args& a) {
  if (a.N <= 0 || !pass2_takes(a.P) || a.nbatch <= 0 ||
      a.wpack == nullptr || w_slices(a.P).nz > 65535 ||
      (a.N + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  return by_passes(a.passes, [&](auto kp) {
    constexpr int kPasses = decltype(kp)::value;
    return a.mpack ? dispatch_pass1<true, kPasses>(a)
                   : dispatch_pass1<false, kPasses>(a);
  });
}

__global__ void sincos_kernel(const float* __restrict__ phi,
                              float* __restrict__ s, float* __restrict__ c,
                              int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) sincos_cw(phi[i], s + i, c + i);
}

}  // namespace

// K2. Shapes: s_t (N, N); pm_t (P, P); wpack, mpack: the laid W table
// and mixing matrix (ops/synth_detect.py, laid_w: W^T in the pupil slices
// of w_slices(P), split and laid out for wgmma, read by both passes; the
// mixing matrix in column tiles of 64); g_re, g_im scratch (nbatch, N, P);
// out (nbatch, 4) = (sum pm cos h1, sum pm sin h1, sum pm cos h2, sum pm
// sin h2); part: scratch (nbatch, P / 16 x nz, 4), the detect pass's
// partial sums (detect_parts). mpack == nullptr selects 'gauss' noise.
// sh_t: nullptr, or (nbatch, 2, P, P) transposed subharmonic screens added
// to (Re H, Im H) before the detector. P must be a multiple of 16. passes:
// the TF32 passes of every product, 1 or 3, which wpack and mpack are laid
// out for. Returns the cudaError_t of the launches (0 on success).
extern "C" int fast_synth_detect(uint32_t k0, uint32_t k1, uint32_t stream_id,
                                 int draw0, int nbatch, const float* s_t,
                                 const float* pm_t, const float* wpack,
                                 const float* mpack, const float* sh_t,
                                 float* g_re, float* g_im, float* part,
                                 float* out, int N, int P, int passes,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = pass1({k0, k1, stream_id, draw0, nbatch, s_t, wpack,
                           mpack, g_re, g_im, N, P, passes, st});
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_detect(passes, P, nbatch, wpack, g_re, g_im,
                                        pm_t, sh_t, part, out, N, st));
}

// Pass 1 alone: G' = X' W^T of nbatch draws into g_re, g_im (nbatch, N,
// P), as K2 (mpack != nullptr: 'mixed' noise) or K7 (mpack == nullptr)
// make it before their second pass. For timing pass 1 and for holding it
// element by element against its plain version. Other arguments as K2's.
extern "C" int fast_synth_pass1(uint32_t k0, uint32_t k1, uint32_t stream_id,
                                int draw0, int nbatch, const float* s_t,
                                const float* wpack, const float* mpack,
                                float* g_re, float* g_im, int N, int P,
                                int passes, void* stream) {
  return static_cast<int>(pass1({k0, k1, stream_id, draw0, nbatch, s_t,
                                 wpack, mpack, g_re, g_im, N, P, passes,
                                 static_cast<cudaStream_t>(stream)}));
}

// 1 where pass 1 of an (N, N) grid and a padded pupil P with 'mixed'
// noise (mixed != 0) at `passes` TF32 passes takes synth_pass1_ahead, 0
// where it takes synth_pass1 (dispatch_pass1's rule).
extern "C" int fast_pass1_ahead(int N, int P, int mixed, int passes) {
  if (N <= 0 || !pass2_takes(P)) return 0;
  const WSlices g = w_slices(P);
  return mixed && passes == 1 && takes_ahead(N, g.PB, g.nz) ? 1 : 0;
}

// K7. Pass 1 with Box-Muller noise, then the screens of the nbatch draws:
// scr_re, scr_im (nbatch, npup, npup), the real and imaginary parts of
// W X W^T cropped to the npup <= P pupil pixels. Other arguments as K2's.
extern "C" int fast_synth_screens(uint32_t k0, uint32_t k1, uint32_t stream_id,
                                  int draw0, int nbatch, const float* s_t,
                                  const float* wpack, float* g_re,
                                  float* g_im, float* scr_re, float* scr_im,
                                  int N, int P, int npup, int passes,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = pass1({k0, k1, stream_id, draw0, nbatch, s_t, wpack,
                           nullptr, g_re, g_im, N, P, passes, st});
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_screens(passes, P, nbatch, wpack, g_re,
                                         g_im, scr_re, scr_im, N, npup, st));
}

// K7's screens pass alone: the screens (nbatch, npup, npup) of nbatch
// draws from their G' (g_re, g_im: nbatch, N, P). For timing the pass and
// holding it element by element against its plain version. Other
// arguments as K7's.
extern "C" int fast_screens_pass(int nbatch, const float* wpack,
                                 const float* g_re, const float* g_im,
                                 float* scr_re, float* scr_im, int N, int P,
                                 int npup, int passes, void* stream) {
  return static_cast<int>(launch_screens(passes, P, nbatch, wpack, g_re,
                                         g_im, scr_re, scr_im, N, npup,
                                         static_cast<cudaStream_t>(stream)));
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
