// The detect pass that the iid kernels K1, K2 and K3 end with, and the
// tiled fp32 FMA product that K7's screens pass keeps.
//
// Detect pass (pass 2 of the three iid kernels): from a draw's G' (N x P,
// real and imaginary parts) it forms the transposed screens H = W G' (P x P
// complex; Re H and Im H are two screens), adds the transposed subharmonic
// screens if given, and reduces
//   sum(pm_t * cos/sin(Re H)), sum(pm_t * cos/sin(Im H))
// in a fixed order (each thread's terms, warp shuffles, then the 8 warp
// partials), so a run is reproducible bit for bit on one card.
//
// Any pupil width. A block holds one (16 PJ x 16 PJ) tile of H in its
// registers, so a tile is at most 128 px wide. A pupil of up to 128 px
// (padded to P = 16 PJ) is one tile, one block per draw, which writes the
// draw's four sums itself. A wider pupil is cut into T x T tiles, T =
// ceil(P / 128), of width 16 ceil(P / 16 / T), the last one ragged and
// masked; a block per (draw, tile) writes the tile's four partial sums
// into a scratch and sum_tiles adds them per draw in tile order: no
// atomics, the same sums from run to run.
//
// H = W G' on the tensor cores (mma_tile_product): warp-level
// mma.sync.m16n8k8 TF32 in three passes (3xTF32, tf32x3.cuh), Re H = Wr Gr
// - Wi Gi and Im H = Wr Gi + Wi Gr as real products with -Wi's sign flipped
// in its fragment; each step's six products of an output block a sum of
// their own, added in fp32. W and G' are staged raw by cp.async; the block
// splits each W slice once (every warp of a block row reads it), the warps
// split G' as they form its fragments. The C interfaces take no scratch, so
// W is split per block, not once per call.
//
// What bounds it (H100 80GB HBM3, 700 W; scripts/torch_colfac_ab.py and
// scripts/torch_colfac_variants.py): the tensor cores. At 1024^2 with a
// 402 px pupil (4 x 4 tiles of 112 px) it takes 20.6 ms per 630 draws
// (40.5 TFLOP/s over the 402 px; fp32 FMA 44.5 ms, 19), at one TF32 pass
// 13.1; at 512^2 with 82 px (one tile) 3.25-3.34 ms per 4096 (34 TFLOP/s;
// fp32 FMA 4.50), at one TF32 pass 2.10. ptxas: 198 registers at PJ = 6,
// 248 at PJ = 7 (tiles of 112 px), no spills. K7's screens_pass
// (synth_detect.cu) keeps the fp32 FMA tile_product below.

#pragma once

#include "common.cuh"
#include "tf32x3.cuh"

namespace fast {

// The tiles of the pupil axis: T tiles of width 16 * PJ cover the padded
// width P (a multiple of 16).
struct PupilTiles {
  int T, PJ;
};

inline PupilTiles pupil_tiles(int P) {
  const int T = (P + 127) / 128;
  return {T, (P / 16 + T - 1) / T};
}

// One (16 PJ x 16 PJ) tile of H = W G' for one draw in fp32 FMA (K7's
// screens pass), summed over the depth N through shared memory: rows r0..
// of W against columns c0.. of the draw's G' (gr, gi: N x P). Thread
// (tx, ty) = (tid & 15, tid >> 4) gets, for a, b < PJ, in hr[a][b] and
// hi[a][b] H[r0 + tx + 16 b][c0 + ty + 16 a]: a tile of H^T, whose rows
// then run along tx. Rows of W and columns of G' past P and depth past N
// read as zeros. kOne: the tile is the whole pupil, P = 16 PJ, known to the
// compiler.
template <int PJ, bool kOne>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ wr, const float* __restrict__ wi,
    const float* __restrict__ gr, const float* __restrict__ gi, int N,
    int P_rt, int r0, int c0, float (&hr)[PJ][PJ], float (&hi)[PJ][PJ]) {
  constexpr int TP = 16 * PJ;
  constexpr int WS = TP + 1;
  __shared__ float swr[kK2 * WS], swi[kK2 * WS];
  __shared__ float sgr[kK2 * TP], sgi[kK2 * TP];
  const int P = kOne ? TP : P_rt;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

#pragma unroll
  for (int a = 0; a < PJ; ++a)
#pragma unroll
    for (int b = 0; b < PJ; ++b) hr[a][b] = hi[a][b] = 0.0f;

  for (int kb = 0; kb < N; kb += kK2) {
    __syncthreads();
    for (int e = tid; e < TP * kK2; e += kThreads) {
      const int p = e / kK2, kk = e - p * kK2;
      const bool in = kb + kk < N && r0 + p < P;
      const size_t at = static_cast<size_t>(r0 + p) * N + kb + kk;
      swr[kk * WS + p] = in ? wr[at] : 0.0f;
      swi[kk * WS + p] = in ? wi[at] : 0.0f;
    }
    for (int e = tid; e < kK2 * TP; e += kThreads) {
      const int kk = e / TP, pp = e - kk * TP;
      const bool in = kb + kk < N && c0 + pp < P;
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
        ar[a] = sgr[kk * TP + ty + 16 * a];
        ai[a] = sgi[kk * TP + ty + 16 * a];
        br[a] = swr[kk * WS + tx + 16 * a];
        bi[a] = swi[kk * WS + tx + 16 * a];
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
}

// ---- the detect pass on the tensor cores ---------------------------------

constexpr int kDD = 32;        // depth of one staged slice of the detect pass
constexpr int kDWS = kDD + 8;  // shared row stride of its raw W slices

// Words of one raw slice of the detect pass at tile width 16 PJ: the tile's
// rows of wr and wi, kDD deep (row stride kDWS), then kDD rows of the
// draw's Re G' and Im G' over the tile's columns (row stride 16 PJ + 4).
__host__ __device__ constexpr int detect_slice_words(int PJ) {
  return 2 * 16 * PJ * kDWS + 2 * kDD * (16 * PJ + 4);
}

// Words of one slice of W split into the A fragments' order: for each m16
// row block, 8-deep step and lane, Re hi, Re lo, Im hi, Im lo, 4 words each.
__host__ __device__ constexpr int detect_wsplit_words(int PJ) {
  return PJ * (kDD / 8) * 32 * 16;
}

// Bytes of the detect pass's dynamic shared memory: two raw slices (one
// lands while the other is used) and the split W of one.
inline int detect_smem(int PJ) {
  return static_cast<int>(sizeof(float) * (2 * detect_slice_words(PJ) +
                                           detect_wsplit_words(PJ)));
}

// How the 8 warps of a detect block cover the (16 PJ x 16 PJ) tile of H,
// PJ m16 row blocks of W by 2 PJ n8 column blocks of G': a WR x WC grid,
// warp w taking the row blocks (w / WC) MA .. and the column blocks
// (w % WC) NB ... Even PJ: 2 x 4, PJ / 2 x PJ / 2 blocks a warp; odd PJ:
// 1 x 8, every row block by 2 column blocks (PJ = 7, 112 px tiles of a
// 402 px pupil: 7 warps busy, 14 blocks each), so that no warp holds more
// blocks than another and the accumulators fit without spills.
template <int PJ>
struct DetectWarps {
  static constexpr int WR = PJ % 2 == 0 ? 2 : 1;
  static constexpr int WC = 8 / WR;
  static constexpr int LWC = WC == 8 ? 3 : 2;  // log2(WC)
  static constexpr int MA = (PJ + WR - 1) / WR;
  static constexpr int NB = (2 * PJ + WC - 1) / WC;
};

// One (16 PJ x 16 PJ) tile of H = W G' for one draw on the tensor cores
// (3xTF32 mma.sync.m16n8k8): rows r0.. of W against columns c0.. of the
// draw's G' (gr, gi: N x P), summed over the depth N in slices of kDD. W
// and G' are staged raw by cp.async, one slice landing while the other is
// used. W is read by every warp of a block row (4 or 8), so the block
// splits each landed W slice once into hi and lo in the A fragments'
// order (a 16-byte shared load a lane per fragment part); each warp splits
// the G' elements of its B fragments, which at most two warps read, as it
// forms them. Lane (g, t) of warp w gets, for its row block i and column
// block j,
//   hr[i][j][v], hi[i][j][v] = Re, Im H[r0 + 16 (i0 + i) + g + 8 (v >> 1)]
//                                       [c0 + 8 (j0 + j) + 2 t + (v & 1)]
// with i0 = (w / WC) MA, j0 = (w % WC) NB (DetectWarps). Rows of W and
// columns of G' past P and depth past N read as zeros. kOne: the tile is
// the whole pupil, P = 16 PJ, known to the compiler.
//
// Each 8-deep step's products of one output block, Re H += Wr Gr - Wi Gi
// and Im H += Wr Gi + Wi Gr in three TF32 passes each (the small terms
// first, then a_hi b_hi), are a sum of their own in fresh accumulators,
// added to hr, hi in fp32: nothing long stays in the tensor cores'
// accumulators, which round toward zero (tf32x3.cuh; synth_detect.cu).
// Depth slots: lane t of a quad holds depths 2t and 2t + 1 of the step in
// A and B alike (fragment slots t and t + 4).
template <int PJ, bool kOne>
__device__ __forceinline__ void mma_tile_product(
    float* smem, const float* __restrict__ wr, const float* __restrict__ wi,
    const float* __restrict__ gr, const float* __restrict__ gi, int N,
    int P_rt, int r0, int c0,
    float (&hr)[DetectWarps<PJ>::MA][DetectWarps<PJ>::NB][4],
    float (&hi)[DetectWarps<PJ>::MA][DetectWarps<PJ>::NB][4]) {
  using Warps = DetectWarps<PJ>;
  constexpr int MA = Warps::MA, NB = Warps::NB;
  constexpr int TP = 16 * PJ;
  constexpr int GS = TP + 4;  // shared row stride of the G' slices
  constexpr int SW = detect_slice_words(PJ);
  constexpr int KS = kDD / 8;  // 8-deep steps of a slice
  uint4* ws = reinterpret_cast<uint4*>(smem + 2 * SW);  // split W
  const int P = kOne ? TP : P_rt;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = (warp >> Warps::LWC) * MA;
  const int j0 = (warp & (Warps::WC - 1)) * NB;
  // rows 16-byte aligned: copy them in 16-byte pieces (P is a multiple of 16)
  const bool vw = (N & 3) == 0 &&
                  ((reinterpret_cast<uintptr_t>(wr) |
                    reinterpret_cast<uintptr_t>(wi)) & 15) == 0;
  const bool vg = ((reinterpret_cast<uintptr_t>(gr) |
                    reinterpret_cast<uintptr_t>(gi)) & 15) == 0;

#pragma unroll
  for (int i = 0; i < MA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) hr[i][j][v] = hi[i][j][v] = 0.0f;

  // slice s into raw buffer s & 1: rows r0.. of wr, wi at depths s kDD..;
  // rows s kDD.. of gr, gi at columns c0..
  const auto stage = [&](int s) {
    float* b = smem + (s & 1) * SW;
    const int kb = s * kDD;
    stage_tile<kDWS, kDD>(b, wr, r0, TP, P, N, kb, vw);
    stage_tile<kDWS, kDD>(b + TP * kDWS, wi, r0, TP, P, N, kb, vw);
    stage_tile<GS, TP>(b + 2 * TP * kDWS, gr, kb, kDD, N, P, c0, vg);
    stage_tile<GS, TP>(b + 2 * TP * kDWS + kDD * GS, gi, kb, kDD, N, P, c0,
                       vg);
    cp_async_commit();
  };

  const int nsl = (N + kDD - 1) / kDD;
  stage(0);
  for (int s = 0; s < nsl; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // slice s visible to all; slice s - 1 used by all
    if (s + 1 < nsl) stage(s + 1);
    const float* swr = smem + (s & 1) * SW;
    const float* swi = swr + TP * kDWS;
    const float* sgr = swr + 2 * TP * kDWS;
    const float* sgi = sgr + kDD * GS;
    // W's A fragments, split: unit (row block mi, step ks, lane) holds rows
    // 16 mi + g and + 8 at depths 8 ks + 2t (slots t) and + 1 (slots t + 4)
    for (int u = tid; u < PJ * KS * 32; u += kThreads) {
      const int ul = u & 31, mk = u >> 5;
      const int at = (16 * (mk / KS) + (ul >> 2)) * kDWS + 8 * (mk % KS) +
                     2 * (ul & 3);
      uint4* dst = ws + 4 * 32 * mk + ul;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float* w = c ? swi : swr;
        const float2 x0 = *reinterpret_cast<const float2*>(w + at);
        const float2 x1 = *reinterpret_cast<const float2*>(w + at + 8 * kDWS);
        uint4 h, l;
        split(x0.x, h.x, l.x);
        split(x1.x, h.y, l.y);
        split(x0.y, h.z, l.z);
        split(x1.y, h.w, l.w);
        dst[(2 * c) * 32] = h;
        dst[(2 * c + 1) * 32] = l;
      }
    }
    __syncthreads();  // the split W visible to all
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // B fragments of the warp's column blocks: G' rows 8 ks + 2t and
      // + 1, column 8 (j0 + j) + g
      uint32_t brh[NB][2], brl[NB][2], bih[NB][2], bil[NB][2];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j0 + j >= 2 * PJ) break;
        const int at = (8 * ks + 2 * t) * GS + 8 * (j0 + j) + g;
        split(sgr[at], brh[j][0], brl[j][0]);
        split(sgr[at + GS], brh[j][1], brl[j][1]);
        split(sgi[at], bih[j][0], bil[j][0]);
        split(sgi[at + GS], bih[j][1], bil[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MA; ++i) {
        if (i0 + i >= PJ) break;
        // A fragments of row block i0 + i; nh, nl: -Wi
        const uint4* a = ws + 4 * 32 * ((i0 + i) * KS + ks) + lane;
        const uint4 rh4 = a[0], rl4 = a[32], ih4 = a[64], il4 = a[96];
        const uint32_t arh[4] = {rh4.x, rh4.y, rh4.z, rh4.w};
        const uint32_t arl[4] = {rl4.x, rl4.y, rl4.z, rl4.w};
        const uint32_t aih[4] = {ih4.x, ih4.y, ih4.z, ih4.w};
        const uint32_t ail[4] = {il4.x, il4.y, il4.z, il4.w};
        uint32_t nh[4], nl[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          nh[v] = aih[v] ^ 0x80000000u;
          nl[v] = ail[v] ^ 0x80000000u;
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if (j0 + j >= 2 * PJ) break;
          float d[4];
          mma_tf32_new(d, arl, brh[j]);
          mma_tf32(d, arh, brl[j]);
          mma_tf32(d, nl, bih[j]);
          mma_tf32(d, nh, bil[j]);
          mma_tf32(d, arh, brh[j]);
          mma_tf32(d, nh, bih[j]);
#pragma unroll
          for (int v = 0; v < 4; ++v) hr[i][j][v] += d[v];
          mma_tf32_new(d, arl, bih[j]);
          mma_tf32(d, arh, bil[j]);
          mma_tf32(d, ail, brh[j]);
          mma_tf32(d, aih, brl[j]);
          mma_tf32(d, arh, bih[j]);
          mma_tf32(d, aih, brh[j]);
#pragma unroll
          for (int v = 0; v < 4; ++v) hi[i][j][v] += d[v];
        }
      }
    }
  }
}

// The detect pass: block (j, tile) of a (nbatch, T * T) grid, 8 warps,
// detect_smem(PJ) bytes of dynamic shared memory. g_re/g_im: (nbatch, N,
// P) per launch; sh_t: nullptr or (nbatch, 2, P, P), the transposed real
// and imaginary subharmonic screens; out: (nbatch, T * T, 4), the tile's
// sums (the draw's own where T = 1).
template <int PJ, bool kOne>
__global__ void __launch_bounds__(kThreads, 1)
    detect_pass(const float* __restrict__ wr, const float* __restrict__ wi,
                const float* __restrict__ g_re, const float* __restrict__ g_im,
                const float* __restrict__ pm_t, const float* __restrict__ sh_t,
                float* __restrict__ out, int N, int P_rt, int T) {
  constexpr int MA = DetectWarps<PJ>::MA, NB = DetectWarps<PJ>::NB;
  constexpr int TP = 16 * PJ;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kThreads / 32][4];

  const int P = kOne ? TP : P_rt;
  const int j = blockIdx.x;
  const int tile = kOne ? 0 : blockIdx.y;
  const int r0 = kOne ? 0 : tile / T * TP, c0 = kOne ? 0 : tile % T * TP;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid >> 2) & 7, t = tid & 3;
  const int i0 = (warp >> DetectWarps<PJ>::LWC) * MA;
  const int j0 = (warp & (DetectWarps<PJ>::WC - 1)) * NB;

  float hr[MA][NB][4], hi[MA][NB][4];
  mma_tile_product<PJ, kOne>(smem, wr, wi,
                             g_re + static_cast<size_t>(j) * N * P,
                             g_im + static_cast<size_t>(j) * N * P, N, P, r0,
                             c0, hr, hi);

  const float* sh_r =
      sh_t == nullptr ? nullptr : sh_t + static_cast<size_t>(j) * 2 * P * P;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int a = 0; a < MA; ++a) {
    if (i0 + a >= PJ) break;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (j0 + b >= 2 * PJ) break;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int p1 = r0 + 16 * (i0 + a) + g + 8 * (v >> 1);
        const int p2 = c0 + 8 * (j0 + b) + 2 * t + (v & 1);
        if (!kOne && (p1 >= P || p2 >= P)) continue;
        const int idx = p1 * P + p2;
        const float w = pm_t[idx];
        float h1 = hr[a][b][v], h2 = hi[a][b][v];
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
    }
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
    out[(static_cast<size_t>(j) * gridDim.y + tile) * 4 + tid] = s;
  }
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

// Launch the detect pass for a padded pupil P: the sums of nbatch draws
// into out (nbatch, 4), through part, the (nbatch, T * T, 4) scratch of a
// pupil over 128 px (unused, and may be nullptr, up to 128 px).
inline cudaError_t launch_detect(int P, int nbatch, const float* wr,
                                 const float* wi, const float* g_re,
                                 const float* g_im, const float* pm_t,
                                 const float* sh_t, float* part, float* out,
                                 int N, cudaStream_t stream) {
  const PupilTiles t = pupil_tiles(P);
  if (!pass2_takes(P) || (t.T > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid(nbatch, t.T * t.T);
  float* sums = t.T == 1 ? out : part;
  cudaError_t err = cudaSuccess;
#define FAST_DETECT(PJ, ONE)                                              \
  {                                                                       \
    auto* k_detect = detect_pass<PJ, ONE>;                                \
    err = cudaFuncSetAttribute(                                           \
        k_detect, cudaFuncAttributeMaxDynamicSharedMemorySize,            \
        detect_smem(PJ));                                                 \
    if (err != cudaSuccess) return err;                                   \
    k_detect<<<grid, kThreads, detect_smem(PJ), stream>>>(                \
        wr, wi, g_re, g_im, pm_t, sh_t, sums, N, P, t.T);                 \
  }
  FAST_TILE_SWITCH(t, FAST_DETECT)
#undef FAST_DETECT
  err = cudaGetLastError();
  if (err != cudaSuccess || t.T == 1) return err;
  sum_tiles<<<(4 * nbatch + 255) / 256, 256, 0, stream>>>(part, out,
                                                          4 * nbatch,
                                                          t.T * t.T);
  return cudaGetLastError();
}

}  // namespace fast
