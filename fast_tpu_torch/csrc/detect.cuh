// The detect pass that the iid kernels K1, K2 and K3 end with, and the
// tiled product it shares with K7's screens pass.
//
// Detect pass (pass 2 of the three iid kernels): from a draw's G' (N x P,
// real and imaginary parts) it forms the transposed screens H = W G' (P x P
// complex; Re H and Im H are two screens), adds the transposed subharmonic
// screens if given, and reduces
//   sum(pm_t * cos/sin(Re H)), sum(pm_t * cos/sin(Im H))
// in a fixed order (warp shuffles, then the 8 warp partials), so a run is
// reproducible bit for bit on one card.
//
// Any pupil width. A block holds one (16 PJ x 16 PJ) tile of H in its
// registers, PJ x PJ complex values a thread, so a tile is at most 128 px
// wide. A pupil of up to 128 px (padded to P = 16 PJ) is one tile, one block
// per draw, which writes the draw's four sums itself. A wider pupil is cut
// into T x T tiles, T = ceil(P / 128), of width 16 ceil(P / 16 / T), the
// last one ragged and masked; a block per (draw, tile) writes the tile's
// four partial sums into a scratch and sum_tiles adds them per draw in tile
// order: no atomics, the same sums from run to run. K7's screens_pass
// (synth_detect.cu) is the same tiled product, written out as screens.

#pragma once

#include "common.cuh"

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

// One (16 PJ x 16 PJ) tile of H = W G' for one draw, summed over the depth
// N through shared memory: rows r0.. of W against columns c0.. of the
// draw's G' (gr, gi: N x P). Thread (tx, ty) = (tid & 15, tid >> 4) gets,
// for a, b < PJ, in hr[a][b] and hi[a][b]
//   kSwap false: H[r0 + ty + 16 a][c0 + tx + 16 b]
//   kSwap true:  H[r0 + tx + 16 b][c0 + ty + 16 a]  (a tile of H^T, whose
//                rows then run along tx)
// Rows of W and columns of G' past P and depth past N read as zeros. kOne:
// the tile is the whole pupil, P = 16 PJ, known to the compiler.
template <int PJ, bool kSwap, bool kOne>
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
        if (kSwap) {
          ar[a] = sgr[kk * TP + ty + 16 * a];
          ai[a] = sgi[kk * TP + ty + 16 * a];
          br[a] = swr[kk * WS + tx + 16 * a];
          bi[a] = swi[kk * WS + tx + 16 * a];
        } else {
          ar[a] = swr[kk * WS + ty + 16 * a];
          ai[a] = swi[kk * WS + ty + 16 * a];
          br[a] = sgr[kk * TP + tx + 16 * a];
          bi[a] = sgi[kk * TP + tx + 16 * a];
        }
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

// The detect pass: block (j, tile) of a (nbatch, T * T) grid. g_re/g_im:
// (nbatch, N, P) per launch; sh_t: nullptr or (nbatch, 2, P, P), the
// transposed real and imaginary subharmonic screens; out: (nbatch, T * T,
// 4), the tile's sums (the draw's own where T = 1).
template <int PJ, bool kOne>
__global__ void __launch_bounds__(kThreads)
    detect_pass(const float* __restrict__ wr, const float* __restrict__ wi,
                const float* __restrict__ g_re, const float* __restrict__ g_im,
                const float* __restrict__ pm_t, const float* __restrict__ sh_t,
                float* __restrict__ out, int N, int P_rt, int T) {
  constexpr int TP = 16 * PJ;
  __shared__ float red[kThreads / 32][4];

  const int P = kOne ? TP : P_rt;
  const int j = blockIdx.x;
  const int tile = kOne ? 0 : blockIdx.y;
  const int r0 = kOne ? 0 : tile / T * TP, c0 = kOne ? 0 : tile % T * TP;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  float hr[PJ][PJ], hi[PJ][PJ];
  tile_product<PJ, false, kOne>(wr, wi, g_re + static_cast<size_t>(j) * N * P,
                                g_im + static_cast<size_t>(j) * N * P, N, P,
                                r0, c0, hr, hi);

  const float* sh_r =
      sh_t == nullptr ? nullptr : sh_t + static_cast<size_t>(j) * 2 * P * P;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int a = 0; a < PJ; ++a)
#pragma unroll
    for (int b = 0; b < PJ; ++b) {
      const int p1 = r0 + ty + 16 * a, p2 = c0 + tx + 16 * b;
      if (!kOne && (p1 >= P || p2 >= P)) continue;
      const int idx = p1 * P + p2;
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
#define FAST_DETECT(PJ, ONE)                            \
  detect_pass<PJ, ONE><<<grid, kThreads, 0, stream>>>(  \
      wr, wi, g_re, g_im, pm_t, sh_t, sums, N, P, t.T)
  FAST_TILE_SWITCH(t, FAST_DETECT)
#undef FAST_DETECT
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || t.T == 1) return err;
  sum_tiles<<<(4 * nbatch + 255) / 256, 256, 0, stream>>>(part, out,
                                                          4 * nbatch,
                                                          t.T * t.T);
  return cudaGetLastError();
}

}  // namespace fast
