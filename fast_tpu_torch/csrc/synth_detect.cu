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
// What bounds it on the card: arithmetic on the CUDA cores. At N=256, P=82
// (padded to 96) one complex draw costs 4N^3 = 67 MFLOP of mixing product,
// 8N^2 P = 50 MFLOP for G' and 8 P^2 N = 19 MFLOP for H, against 64 KB of
// random bits that never leave the SM and 2 x 96 KB of G'. The fp32
// products are tiled through shared memory by hand; this first version
// uses no tensor cores, and its inner loops are bound by shared-memory
// bandwidth (6 loads per 8 FMAs in the mixing product). At N=1024 with a
// 402 px pupil (padded to 416) the same three terms are 4.3, 3.4 and 1.3
// GFLOP a draw, against 3.4 MB of G' a draw through device memory, and K7
// adds 1.3 MB of screens a draw: operations still bound both.
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
// * Pass 2 is a block per (draw, tile of H of at most 128 x 128): H = W G',
//   then sincos and a fixed-order reduction, so the result is the same
//   from run to run (no atomics). The TPU kernel's k-draw batching has no
//   counterpart here: blocks run in parallel on 132 SMs instead. Pass 2 is
//   detect_pass of detect.cuh, shared with the colfac-detect kernels (K1,
//   K3); K7 ends in screens_pass, the same tiles written out.
// * A pupil over 128 px (a 4 m telescope: 402 px at 1024^2). Pass 1's
//   product has the padded pupil P as its output width. The mixed and
//   coloured x tile is the expensive operand (4N^3 of the draw's FLOPs), so
//   a block makes it once and contracts it with NG = 4 column groups of W^T
//   in turn, each 16 PJ <= 128 wide with accumulators of its own (NG RR PJ
//   complex values a thread; one block per SM, up to 255 registers). Up to
//   512 px that is the whole pupil; wider pupils go to further blocks
//   (blockIdx.z) that make the x tile again. P <= 128 is NG = 1, the kernel
//   as it was.
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

namespace {

using namespace fast;

constexpr int kC = 64;    // column tile of X'
constexpr int kKT = 32;   // depth tile of the mixing product

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

// Pass 1: one block per (draw, 16 * RR rows of X', NG column groups of the
// pupil). Writes G' rows. NG = 1: at least two blocks per SM; without the
// bound ptxas keeps the 'mixed' pass to 64 registers and runs it ~20%
// slower at 256^2 (H100).
template <bool kMixed, int PJ, int RR, int NG>
__global__ void __launch_bounds__(kThreads, NG == 1 ? 2 : 1)
    synth_pass1(uint32_t k0, uint32_t k1, uint32_t stream, int draw0,
                const float* __restrict__ s_t, const float* __restrict__ wr,
                const float* __restrict__ wi, const float* __restrict__ mix,
                float* __restrict__ g_re, float* __restrict__ g_im, int N,
                int P_rt) {
  constexpr int GW = 16 * PJ;  // width of a column group of the pupil
  constexpr int R = 16 * RR;   // rows of X' per block
  constexpr int WS = GW + 1;   // shared row stride of the W tiles
  constexpr int XS = kC + 1;   // shared row stride of the x tile
  const int P = NG == 1 ? GW : P_rt;      // padded pupil, G's row stride
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
  const int pz = NG == 1 ? 0 : blockIdx.z * NG * GW;  // first pupil column
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int r0 = (tid >> 4) * RR;

  float acc_re[NG][RR][PJ], acc_im[NG][RR][PJ];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int rr = 0; rr < RR; ++rr)
#pragma unroll
      for (int jj = 0; jj < PJ; ++jj)
        acc_re[g][rr][jj] = acc_im[g][rr][jj] = 0.0f;

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
          u = mixed_uniform(comp == 0 ? v.x : v.y);
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
            float zc, zs;
            box_muller(v.x, v.y, &zc, &zs);
            x = (comp == 0 ? zc : zs) *
                s_t[static_cast<size_t>(row) * N + col];
          }
          xs[r * XS + cc] = x;
        }
      }
      // comp 0 (x = xr): gr += x wr^T, gi += x wi^T
      // comp 1 (x = xi): gr -= x wi^T, gi += x wr^T
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int p0 = pz + g * GW;
        if (NG > 1) {
          if (p0 >= P) break;
          if (g) __syncthreads();  // the group before still reads wa, wb
        }
        for (int e = tid; e < GW * kC; e += kThreads) {
          const int p = e / kC, cc = e - p * kC;
          float vr = 0.0f, vi = 0.0f;
          if (c0 + cc < N && p0 + p < P) {
            vr = wr[static_cast<size_t>(p0 + p) * N + c0 + cc];
            vi = wi[static_cast<size_t>(p0 + p) * N + c0 + cc];
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
              acc_re[g][rr][jj] = fmaf(x[rr], a, acc_re[g][rr][jj]);
              acc_im[g][rr][jj] = fmaf(x[rr], b, acc_im[g][rr][jj]);
            }
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int rr = 0; rr < RR; ++rr) {
    if (row0 + r0 + rr >= N) continue;
    const size_t base = (static_cast<size_t>(j) * N + row0 + r0 + rr) * P;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int jj = 0; jj < PJ; ++jj) {
        const int p = pz + g * GW + tx + 16 * jj;
        if (NG > 1 && p >= P) continue;
        g_re[base + p] = acc_re[g][rr][jj];
        g_im[base + p] = acc_im[g][rr][jj];
      }
  }
}

// Dynamic shared memory of pass 1. Must match _smem_bytes in
// fast_tpu_torch/ops/synth_detect.py, which picks RR and decides which
// shapes the wrapper takes.
template <bool kMixed>
size_t pass1_smem(int N, int GW, int RR) {
  const int NC = (N + kC - 1) / kC * kC;
  const int R = 16 * RR;
  return sizeof(float) * (R * (kC + 1) + 2 * kC * (GW + 1) +
                          (kMixed ? kKT * kC + R * (NC + 1) : 0));
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
