// K3: colfac-basis noise synthesis and pupil-overlap detection in the split
// layout, for Hopper (sm_90a).
//
// Replaces fast_tpu/ops/pallas_synth.py::_colfac_detect_kernel, the TPU
// kernel behind SYNTH='pallas_colfac' for pupils over 128 px (colfac_layout
// picks 'split' there, 'merged' = K1 below). The process is K1's (see
// colfac_detect.cu): the columns of G = W X are drawn as G[:, m] = L_m z_m
// from the per-column Cholesky factors. Per complex draw j:
//
//   bits   two 32-bit words per noise lane of each column m, LW lanes
//   noise  'mixed': raw uniforms u = (bits >> 8) sqrt(3) 2^-23 - sqrt(3);
//          the orthogonal LW x LW mix is folded into the factor table
//          'gauss': Box-Muller from 24-bit uniforms (live lanes only)
//   factor G'[m, :] = z_m B_m, complex          (1 x Kq) @ (Kq x P)
//            Re G' = z_r B_r - z_i B_i,  Im G' = z_r B_i + z_i B_r
//   DFT    H = W G'                           (P, N) @ (N, P), complex
//   detect sum(pm_t * cos/sin(Re H + sh_r)), sum(pm_t * cos/sin(Im H + sh_i))
//
// B_m = M L_m^T ('mixed', M the LW x LW mixing matrix, LW = the pupil
// rounded up to 128, the TPU kernel's lane width, so that the folded table
// is colfac_pack_tables(..., noise='mixed') transposed) or B_m = L_m^T
// ('gauss', Kq = the padded pupil P).
//
// Lanes, tables, products: what differs from K1.
// * Lanes. K1 draws 128 Philox lanes a column; a 402 px pupil needs 512.
//   Counter of lane q of column m of draw d: (m * LW + q, d, stream, 3);
//   bits1 = out[0] (u_r or u1), bits2 = out[1] (u_i or u2). The last word 3
//   keeps the stream apart from K2 and K7 (0), K1 (1) and the AR kernels
//   (2). The plain torch version builds the same counters.
// * Tables. The split layout stores B_r and B_i once, T (N, Kq, P, 2) with
//   (re, im) interleaved per pupil pixel: 2 N Kq P floats, 1.74 GB at 1024^2
//   with a 402 px pupil (P = 416, Kq = 512), half of K1's real-block form
//   (which stores each part twice to make one real product of it). The
//   four real products are formed here from the one copy.
// * Products. Hand-tiled fp32 FMA, no tensor cores and no library: one
//   block per (64 draws, column m, pupil column group of 16 PJ <= 128 px).
//   The noise of a depth slice of 16 lanes is drawn straight into shared
//   memory, the matching 16 rows of the block's columns of T stream in
//   beside it; each thread holds 4 draws x PJ pixels x (re, im): two
//   16-byte loads of noise and PJ 8-byte loads of T per 16 PJ FMAs. The
//   noise is drawn again by each column group (4 at 402 px): Philox is
//   ~1/5 of a block's work, as in K1.
//
// What bounds it on the card: arithmetic on the CUDA cores. At 1024^2 with
// a 402 px pupil one 'mixed' draw costs N * 2 LW * 2P * 2 = 1.74 GFLOP of
// factor products and 8 P^2 N = 1.42 GFLOP for H, against 1.74 GB of tables
// read once per launch (the draw tiles of one column are adjacent in launch
// order and share its table in L2) and 3.4 MB of G' per draw through device
// memory, as in K1 and K2, whose G' this is: pass 2 is the shared tiled
// detect pass of detect.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "detect.cuh"

namespace {

using namespace fast;

constexpr int kDT = 64;  // draws per pass-1 block
constexpr int kLS = 16;  // lanes per depth slice

// Pass 1: one block per (64 draws, column m, pupil column group). Writes
// G'[j, m, p0 : p0 + 16 PJ].
template <bool kMixed, int PJ>
__global__ void __launch_bounds__(kThreads, 2)
    split_pass1(uint32_t k0, uint32_t k1, uint32_t stream, int draw0,
                int nbatch, const float* __restrict__ tab,
                float* __restrict__ g_re, float* __restrict__ g_im, int N,
                int Kq, int P, int LW) {
  constexpr int GW = 16 * PJ;  // pupil columns per block
  __shared__ __align__(16) float zr[kLS * kDT], zi[kLS * kDT];  // [lane][draw]
  __shared__ __align__(16) float ts[kLS * 2 * GW];  // [lane][pixel][re, im]

  const int m = blockIdx.y;
  const int j0 = blockIdx.x * kDT;
  const int p0 = blockIdx.z * GW;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float2* tm =
      reinterpret_cast<const float2*>(tab) + static_cast<size_t>(m) * Kq * P;

  float acc[4][PJ][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int jj = 0; jj < PJ; ++jj) acc[r][jj][0] = acc[r][jj][1] = 0.0f;

  for (int lb = 0; lb < Kq; lb += kLS) {
    // noise of lanes lb .. lb + 15 for the block's 64 draws; draws past
    // nbatch are zeros
#pragma unroll
    for (int i = 0; i < kLS * kDT / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int l = e / kDT, d = e - l * kDT;
      float z0 = 0.0f, z1 = 0.0f;
      if (j0 + d < nbatch) {
        const U4 v = philox4x32_10(
            static_cast<uint32_t>(m) * static_cast<uint32_t>(LW) + lb + l,
            static_cast<uint32_t>(draw0 + j0 + d), stream, 3u, k0, k1);
        if (kMixed) {
          z0 = mixed_uniform(v.x);
          z1 = mixed_uniform(v.y);
        } else {
          box_muller(v.x, v.y, &z0, &z1);
        }
      }
      zr[l * kDT + d] = z0;
      zi[l * kDT + d] = z1;
    }
    // rows lb .. lb + 15 of the column's table, pixels p0 .. p0 + GW - 1;
    // pixels past the padded pupil are zeros
    float2* dst = reinterpret_cast<float2*>(ts);
    for (int e = tid; e < kLS * GW; e += kThreads) {
      const int l = e / GW, pp = e - l * GW;
      dst[e] = p0 + pp < P ? tm[static_cast<size_t>(lb + l) * P + p0 + pp]
                           : make_float2(0.0f, 0.0f);
    }
    __syncthreads();
#pragma unroll 4
    for (int l = 0; l < kLS; ++l) {
      const float4 ar = *reinterpret_cast<const float4*>(&zr[l * kDT + 4 * ty]);
      const float4 ai = *reinterpret_cast<const float4*>(&zi[l * kDT + 4 * ty]);
      const float a_r[4] = {ar.x, ar.y, ar.z, ar.w};
      const float a_i[4] = {ai.x, ai.y, ai.z, ai.w};
#pragma unroll
      for (int jj = 0; jj < PJ; ++jj) {
        const float2 b = *reinterpret_cast<const float2*>(
            &ts[(l * GW + tx + 16 * jj) * 2]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][jj][0] = fmaf(a_r[r], b.x, acc[r][jj][0]);
          acc[r][jj][0] = fmaf(-a_i[r], b.y, acc[r][jj][0]);
          acc[r][jj][1] = fmaf(a_r[r], b.y, acc[r][jj][1]);
          acc[r][jj][1] = fmaf(a_i[r], b.x, acc[r][jj][1]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + 4 * ty + r;
    if (j >= nbatch) continue;
    const size_t base = (static_cast<size_t>(j) * N + m) * P;
#pragma unroll
    for (int jj = 0; jj < PJ; ++jj) {
      const int p = p0 + tx + 16 * jj;
      if (p >= P) continue;
      g_re[base + p] = acc[r][jj][0];
      g_im[base + p] = acc[r][jj][1];
    }
  }
}

template <bool kMixed>
cudaError_t launch(uint32_t k0, uint32_t k1, uint32_t stream_id, int draw0,
                   int nbatch, const float* tab, float* g_re, float* g_im,
                   int N, int Kq, int P, int LW, cudaStream_t stream) {
  // the column groups are the tiles of the detect pass
  const PupilTiles t = pupil_tiles(P);
  const dim3 grid((nbatch + kDT - 1) / kDT, N, t.T);
#define FAST_CASE(PJ)                                                  \
  case PJ:                                                             \
    split_pass1<kMixed, PJ><<<grid, kThreads, 0, stream>>>(            \
        k0, k1, stream_id, draw0, nbatch, tab, g_re, g_im, N, Kq, P, LW); \
    break;
  switch (t.PJ) {
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
  return cudaGetLastError();
}

}  // namespace

// Shapes: tab (N, Kq, P, 2) packed factors; wr, wi (P, N); pm_t (P, P);
// sh_t nullptr or (nbatch, 2, P, P) transposed subharmonic screens; g_re,
// g_im scratch (nbatch, N, P); part scratch (nbatch, T * T, 4) for a pupil
// over 128 px (T = ceil(P / 128)); out (nbatch, 4) = (sum pm cos h1, sum pm
// sin h1, sum pm cos h2, sum pm sin h2). P is a multiple of 16; Kq, the
// noise lanes a column, is a multiple of 16, at most LW, the lane stride of
// the Philox counter. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int fast_colfac_split(uint32_t k0, uint32_t k1, uint32_t stream_id,
                                 int draw0, int nbatch, const float* tab,
                                 const float* wr, const float* wi,
                                 const float* pm_t, const float* sh_t,
                                 float* g_re, float* g_im, float* part,
                                 float* out, int N, int P, int Kq, int LW,
                                 int mixed, void* stream) {
  if (N <= 0 || N > 65535 || nbatch <= 0 ||
      Kq <= 0 || Kq % kLS != 0 || Kq > LW || !pass2_takes(P) ||
      static_cast<uint64_t>(N) * static_cast<uint64_t>(LW) > 0xFFFFFFFFull)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      mixed ? launch<true>(k0, k1, stream_id, draw0, nbatch, tab, g_re, g_im,
                           N, Kq, P, LW, st)
            : launch<false>(k0, k1, stream_id, draw0, nbatch, tab, g_re, g_im,
                            N, Kq, P, LW, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_detect(P, nbatch, wr, wi, g_re, g_im, pm_t,
                                        sh_t, part, out, N, st));
}

extern "C" const char* fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
