// K3: colfac-basis noise synthesis and pupil-overlap detection in the split
// layout, for Hopper (sm_90a), its two products on the tensor cores.
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
// * Products, on the tensor cores: warp-level mma.sync.m16n8k8 TF32 in
//   three passes (3xTF32, tf32x3.cuh), each step's products of an output
//   block a sum of their own, added to the block's sums in fp32, as in K1.
//   The complex product is four real ones: [z_r | z_i] against
//   [[B_r, B_i], [-B_i, B_r]], the sign of -z_i flipped in its fragment
//   and B's fragments formed from the one interleaved copy of T.
// * Pass 1 is one block per (64 draws, column m, pupil column group of
//   16 PJ <= 128 px, the tiles of the detect pass): slices of 16 lanes, the
//   noise drawn into shared memory and split as it is drawn, the table's
//   slice landing by cp.async one ahead and split once by the block
//   (split_pairs: every warp row reads each element). The warps split the
//   64 draws and the group's pixels so that each holds as much as another
//   (Pass1Warps). The noise is drawn again by each column group (4 at
//   402 px).
//
// The work. At 1024^2 with a 402 px pupil one 'mixed' draw costs N * 2 LW *
// 2P * 2 = 1.74 GFLOP of factor products and 8 P^2 N = 1.42 GFLOP for H,
// against 1.74 GB of tables read once per launch (the draw tiles of one
// column are adjacent in launch order and share its table in L2) and 3.4
// MB of G' per draw through device memory, as in K1 and K2, whose G' this
// is: pass 2 is the shared tiled detect pass of detect.cuh.
//
// What bounds it now (H100 80GB HBM3, 700 W; scripts/torch_colfac_ab.py
// and scripts/torch_colfac_variants.py): K3 takes 50.97-51.06 ms per
// 630-draw launch (fp32 FMA: 79.19-79.26); pass 1 29.76 ms (35.7 TFLOP/s
// over the 402 px; fp32 FMA 34.64), the detect pass 20.58 (40.5; was
// 44.5). The tensor cores set pass 1's pace: one TF32 pass takes 18.0 ms,
// so the three take 18 of its 30 ms; Philox 4.1 (a hash in its place: 26.0
// ms), drawn four times over, once per column group. Other layouts were no
// faster on the same card: 128 draws a block with one m16 block a warp,
// the noise drawn between the steps (both spill: two blocks a SM leave 128
// registers a thread).

#include <cuda_runtime.h>
#include <stdint.h>

#include "detect.cuh"
#include "tf32x3.cuh"

namespace {

using namespace fast;

constexpr int kDT = 64;       // draws per pass-1 block
constexpr int kLS = 16;       // lanes per depth slice
constexpr int kKS = kLS / 8;  // 8-deep steps of a slice
constexpr int kZS = kLS + 8;  // shared row stride of the noise slice

// Words of pass 1's dynamic shared memory at a column group of 16 PJ px:
// the noise slice, z_r and z_i as TF32 hi and lo parts (kDT draws x kLS
// lanes each); two raw slices of the table (kLS lanes of 16 PJ (re, im)
// pairs, row stride 32 PJ + 4), one landing while the other is used; and
// one slice split into the B fragments' order (split_pairs).
__host__ __device__ constexpr int pass1_words(int PJ) {
  return 4 * kDT * kZS + 2 * kLS * (32 * PJ + 4) + kKS * 2 * PJ * 32 * 8;
}

// How the 8 warps of a pass-1 block cover its 64 draws (4 m16 blocks) by
// 2 PJ pixel blocks of 8 px, each for Re G' and Im G': a WR x WC grid, warp
// w taking the MA m16 blocks from (w >> LWC) MA and the NB pixel blocks
// from (w & (WC - 1)) NB. Even PJ: 2 x 4, 2 m16 blocks by PJ / 2 pixel
// blocks a warp; odd PJ: 4 x 2, one m16 block by PJ pixel blocks: every
// warp as busy as the others.
template <int PJ>
struct Pass1Warps {
  static constexpr int WR = PJ % 2 == 0 ? 2 : 4;
  static constexpr int WC = 8 / WR;
  static constexpr int LWC = WC == 4 ? 2 : 1;  // log2(WC)
  static constexpr int MA = 4 / WR;
  static constexpr int NB = 2 * PJ / WC;
};

// Pass 1: one block per (64 draws, column m, pupil column group of 16 PJ
// px), warps as Pass1Warps, two blocks a SM. Per slice of kLS lanes the
// block draws the noise, split as it is drawn, and splits the landed table
// slice once (split_pairs: each element is read by every warp row); then
// each warp forms its A fragments (z_r, and -z_i for Re G') once a step for
// all its pixel blocks, each B fragment with two 16-byte shared loads.
// Writes G'[j, m, p0 : p0 + 16 PJ].
template <bool kMixed, int PJ>
__global__ void __launch_bounds__(kThreads, 2)
    split_pass1(uint32_t k0, uint32_t k1, uint32_t stream, int draw0,
                int nbatch, const float* __restrict__ tab,
                float* __restrict__ g_re, float* __restrict__ g_im, int N,
                int Kq, int P, int LW) {
  constexpr int GW = 16 * PJ;      // pupil columns per block
  constexpr int TS = 2 * GW + 4;   // shared row stride of the raw slices
  constexpr int NT = 2 * PJ;       // pixel blocks of the group
  using Warps = Pass1Warps<PJ>;
  constexpr int MA = Warps::MA, NB = Warps::NB;
  extern __shared__ __align__(16) float smem[];
  // [draw][lane]: z_r hi, z_r lo, z_i hi, z_i lo
  uint32_t* zs = reinterpret_cast<uint32_t*>(smem);
  float* ts = smem + 4 * kDT * kZS;  // 2 x [lane][pixel][re, im]
  uint4* ps = reinterpret_cast<uint4*>(ts + 2 * kLS * TS);  // split slice

  const int m = blockIdx.y;
  const int j0 = blockIdx.x * kDT;
  const int p0 = blockIdx.z * GW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int d0 = (warp >> Warps::LWC) * 16 * MA;  // the warp's first draw
  const int jb = (warp & (Warps::WC - 1)) * NB;   // its first pixel block
  const float* tm = tab + static_cast<size_t>(m) * Kq * 2 * P;
  // the table's rows 16-byte aligned: copy them in 16-byte pieces
  const bool vec = (reinterpret_cast<uintptr_t>(tab) & 15) == 0;

  // lanes s kLS .. of the column's table, the group's pixels, into raw
  // buffer s & 1; pixels past P are zeros
  const auto stage = [&](int s) {
    stage_tile<TS, 2 * GW>(ts + (s & 1) * kLS * TS, tm, s * kLS, kLS, Kq,
                           2 * P, 2 * p0, vec);
    cp_async_commit();
  };

  float acc[MA][NB][2][4];  // [m16 block][pixel block][re, im][fragment]
#pragma unroll
  for (int a = 0; a < MA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[a][b][0][v] = acc[a][b][1][v] = 0.0f;

  const int nsl = Kq / kLS;
  stage(0);
  for (int s = 0; s < nsl; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // slice s landed; slice s - 1 used by all
    if (s + 1 < nsl) stage(s + 1);
    // the noise of lanes s kLS .. for the block's 64 draws, split; draws
    // past nbatch are zeros
#pragma unroll
    for (int i = 0; i < kLS * kDT / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int l = e % kLS, d = e / kLS;
      float z0 = 0.0f, z1 = 0.0f;
      if (j0 + d < nbatch) {
        const U4 v = philox4x32_10(
            static_cast<uint32_t>(m) * static_cast<uint32_t>(LW) + s * kLS + l,
            static_cast<uint32_t>(draw0 + j0 + d), stream, 3u, k0, k1);
        if (kMixed) {
          z0 = mixed_uniform(v.x);
          z1 = mixed_uniform(v.y);
        } else {
          box_muller(v.x, v.y, &z0, &z1);
        }
      }
      const int at = d * kZS + l;
      split(z0, zs[at], zs[kDT * kZS + at]);
      split(z1, zs[2 * kDT * kZS + at], zs[3 * kDT * kZS + at]);
    }
    split_pairs<kKS, NT, TS>(ps, ts + (s & 1) * kLS * TS);
    __syncthreads();  // noise and split slice visible to all
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      // A fragments: draws d0 + 16 a + g and + 8, lanes 8 ks + 2t (slots
      // t) and + 1 (slots t + 4): z_r (rh, rl), z_i (ih, il), -z_i (nh, nl)
      uint32_t rh[MA][4], rl[MA][4], ih[MA][4], il[MA][4], nh[MA][4],
          nl[MA][4];
#pragma unroll
      for (int a = 0; a < MA; ++a) {
        const uint32_t* zp = zs + (d0 + 16 * a + g) * kZS + 8 * ks + 2 * t;
        load_a(zp, kZS, rh[a]);
        load_a(zp + kDT * kZS, kZS, rl[a]);
        load_a(zp + 2 * kDT * kZS, kZS, ih[a]);
        load_a(zp + 3 * kDT * kZS, kZS, il[a]);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          nh[a][v] = ih[a][v] ^ 0x80000000u;
          nl[a][v] = il[a][v] ^ 0x80000000u;
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        // B fragments of pixel block jb + b: (B_r, B_i), hi and lo
        const int u = (ks * NT + jb + b) * 32 + lane;
        const uint4 r4 = ps[u], i4 = ps[kKS * NT * 32 + u];
        const uint32_t brh[2] = {r4.x, r4.y}, brl[2] = {r4.z, r4.w};
        const uint32_t bih[2] = {i4.x, i4.y}, bil[2] = {i4.z, i4.w};
        // Re G' += z_r B_r - z_i B_i, Im G' += z_r B_i + z_i B_r: each
        // step's products a sum of their own, the small terms first, added
        // to acc in fp32 (tf32x3.cuh)
#pragma unroll
        for (int a = 0; a < MA; ++a) {
          float d[4];
          mma_tf32_new(d, rl[a], brh);
          mma_tf32(d, rh[a], brl);
          mma_tf32(d, nl[a], bih);
          mma_tf32(d, nh[a], bil);
          mma_tf32(d, rh[a], brh);
          mma_tf32(d, nh[a], bih);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[a][b][0][v] += d[v];
          mma_tf32_new(d, rl[a], bih);
          mma_tf32(d, rh[a], bil);
          mma_tf32(d, il[a], brh);
          mma_tf32(d, ih[a], brl);
          mma_tf32(d, rh[a], bih);
          mma_tf32(d, ih[a], brh);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[a][b][1][v] += d[v];
        }
      }
    }
  }
  // fragment (draw g | g + 8 of the m16 block, pixels 2t, 2t + 1 of the
  // pixel block): 32 bytes a quad
#pragma unroll
  for (int a = 0; a < MA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int p = p0 + 8 * (jb + b) + 2 * t;
      if (p >= P) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + d0 + 16 * a + g + 8 * h;
        if (j >= nbatch) continue;
        const size_t at = (static_cast<size_t>(j) * N + m) * P + p;
        *reinterpret_cast<float2*>(g_re + at) =
            make_float2(acc[a][b][0][2 * h], acc[a][b][0][2 * h + 1]);
        *reinterpret_cast<float2*>(g_im + at) =
            make_float2(acc[a][b][1][2 * h], acc[a][b][1][2 * h + 1]);
      }
    }
}

template <bool kMixed, int PJ>
cudaError_t launch_pass1(const dim3& grid, uint32_t k0, uint32_t k1,
                         uint32_t stream_id, int draw0, int nbatch,
                         const float* tab, float* g_re, float* g_im, int N,
                         int Kq, int P, int LW, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float) * pass1_words(PJ));
  auto* k_pass1 = split_pass1<kMixed, PJ>;
  cudaError_t err = cudaFuncSetAttribute(
      k_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k_pass1<<<grid, kThreads, smem, stream>>>(k0, k1, stream_id, draw0, nbatch,
                                            tab, g_re, g_im, N, Kq, P, LW);
  return cudaGetLastError();
}

template <bool kMixed>
cudaError_t launch(uint32_t k0, uint32_t k1, uint32_t stream_id, int draw0,
                   int nbatch, const float* tab, float* g_re, float* g_im,
                   int N, int Kq, int P, int LW, cudaStream_t stream) {
  // the column groups are the tiles of the detect pass
  const PupilTiles t = pupil_tiles(P);
  const dim3 grid((nbatch + kDT - 1) / kDT, N, t.T);
#define FAST_CASE(PJ)                                                      \
  case PJ:                                                                 \
    return launch_pass1<kMixed, PJ>(grid, k0, k1, stream_id, draw0, nbatch, \
                                    tab, g_re, g_im, N, Kq, P, LW, stream);
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
}

bool takes(int N, int P, int nbatch, int Kq, int LW) {
  return N > 0 && N <= 65535 && nbatch > 0 && Kq > 0 && Kq % kLS == 0 &&
         Kq <= LW && pass2_takes(P) &&
         static_cast<uint64_t>(N) * static_cast<uint64_t>(LW) <= 0xFFFFFFFFull;
}

cudaError_t pass1(uint32_t k0, uint32_t k1, uint32_t stream_id, int draw0,
                  int nbatch, const float* tab, float* g_re, float* g_im,
                  int N, int P, int Kq, int LW, int mixed,
                  cudaStream_t stream) {
  return mixed ? launch<true>(k0, k1, stream_id, draw0, nbatch, tab, g_re,
                              g_im, N, Kq, P, LW, stream)
               : launch<false>(k0, k1, stream_id, draw0, nbatch, tab, g_re,
                               g_im, N, Kq, P, LW, stream);
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
  if (!takes(N, P, nbatch, Kq, LW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = pass1(k0, k1, stream_id, draw0, nbatch, tab, g_re,
                                g_im, N, P, Kq, LW, mixed, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_detect(P, nbatch, wr, wi, g_re, g_im, pm_t,
                                        sh_t, part, out, N, st));
}

// Pass 1 alone: G' of nbatch draws into g_re, g_im (nbatch, N, P), as
// fast_colfac_split makes it before its detect pass. For timing the pass
// and holding it element by element against its plain version. Arguments
// as fast_colfac_split's.
extern "C" int fast_split_pass1(uint32_t k0, uint32_t k1, uint32_t stream_id,
                                int draw0, int nbatch, const float* tab,
                                float* g_re, float* g_im, int N, int P,
                                int Kq, int LW, int mixed, void* stream) {
  if (!takes(N, P, nbatch, Kq, LW))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(pass1(k0, k1, stream_id, draw0, nbatch, tab, g_re,
                                g_im, N, P, Kq, LW, mixed,
                                static_cast<cudaStream_t>(stream)));
}

extern "C" const char* fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
