// K1: colfac-basis noise synthesis and pupil-overlap detection, for Hopper
// (sm_90a), its two products on the tensor cores.
//
// Replaces fast_tpu/ops/pallas_synth.py::_colfac_detect_kernel_merged, the
// TPU kernel behind SYNTH='pallas_colfac' for pupils of at most 128 px (wider
// ones take the split layout, K3 in colfac_split.cu). The pruned screen
// W X W^T is
// drawn in the column-factored basis: the columns of G = W X are
// independent with covariance C_m = L_m L_m^H, so G[:, m] = L_m z_m with a
// white z_m of the pupil's length instead of a full grid column. Per
// complex draw j:
//
//   bits   two 32-bit words per noise lane of each column m, 128 lanes
//   noise  'mixed': raw uniforms u = (bits >> 8) sqrt(3) 2^-23 - sqrt(3);
//          the orthogonal 128 x 128 mix is folded into the factor table
//          'gauss': Box-Muller from 24-bit uniforms (live lanes only)
//   factor G'[m, :] = [u_r | u_i] S_m           (1 x K) @ (K x 2P)
//   DFT    H = W G'                           (P, N) @ (N, P), complex
//   detect sum(pm_t * cos/sin(Re H + sh_r)), sum(pm_t * cos/sin(Im H + sh_i))
//
// S_m is the real-block form of B_m = M L_m^T ('mixed', M the mixing
// matrix) or B_m = L_m^T ('gauss'), with the rows of the two noise
// components interleaved (row 2q: u_r of lane q, row 2q + 1: u_i) and the
// columns of G's real and imaginary parts interleaved (column 2p: Re G_p,
// 2p + 1: Im G_p):
//   S_m[2q, p] = (Re B[q, p], Im B[q, p]),  S_m[2q+1, p] = (-Im B, Re B).
// fast_tpu_torch/ops/colfac_detect.py::pack_tables builds it. G' = G^T is
// exactly the G' of the synth-detect kernel (K2), so pass 2 is K2's own
// detect pass (detect.cuh), with the same transposed pm and screens.
//
// Mixing width. The TPU kernel mixes 128 uniforms per component per column
// (its 128-lane tile), so every z is a sum of 128 uniforms; K = 256 rows
// here too, whatever the padded pupil width. 'gauss' draws only the lanes
// that meet nonzero rows of L (K = 2 * npup rounded up to 16 lanes), from
// the same counters.
//
// The work. At 512^2 with an 82 px pupil (padded to 96), one 'mixed' draw
// costs N * 2 * 256 * 164 = 43 MFLOP of factor products and 8 P^2 N = 27.5
// MFLOP for H, against 86 MB of factor tables that every launch reads once
// and a G' of 0.4 MB a draw through device memory.
//
// Both products run on the tensor cores as warp-level mma.sync.m16n8k8 TF32
// products in three passes (3xTF32, tf32x3.cuh): every operand element x is
// split into hi = tf32(x) and lo = tf32(x - hi), and each 8-deep step's
// products of an output block, the small terms a_lo b_hi + a_hi b_lo first,
// then a_hi b_hi, are a sum of their own in fresh accumulators, added to
// the block's sums in fp32 (the tensor cores round their sums toward
// zero). What the design does:
// * Pass 1 is one block per (128 draws, column m): a (128 x K) @ (K x 2P)
//   product with the draws as its rows; warp w takes draws 16 w .. + 15 by
//   all 2 P columns, so its A fragment (the noise, split as it is drawn
//   into shared memory) serves the 4 PJ output blocks of a step. The slices of 32 rows
//   of S_m land by cp.async, one ahead; the block splits each once into the
//   B fragments' order (split_pairs), since every warp reads every element.
// * Blocks of one column are adjacent in launch order, so the 32 draw
//   tiles of a 4096-draw launch read S_m from L2, not from device memory.
// * The TPU kernel's on-chip (b, P, P) accumulators over sequential column
//   blocks do not carry over (blocks run in no order): pass 1 writes G'
//   (N x P per draw, 1.6 GB per 4096-draw launch at 512^2, P=96) and pass 2
//   contracts it over the columns in one block per draw (detect.cuh, on
//   the tensor cores too).
//
// What bounds it now (H100 80GB HBM3, 700 W; scripts/torch_colfac_ab.py
// and scripts/torch_colfac_variants.py): K1 takes 9.20-9.27 ms per 4096
// draws at 512^2 (fp32 FMA: 10.45-10.52). The detect pass went from 4.50
// to 3.25-3.34 ms (34 TFLOP/s over the 82 px). Pass 1 did not get faster:
// 5.87-5.97 ms (30 TFLOP/s), as fp32 FMA. Its tensor-core work is 2.1 ms
// of it (one TF32 pass: 4.49 ms), Philox 0.7 ms (a hash in its place: 5.18
// ms); the rest is the noise and the split between the block's barriers,
// with the tensor cores idle, and 1.6 GB of G' written. Per column the
// product is thin (K = 256 deep, 192 wide), so the noise, one Philox call
// per 1.1 products, is as much work as the products themselves. Other
// layouts were no faster on the same card: the next slice's noise drawn
// between the steps, 64 draws a block at two blocks a SM with the split per
// warp, producer warps beside consumer warps, sums over two steps. The G'
// round trip is the lever left.
//
// Random bits. Philox4x32-10 keyed by the 64-bit seed (k0 = low word,
// k1 = high word). Counter of lane q (0..127) of column m of draw d:
//   ctr = (m * 128 + q, d, stream, 1);  bits1 = out[0] (u_r or u1),
//   bits2 = out[1] (u_i or u2).
// The last word 1 keeps K1's streams apart from those of K2 and K7 (0), the
// AR kernels (2) and K3 (3). The plain torch version builds the same
// counters, so kernel and plain version see identical noise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "detect.cuh"
#include "tf32x3.cuh"

namespace {

using namespace fast;

constexpr int kDT = 128;         // draws per pass-1 block, 16 a warp
constexpr int kKS = 32;          // depth slice: 16 lanes x 2 components
constexpr int kSS = kKS / 8;     // 8-deep steps of a slice
constexpr int kLanes = 128;      // Philox lanes per column
constexpr int kZS = kKS + 8;     // shared row stride of the noise slice

// Words of pass 1's dynamic shared memory at a padded pupil of 16 PJ px:
// the noise slice as TF32 hi and lo parts (kDT draws x kKS rows each); two
// raw slices of S_m (kKS rows of P (re, im) column pairs, row stride 2 P +
// 4), one landing while the other is used; and one slice split into the B
// fragments' order (split_pairs).
__host__ __device__ constexpr int pass1_words(int PJ) {
  return 2 * kDT * kZS + 2 * kKS * (32 * PJ + 4) + kSS * 2 * PJ * 32 * 8;
}

// Pass 1: one block per (128 draws, column m), warp w taking draws 16 w ..
// + 15 (one m16 block) by every pixel block of 8 px, for Re G' and Im G':
// 4 PJ independent sums a step, whose A fragment is formed once. Per
// slice of kKS rows the block draws the noise, split as it is drawn, and
// splits the landed slice of S_m once (split_pairs: a pixel's two columns
// are a pair; every warp reads each element), the next slice landing
// meanwhile (cp.async); each B fragment is then two 16-byte shared loads.
// Writes G'[j, m, :].
template <bool kMixed, int PJ>
__global__ void __launch_bounds__(kThreads, 1)
    colfac_pass1(uint32_t k0, uint32_t k1, uint32_t stream, int draw0,
                 int nbatch, const float* __restrict__ S,
                 float* __restrict__ g_re, float* __restrict__ g_im, int N,
                 int K) {
  constexpr int P = 16 * PJ;       // padded pupil width
  constexpr int C = 2 * P;         // columns of S_m: (pixel, re/im)
  constexpr int SS = C + 4;        // shared row stride of the raw slices
  constexpr int NT = 2 * PJ;       // pixel blocks
  extern __shared__ __align__(16) float smem[];
  uint32_t* zh = reinterpret_cast<uint32_t*>(smem);  // [draw][row], hi
  uint32_t* zl = zh + kDT * kZS;                     // ... lo
  float* ss = smem + 2 * kDT * kZS;                  // 2 x [row][col]
  uint4* ps = reinterpret_cast<uint4*>(ss + 2 * kKS * SS);  // split slice

  const int m = blockIdx.y;
  const int j0 = blockIdx.x * kDT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* sm = S + static_cast<size_t>(m) * K * C;

  // rows s kKS .. of S_m into raw buffer s & 1, in 16-byte pieces
  const auto stage = [&](int s) {
    stage_rows<SS, C, 4>(ss + (s & 1) * kKS * SS, sm, s * kKS, kKS, K, C, 0);
    cp_async_commit();
  };

  float acc[NT][2][4];  // [pixel block][re, im][fragment]
#pragma unroll
  for (int b = 0; b < NT; ++b)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[b][0][v] = acc[b][1][v] = 0.0f;

  const int nsl = K / kKS;
  stage(0);
  for (int s = 0; s < nsl; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // slice s landed; slice s - 1 used by all
    if (s + 1 < nsl) stage(s + 1);
    // the noise of lanes s kKS / 2 .. + 15 for the block's draws, split:
    // row 2 l of draw d is u_r of lane l, row 2 l + 1 its u_i (S_m's row
    // order); draws past nbatch are zeros
#pragma unroll
    for (int i = 0; i < kKS / 2 * kDT / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int l = e & 15, d = e >> 4;
      float z0 = 0.0f, z1 = 0.0f;
      if (j0 + d < nbatch) {
        const U4 v = philox4x32_10(
            static_cast<uint32_t>(m * kLanes + s * (kKS / 2) + l),
            static_cast<uint32_t>(draw0 + j0 + d), stream, 1u, k0, k1);
        if (kMixed) {
          z0 = mixed_uniform(v.x);
          z1 = mixed_uniform(v.y);
        } else {
          box_muller(v.x, v.y, &z0, &z1);
        }
      }
      uint2 h, lo;
      split(z0, h.x, lo.x);
      split(z1, h.y, lo.y);
      *reinterpret_cast<uint2*>(zh + d * kZS + 2 * l) = h;
      *reinterpret_cast<uint2*>(zl + d * kZS + 2 * l) = lo;
    }
    split_pairs<kSS, NT, SS>(ps, ss + (s & 1) * kKS * SS);
    __syncthreads();  // noise and split slice visible to all
#pragma unroll
    for (int ks = 0; ks < kSS; ++ks) {
      // A fragment: draws 16 warp + g and + 8, rows 8 ks + 2t (slots t)
      // and + 1 (slots t + 4)
      uint32_t ah[4], al[4];
      const int at = (16 * warp + g) * kZS + 8 * ks + 2 * t;
      load_a(zh + at, kZS, ah);
      load_a(zl + at, kZS, al);
#pragma unroll
      for (int b = 0; b < NT; ++b) {
        // B fragments of pixel block b: its real-part and imaginary-part
        // columns, hi and lo
        const int u = (ks * NT + b) * 32 + lane;
        const uint4 r4 = ps[u], i4 = ps[kSS * NT * 32 + u];
        const uint32_t rh[2] = {r4.x, r4.y}, rl[2] = {r4.z, r4.w};
        const uint32_t ih[2] = {i4.x, i4.y}, il[2] = {i4.z, i4.w};
        // each step's products a sum of their own, the small terms first,
        // added to acc in fp32 (tf32x3.cuh)
        float d[4];
        mma_tf32_new(d, al, rh);
        mma_tf32(d, ah, rl);
        mma_tf32(d, ah, rh);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[b][0][v] += d[v];
        mma_tf32_new(d, al, ih);
        mma_tf32(d, ah, il);
        mma_tf32(d, ah, ih);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[b][1][v] += d[v];
      }
    }
  }
  // fragment (draw g | g + 8 of the warp's, pixels 2t, 2t + 1 of the pixel
  // block): 32 bytes a quad
#pragma unroll
  for (int b = 0; b < NT; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + 16 * warp + g + 8 * h;
      if (j >= nbatch) continue;
      const size_t at = (static_cast<size_t>(j) * N + m) * P + 8 * b + 2 * t;
      *reinterpret_cast<float2*>(g_re + at) =
          make_float2(acc[b][0][2 * h], acc[b][0][2 * h + 1]);
      *reinterpret_cast<float2*>(g_im + at) =
          make_float2(acc[b][1][2 * h], acc[b][1][2 * h + 1]);
    }
}

template <bool kMixed, int PJ>
cudaError_t launch_pass1(uint32_t k0, uint32_t k1, uint32_t stream_id,
                         int draw0, int nbatch, const float* S, float* g_re,
                         float* g_im, int N, int K, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float) * pass1_words(PJ));
  auto* k_pass1 = colfac_pass1<kMixed, PJ>;
  cudaError_t err = cudaFuncSetAttribute(
      k_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nbatch + kDT - 1) / kDT, N);
  k_pass1<<<grid, kThreads, smem, stream>>>(k0, k1, stream_id, draw0, nbatch,
                                            S, g_re, g_im, N, K);
  return cudaGetLastError();
}

// Pass 1 at a padded pupil P of at most 128 px.
cudaError_t pass1(int P, bool mixed, uint32_t k0, uint32_t k1,
                  uint32_t stream_id, int draw0, int nbatch, const float* S,
                  float* g_re, float* g_im, int N, int K,
                  cudaStream_t stream) {
#define FAST_CASE(PJ)                                                       \
  case PJ:                                                                  \
    return mixed ? launch_pass1<true, PJ>(k0, k1, stream_id, draw0, nbatch, \
                                          S, g_re, g_im, N, K, stream)      \
                 : launch_pass1<false, PJ>(k0, k1, stream_id, draw0,        \
                                           nbatch, S, g_re, g_im, N, K,     \
                                           stream);
  switch (P / 16) {
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

bool takes(int N, int P, int nbatch, int K, int mixed) {
  return N > 0 && N <= 65535 && P % 16 == 0 && P >= 16 && P <= 128 &&
         nbatch > 0 && K > 0 && K % kKS == 0 && K <= 2 * kLanes &&
         (!mixed || K == 2 * kLanes);
}

}  // namespace

// Shapes: S (N, K, P, 2) packed factors; wr, wi (P, N); pm_t (P, P);
// sh_t nullptr or (nbatch, 2, P, P) transposed subharmonic screens;
// g_re, g_im scratch (nbatch, N, P); out (nbatch, 4) = (sum pm cos h1,
// sum pm sin h1, sum pm cos h2, sum pm sin h2). P is a multiple of 16 and
// at most 128; K is 256 for 'mixed' noise (mixed != 0), else a multiple of
// 32 up to 256. Returns the cudaError_t of the launches (0 on success).
extern "C" int fast_colfac_detect(uint32_t k0, uint32_t k1,
                                  uint32_t stream_id, int draw0, int nbatch,
                                  const float* S, const float* wr,
                                  const float* wi, const float* pm_t,
                                  const float* sh_t, float* g_re,
                                  float* g_im, float* out, int N, int P,
                                  int K, int mixed, void* stream) {
  if (!takes(N, P, nbatch, K, mixed))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = pass1(P, mixed != 0, k0, k1, stream_id, draw0,
                                nbatch, S, g_re, g_im, N, K, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a pupil of at most 128 px is one tile: no partial sums
  return static_cast<int>(launch_detect(P, nbatch, wr, wi, g_re, g_im, pm_t,
                                        sh_t, nullptr, out, N, st));
}

// Pass 1 alone: G' of nbatch draws into g_re, g_im (nbatch, N, P), as
// fast_colfac_detect makes it before its detect pass. For timing the pass
// and holding it element by element against its plain version. Arguments
// as fast_colfac_detect's.
extern "C" int fast_colfac_pass1(uint32_t k0, uint32_t k1, uint32_t stream_id,
                                 int draw0, int nbatch, const float* S,
                                 float* g_re, float* g_im, int N, int P,
                                 int K, int mixed, void* stream) {
  if (!takes(N, P, nbatch, K, mixed))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(pass1(P, mixed != 0, k0, k1, stream_id, draw0,
                                nbatch, S, g_re, g_im, N, K,
                                static_cast<cudaStream_t>(stream)));
}

// The detect pass of K1, K2 and K3 alone (detect.cuh): the sums of nbatch
// draws from their G' (g_re, g_im: nbatch, N, P) into out (nbatch, 4),
// through part (nbatch, T * T, 4), T = ceil(P / 128), for a pupil over
// 128 px (else unused, may be nullptr). P is a multiple of 16; wr, wi,
// pm_t and sh_t as fast_colfac_detect's. For timing the pass and holding
// it against its plain version.
extern "C" int fast_detect_pass(int nbatch, const float* wr, const float* wi,
                                const float* g_re, const float* g_im,
                                const float* pm_t, const float* sh_t,
                                float* part, float* out, int N, int P,
                                void* stream) {
  if (N <= 0 || nbatch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_detect(P, nbatch, wr, wi, g_re, g_im, pm_t,
                                        sh_t, part, out, N,
                                        static_cast<cudaStream_t>(stream)));
}

extern "C" const char* fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
