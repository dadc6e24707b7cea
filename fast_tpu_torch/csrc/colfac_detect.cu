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
// MFLOP for H, against 172 MB of split factor tables (86 MB unsplit) that
// every launch reads once and a G' of 0.4 MB a draw through device memory.
//
// Pass 1 runs on Hopper's warpgroup products (wgmma.mma_async m64nNk8
// TF32, wgmma.cuh), and so does the detect pass (detect.cuh, the draws
// stacked along wgmma's 64 rows), both in three TF32 passes (3xTF32): every
// operand element x is split into hi = tf32(x) and lo = tf32(x - hi), and
// each 8-deep step computes a_lo b_hi + a_hi b_lo (the small terms) and
// a_hi b_hi; hi + lo carries 22 of fp32's 24 bits. Every PRECISION value
// means this arithmetic.
//
// Pass 1, the design:
// * B pre-split and pre-laid, once per configuration. wgmma takes a 32-bit
//   B only K-major, and S_m stores its output columns contiguously, so the
//   wrapper lays the table out anew (ops/colfac_detect.py, lay_tables; the
//   engine keeps only that copy on the card): per column m and 8-deep step
//   of the depth, S_m's hi and lo parts over its 2P output columns in
//   wgmma's core-matrix layout (wgmma.cuh), the columns of each 8 px block
//   in the order 8 Re, 8 Im (so that a thread's accumulators hold two
//   neighbouring pixels of one part). A fold group's two steps are one
//   contiguous stage, 256 P bytes.
// * Asynchronous copies. A block takes 128 draws (two consumer warpgroups
//   of 64) for kCols columns in turn; one producer thread streams the
//   columns' stages into a ring of kStages slots with cp.async.bulk, each
//   completing on its slot's full mbarrier; the 8 consumer warps release a
//   slot on its empty one once their products that read it have landed.
//   The draw tiles of a column are adjacent in launch order, so S_m comes
//   from L2.
// * A in registers, drawn where it is used. The noise is the A operand,
//   64 draws x 8 deep a step and warpgroup; the tables' depth slots are
//   permuted (slot t of a step holds depth 2t, slot t + 4 depth 2t + 1),
//   so a thread's slots t and t + 4 of a step are rows 2q and 2q + 1 of
//   S_m: u_r and u_i of one lane q, one Philox call's two words. Each
//   thread draws its own fragments' noise and splits it in registers: no
//   shared memory, no block barrier. The next fold group's noise is drawn
//   while this group's products run.
// * Sums. The tensor cores round their sums toward zero, so each fold
//   group (two 8-deep steps, 16 of the depth) is a fresh accumulator that
//   takes the small terms of both steps first, then their a_hi b_hi, and
//   is then added to an fp32 sum (round to nearest), as in K2's pass 1;
//   tests/test_torch_colfac_tf32x3.py models this order. The 2P columns
//   are products of N = 64 and a tail of 32; at P <= 96 two are in flight,
//   so the fold of one overlaps the next one's products; wider pupils keep
//   one (the accumulators then leave no room for a second).
// * The TPU kernel's on-chip (b, P, P) accumulators over sequential column
//   blocks do not carry over (blocks run in no order): pass 1 writes G'
//   (N x P per draw, 1.6 GB per 4096-draw launch at 512^2, P=96) and pass 2
//   contracts it over the columns (detect.cuh: blocks of 64 stacked (draw,
//   p2) rows on wgmma, against the laid W table, the engine's once per
//   configuration).
//
// What bounds pass 1 now (H100 80GB HBM3, 700 W; scripts/torch_colfac_ab.py
// and scripts/torch_colfac_variants.py): 3.56-3.64 ms a 4096 draws at
// 512^2 'mixed' (49 TFLOP/s over the 82 px; on mma.sync 5.87-5.88),
// 3.71-3.72 'gauss' (5.32-5.45), under the 4.90 ms of one torch.bmm of the
// same product; K1 6.85-6.89 ms (9.09). Variants, 'mixed': one TF32
// product a step 2.92 ms, no products 2.68, no split 3.57, a hash for
// Philox 2.45, half the bytes copied 3.55. The noise sets the pace, not
// the tensor cores (about 1 ms of TF32 work) nor the copies: the product
// per column is thin (256 deep, 192 wide), one Philox call per 1.1
// products, and the work around the products (noise, splits, folds, 1.6
// GB of G' written) overlaps them only in part with two consumer
// warpgroups a SM (168 registers a thread, no spills; ptxas serializes
// the wgmma of PJ = 5 'mixed' and PJ = 7 'gauss' only, its C7511).
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
#include "wgmma.cuh"

namespace {

using namespace fast;

constexpr int kDraws = 64;       // draws a consumer warpgroup takes
constexpr int kConsumers = 256;  // two consumer warpgroups: 128 draws
constexpr int kPass1Threads = kConsumers + 128;  // and the producer's
constexpr int kConsumerRegs = 240;  // registers a thread: 2 x 128 x 240 +
constexpr int kProducerRegs = 24;   // 128 x 24 <= 65536
constexpr int kStages = 6;       // fold groups in the ring
constexpr int kCols = 4;         // columns a block takes in turn
constexpr int kLanes = 128;      // Philox lanes per column
constexpr int kKS = 32;          // the depth is a multiple of kKS rows

// Words of a ring stage at a padded pupil of 16 PJ px: a fold group's two
// 8-deep steps of S_m, hi and lo, over its 2P = 32 PJ columns
// (lay_tables of ops/colfac_detect.py lays the table out in these).
__host__ __device__ constexpr int pass1_stage_words(int PJ) {
  return 2 * 2 * 8 * 32 * PJ;
}

// Bytes of pass 1's shared memory: the ring and its mbarriers.
// _pass1_smem of ops/colfac_detect.py mirrors it.
__host__ __device__ constexpr int pass1_smem(int PJ) {
  return 4 * kStages * pass1_stage_words(PJ) + 8 * 2 * kStages;
}

// Pass 1: one block per (128 draws, kCols columns m), warpgroup w taking
// draws 64 w .. + 63 of the block by all 2P output columns of S_m (Re and
// Im of each pixel), the columns one after another; one producer thread
// streams the columns' fold groups through the ring. Writes G'[j, m, :].
template <bool kMixed, int PJ>
__global__ void __launch_bounds__(kPass1Threads, 1)
    colfac_pass1(uint32_t k0, uint32_t k1, uint32_t stream, int draw0,
                 int nbatch, const float* __restrict__ S,
                 float* __restrict__ g_re, float* __restrict__ g_im, int N,
                 int K) {
  constexpr int P = 16 * PJ;       // padded pupil width
  constexpr int C = 2 * P;         // columns of S_m: 8 Re, 8 Im a block
  constexpr int NCH = C / 64;      // chunks of 64 columns
  constexpr int TAIL = C % 64;     // and a tail of 32 (or none)
  constexpr int TW = TAIL > 0 ? TAIL : 16;  // the tail's wgmma width
  constexpr int NU = NCH + (TAIL > 0 ? 1 : 0);
  constexpr int SW = pass1_stage_words(PJ);
  constexpr bool kTwo = PJ <= 6;   // two chunks in flight
  extern __shared__ __align__(128) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * SW);
  const Ring<kStages> ring{smem, bars, bars + kStages, SW};

  const int m0 = blockIdx.y * kCols;
  const int ng = K / 16;                      // fold groups a column
  const int nit = (min(m0 + kCols, N) - m0) * ng;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: the block's columns' fold groups, in order
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      const float* sm = S + static_cast<size_t>(m0) * ng * SW;
      for (int it = 0; it < nit; ++it)
        ring.load(it, sm + static_cast<size_t>(it) * SW, 4 * SW);
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r = ((tid >> 5) & 3) * 16 + g;    // the thread's rows r, r + 8
  const int j = blockIdx.x * 2 * kDraws + (tid >> 7) * kDraws + r;  // draws
  const bool live[2] = {j < nbatch, j + 8 < nbatch};  // j and j + 8

  // The A fragments of step s of fold group h of column m: lane q = 4 (2h
  // + s) + t of draws j (row g) and j + 8 (row g + 8), u_r in slot t and
  // u_i in slot t + 4, split; draws past nbatch are zeros
  const auto noise = [&](int m, int h, int s, Frag& a) {
    const uint32_t e = static_cast<uint32_t>(m * kLanes + 8 * h + 4 * s + t);
    float z[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // [draw][u_r, u_i]
#pragma unroll
    for (int v = 0; v < 2; ++v)
      if (live[v]) {
        const U4 w = philox4x32_10(
            e, static_cast<uint32_t>(draw0 + j + 8 * v), stream, 1u, k0, k1);
        if (kMixed) {
          z[v][0] = mixed_uniform(w.x);
          z[v][1] = mixed_uniform(w.y);
        } else {
          box_muller(w.x, w.y, &z[v][0], &z[v][1]);
        }
      }
    a = split_frag({z[0][0], z[1][0], z[0][1], z[1][1]}, false);
  };

  float gb[NCH > 0 ? NCH : 1][32], gt[TW / 2];
  Frag a[1][2], an[1][2];  // this fold group's A, the next one's
  noise(m0, 0, 0, a[0][0]);
  noise(m0, 0, 1, a[0][1]);
#pragma unroll 1
  for (int it = 0; it < nit; ++it) {
    const int m = m0 + it / ng, h = it % ng;
    if (h == 0) {
#pragma unroll
      for (int u = 0; u < NCH; ++u)
#pragma unroll
        for (int v = 0; v < 32; ++v) gb[u][v] = 0.0f;
#pragma unroll
      for (int v = 0; v < TAIL / 2; ++v) gt[v] = 0.0f;
    }
    // the block's next fold group, whose noise is drawn meanwhile
    const bool more = it + 1 < nit;
    const int mn = h + 1 < ng ? m : m + 1, hn = h + 1 < ng ? h + 1 : 0;
    const float* st = ring.take(it);
    const auto issue = [&](int u, float (&dd)[32]) {
      uint64_t bh[1][2], bl[1][2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        bh[0][s] = b_desc(st + (2 * s) * C * 8 + 64 * u * 8);
        bl[0][s] = b_desc(st + (2 * s + 1) * C * 8 + 64 * u * 8);
      }
      if (u < NCH)
        mma3_group<64, 1>(dd, a, bh, bl);
      else
        mma3_group<TW, 1>(reinterpret_cast<float(&)[TW / 2]>(dd), a, bh, bl);
    };
    const auto land = [&](int u, float (&dd)[32], bool pending) {
      auto& dt = reinterpret_cast<float(&)[TW / 2]>(dd);
      if (u < NCH) {
        if (pending) fold<1>(gb[u], dd); else fold(gb[u], dd);
      } else {
        if (pending) fold<1>(gt, dt); else fold(gt, dt);
      }
    };
    // the next group's noise, a step after each of the first chunks
    const auto between = [&](int u) {
      if (more && u < 2) noise(mn, hn, u, an[0][u]);
      if (more && NU == 1) noise(mn, hn, 1, an[0][1]);
    };
    float d[2][32];
    if (kTwo) {
      issue(0, d[0]);
      between(0);
#pragma unroll
      for (int u = 1; u < NU; ++u) {
        issue(u, d[u & 1]);
        between(u);
        land(u - 1, d[(u - 1) & 1], true);
      }
      land(NU - 1, d[(NU - 1) & 1], false);
    } else {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        issue(u, d[0]);
        between(u);
        land(u, d[0], false);
      }
    }
    ring.release(it);
    if (more) {
      a[0][0] = an[0][0];
      a[0][1] = an[0][1];
    }
    if (h + 1 < ng) continue;
    // G' of column m: a chunk's column 8 i + 2t (+ 1) is part i % 2 of
    // pixel 8 (i / 2) + 2t (+ 1) of its 32, rows r (h = 0) and r + 8
    const auto put = [&](int px, int part, float v0, float v1, int hh) {
      const int jj = j + 8 * hh;
      if (!live[hh]) return;
      *reinterpret_cast<float2*>((part ? g_im : g_re) +
                                 (static_cast<size_t>(jj) * N + m) * P +
                                 px) = make_float2(v0, v1);
    };
#pragma unroll
    for (int u = 0; u < NCH; ++u)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          put(32 * u + 8 * (i / 2) + 2 * t, i & 1, gb[u][4 * i + 2 * hh],
              gb[u][4 * i + 2 * hh + 1], hh);
#pragma unroll
    for (int i = 0; i < TAIL / 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        put(32 * NCH + 8 * (i / 2) + 2 * t, i & 1, gt[4 * i + 2 * hh],
            gt[4 * i + 2 * hh + 1], hh);
  }
}

template <bool kMixed, int PJ>
cudaError_t launch_pass1(uint32_t k0, uint32_t k1, uint32_t stream_id,
                         int draw0, int nbatch, const float* S, float* g_re,
                         float* g_im, int N, int K, cudaStream_t stream) {
  constexpr int smem = pass1_smem(PJ);
  auto* k_pass1 = colfac_pass1<kMixed, PJ>;
  cudaError_t err = cudaFuncSetAttribute(
      k_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nbatch + 2 * kDraws - 1) / (2 * kDraws),
                  (N + kCols - 1) / kCols);
  k_pass1<<<grid, kPass1Threads, smem, stream>>>(k0, k1, stream_id, draw0,
                                                 nbatch, S, g_re, g_im, N, K);
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

// Shapes: S (N, K / 8, 2, 16 P), the factor table of K rows split and laid
// out for pass 1 (ops/colfac_detect.py, lay_tables); wpack (1, N64 / 8, 4,
// 8 P), the laid W table of the detect pass (ops/synth_detect.py, laid_w);
// pm_t (P, P); sh_t nullptr or (nbatch, 2, P, P) transposed subharmonic
// screens; g_re, g_im scratch (nbatch, N, P); part scratch (nbatch, P /
// 16, 4), the detect pass's partial sums; out (nbatch, 4) = (sum pm cos
// h1, sum pm sin h1, sum pm cos h2, sum pm sin h2). P is a multiple of 16
// and at most 128; K is 256 for 'mixed' noise (mixed != 0), else a
// multiple of 32 up to 256. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int fast_colfac_detect(uint32_t k0, uint32_t k1,
                                  uint32_t stream_id, int draw0, int nbatch,
                                  const float* S, const float* wpack,
                                  const float* pm_t, const float* sh_t,
                                  float* g_re, float* g_im, float* part,
                                  float* out, int N, int P, int K, int mixed,
                                  void* stream) {
  if (!takes(N, P, nbatch, K, mixed))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = pass1(P, mixed != 0, k0, k1, stream_id, draw0,
                                nbatch, S, g_re, g_im, N, K, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_detect(P, nbatch, wpack, g_re, g_im, pm_t,
                                        sh_t, part, out, N, st));
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
// through part (nbatch, detect_parts(P), 4). P is a multiple of 16; wpack
// (the laid W table of w_slices(P)), pm_t and sh_t as fast_colfac_detect's.
// For timing the pass and holding it against its plain version.
extern "C" int fast_detect_pass(int nbatch, const float* wpack,
                                const float* g_re, const float* g_im,
                                const float* pm_t, const float* sh_t,
                                float* part, float* out, int N, int P,
                                void* stream) {
  return static_cast<int>(launch_detect(P, nbatch, wpack, g_re, g_im, pm_t,
                                        sh_t, part, out, N,
                                        static_cast<cudaStream_t>(stream)));
}

extern "C" const char* fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
