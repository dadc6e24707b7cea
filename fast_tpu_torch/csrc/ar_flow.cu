// K4 / K5 / K6: AR(1)-in-Fourier frozen-flow coupling series, for Hopper
// (sm_90a).
//
// Replaces fast_tpu/ops/pallas_synth.py::_ar_flow_kernel (K4, the state
// resident on chip), ::_ar_stream_kernel (K5, the state streamed from
// device memory in layer blocks) and ::_ar_flow_kernel_batch (K6, B
// independent series that share W, one per orbit sample of a temporal
// parameter scan), the TPU kernels behind TEMPORAL=True with
// TEMPORAL_SYNTH='ar' and behind the temporal AR scan. Per time step t,
// series s, layer l and Fourier mode e:
//
//   state  a_sl <- a_sl * ph_sl          (ph = alpha e^{i kappa . v dt})
//   noise  a_sl <- a_sl + z * ns_sl      (boiling only; ns = sqrt(1 -
//          alpha^2) sqrt(PSD) df; z 'uniform': (bits >> 8) sqrt(3) 2^-23 -
//          sqrt(3), or 'gauss': Box-Muller from 24-bit uniforms)
//   sum    A[t, s] = sum_l a_sl          (N, N) complex, fixed layer order
//   DFT 1  G'[t, s] = A[t, s]^T W^T      (N, N) @ (N, P), complex
//   DFT 2  phi^T = Re(W G'[t, s])        (P, N) @ (N, P), real part only
//   detect sum(pm_s cos phi^T), sum(pm_s sin phi^T)
//
// so one step of one series costs 8 P N^2 + 4 P^2 N FLOP in the two
// products (50 + 9 MFLOP at N=256, P=96) against ~12 L N^2 in the
// recurrence (3 MFLOP at L=4). K4 and K5 are the case B = 1 of the same
// passes.
//
// What the card changes. The TPU kernels walk time with a sequential grid
// and keep the (2, B L N, N) state in VMEM. Here the recurrence is
// independent per mode, so time is tiled instead:
// * ar_update: one thread per (mode, series). It holds the states, phasors
//   and noise scales of LB layers in registers, walks the tile's steps,
//   writes the layer sum A[t, s] for each and the state back once per
//   tile. With LB = L this is K4's counterpart (one read and one write of
//   the state per tile). With LB < L the host loops over layer blocks and
//   each block adds its layers into A[t, s] in turn, as _ar_stream_kernel
//   adds into its accumulator: K5's counterpart, for profiles with more
//   layers than fit in registers. The blocks run one after the other on
//   the stream, and every layer is added singly in layer order, so both
//   give the same A bit for bit. K6 is the same pass with a grid axis of
//   B series (the state series-major: (B, L, N, N)).
// * ar_dft, the first product: the second pass of the iid kernels
//   (detect.cuh, second_pass: wgmma in three TF32 passes, or one at
//   PRECISION='default' (wgmma.cuh), the rows of a launch stacked
//   in blocks of 64, B the laid W table streamed by bulk copies, A copied
//   by cp.async) with A's rows taken from the layer sums: a (step,
//   series) pair's rows are its N columns m of A (row stride N), so the
//   pass's H^T = G'^T W^T is here G'[j][m][p] = sum_k A[j][k][m] W[p][k];
//   warpgroup 0 writes Re G', 1 Im G', in the layout of the iid kernels'
//   G' (N x P per pair, P contiguous).
// * ar_detect: the same pass on G' (a pair's rows its P columns p2),
//   real part only: two row groups a block of work, each consumer
//   warpgroup forming Re H^T of its own 64 rows, so no warpgroup loads or
//   splits rows it does not use and nothing forms Im H; then sincos, the
//   weights pm_t of series j % B, per-(pair, 16 rows, slice) partial sums
//   that sum_tiles adds in order. Fixed-order reductions, no atomics, so a
//   run is reproducible bit for bit on one card.
// A and G' go through device memory in tiles of `tile` steps of all B
// series, which the wrapper sizes so that a tile has enough blocks for the
// card and A and G' stay bounded (ops/ar_flow.py, tile_steps: 1024 pairs
// at 256^2, at most 537 MB of A and 2 GiB of G').
//
// What bounds each pass (H100 80GB HBM3, 700 W; scripts/torch_ar_ab.py,
// the passes timed in one profiled launch, and scripts/torch_ar_*_
// variants.py, each beside copies of itself with one part taken out):
// * ar_update, the random bits: one Philox4x32-10 call is 24 integer
//   multiplies (20 IMAD.WIDE.U32; cuobjdump), 3.8e11 calls/s chained on
//   the card. With a call every step (its first design) the pass took
//   3.29 ms per 256 steps of K6's 16 series, 1.01 with a two-multiply
//   hash in its place; one call for two steps takes it to 2.45 (the
//   calls' own floor 1.41 ms). Drawing a pair's call a step early in
//   every other warp, to even out the steps, read slower (2.99), as did
//   8 layers a thread for K5 (3.04 against 2.66 ms at 4: fewer warps a
//   SM).
// * ar_dft, the work around the products: 0.80 ms per 1024 pairs at 256^2
//   (55 TFLOP/s over the pupil's 82 px), 0.58 with no products at all,
//   0.64 with one TF32 product a step; 2.32 ms per 64 pairs at 1024^2 with
//   the 402 px pupil (93 TFLOP/s). Its mma.sync predecessor: 49 and 56.
// * ar_detect: 0.25 ms per 1024 pairs at 256^2 (0.19 with no products),
//   0.93 per 64 at 1024^2, where ptxas serializes its wgmma (C7511). With
//   one row group a block of work, the Im warpgroup idle, it takes 0.26
//   and 1.17 ms; as the full two-screen pass 0.32 and 1.36 (its fp32 FMA
//   predecessor: 1.81 ms per 4096 pairs at 256^2 against 0.98 now).
//
// Rounding. The update runs for thousands of steps before its sum passes
// through sin and cos, so it is written with __fmul_rn / __fadd_rn and the
// file is built with -fmad=false: no product-sum is contracted into an FMA
// (the products' sums are the tensor cores'). The plain torch version
// (fast_tpu_torch/ops/ar_flow.py) runs the same operations in the same
// order, so state and A agree with it bit for bit and only the products
// differ (other roundings and sums in another order).
//
// Random bits. Philox4x32-10 keyed by the 64-bit seed (k0 = low word,
// k1 = high word). One call serves a pair of steps: mode e = row * N +
// col of layer l of series s draws, at the absolute step t of the series,
//   ctr = (e, (s0 + s) * L + l, t / 2, 2);
//   (bits1, bits2) = (out[0], out[1]) at an even t, (out[2], out[3]) at
//   an odd t,
// bits1 the real part's, with s0 the call's series offset (0 unless the
// caller says). A call of the kernel that starts at an odd step draws the
// pair's call and takes its second half, one that ends at an even step
// its first half, so a series cut into calls at any step is the same
// series. The series-major row is the TPU kernel's row order, and makes
// series 0 of a batch the single series of K4 from the same seed; the
// offset lets a rank that holds series s0 .. s0 + B - 1 of a scan draw the
// noise those series draw in one call over the whole scan (state rows stay
// local). The last word 2 keeps these streams apart from K2's (0), K1's
// (1) and K3's (3).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "detect.cuh"

namespace {

using namespace fast;

// noise kinds
constexpr int kNone = 0, kUniform = 1, kGauss = 2;
constexpr int kMaxLB = 8;  // most layers a thread of ar_update holds

// Advance LB layers of every mode of series s = blockIdx.y (of B =
// gridDim.y) by nsteps steps and add them into A. st_*, ph_*, ns: (B, L,
// N, N); a_*: (nsteps, B, N, N). accumulate: A already holds the sum of
// the layers below layer0. series0: the series offset of the Philox row.
template <int LB, int kNoise>
__global__ void __launch_bounds__(kThreads)
    ar_update(uint32_t k0, uint32_t k1, uint32_t step0, int nsteps, int L,
              int layer0, int series0, int accumulate,
              float* __restrict__ st_re,
              float* __restrict__ st_im, const float* __restrict__ ph_re,
              const float* __restrict__ ph_im, const float* __restrict__ ns,
              float* __restrict__ a_re, float* __restrict__ a_im, int NN) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= NN) return;
  const int s = blockIdx.y, B = gridDim.y;
  // the state row of the block's first layer, and its Philox counter word
  const int row0 = s * L + layer0;
  const int prow0 = (series0 + s) * L + layer0;
  float sr[LB], si[LB], pr[LB], pi[LB], nz[LB];
  uint32_t hz[LB], hw[LB];  // words 2 and 3 of each layer's pair call
#pragma unroll
  for (int l = 0; l < LB; ++l) {
    const size_t idx = static_cast<size_t>(row0 + l) * NN + e;
    sr[l] = st_re[idx];
    si[l] = st_im[idx];
    pr[l] = ph_re[idx];
    pi[l] = ph_im[idx];
    nz[l] = kNoise != kNone ? ns[idx] : 0.0f;
    hz[l] = hw[l] = 0u;
  }
  for (int t = 0; t < nsteps; ++t) {
    const size_t ai = (static_cast<size_t>(t) * B + s) * NN + e;
    const uint32_t step = step0 + static_cast<uint32_t>(t);
    const bool odd = (step & 1u) != 0u;
    // an even step, or the call's first: its pair's Philox call is drawn
    const bool draw = !odd || t == 0;
    float sum_r = 0.0f, sum_i = 0.0f;
    if (accumulate) {
      sum_r = a_re[ai];
      sum_i = a_im[ai];
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      float nr = __fsub_rn(__fmul_rn(sr[l], pr[l]), __fmul_rn(si[l], pi[l]));
      float ni = __fadd_rn(__fmul_rn(sr[l], pi[l]), __fmul_rn(si[l], pr[l]));
      if (kNoise != kNone) {
        uint32_t b1 = hz[l], b2 = hw[l];
        if (draw) {
          const U4 v = philox4x32_10(static_cast<uint32_t>(e),
                                     static_cast<uint32_t>(prow0 + l),
                                     step >> 1, 2u, k0, k1);
          b1 = odd ? v.z : v.x;
          b2 = odd ? v.w : v.y;
          hz[l] = v.z;
          hw[l] = v.w;
        }
        float z1, z2;
        if (kNoise == kUniform) {
          z1 = mixed_uniform(b1);
          z2 = mixed_uniform(b2);
        } else {
          box_muller(b1, b2, &z1, &z2);
        }
        nr = __fadd_rn(nr, __fmul_rn(z1, nz[l]));
        ni = __fadd_rn(ni, __fmul_rn(z2, nz[l]));
      }
      sr[l] = nr;
      si[l] = ni;
      sum_r = __fadd_rn(sum_r, nr);
      sum_i = __fadd_rn(sum_i, ni);
    }
    a_re[ai] = sum_r;
    a_im[ai] = sum_i;
  }
#pragma unroll
  for (int l = 0; l < LB; ++l) {
    const size_t idx = static_cast<size_t>(row0 + l) * NN + e;
    st_re[idx] = sr[l];
    st_im[idx] = si[l];
  }
}

// G'[j][m][p] = sum_k A[j][k][m] W[p][k] (complex) of nj layer sums A
// (a_re, a_im: nj x N x N) into g_re, g_im (nj x N x P): the second pass
// with a pair's rows the N columns m of its A (R = N; vec: A copied in
// 16-byte pieces), warpgroup 0 storing Re G', 1 Im G', all P columns (W's
// padded rows give zeros), 8 bytes a store; kPasses TF32 passes.
template <int NCH, int TAIL, int kPasses>
__global__ void __launch_bounds__(kDetThreads, 1)
    ar_dft(const float* __restrict__ wpack, const float* __restrict__ a_re,
           const float* __restrict__ a_im, float* __restrict__ g_re,
           float* __restrict__ g_im, int nj, int N, int P, int nz, int vec) {
  constexpr int PB = 64 * NCH + TAIL;
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x, wg = (tid >> 7) & 1, lane = tid & 31;
  const int nrows = nj * N;
  const auto epi = [&](int r0, int zb, const auto& gb, const auto& gt) {
    float* out = wg ? g_im : g_re;
    const int row = r0 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    for_each_ht<NCH, TAIL>(gb, gt, lane & 3, [&](int col, float v0, float v1,
                                                 int h) {
      const int p1 = zb * PB + col, m = row + 8 * h;
      if (p1 >= P || m >= nrows) return;
      *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * P + p1) =
          make_float2(v0, v1);
    });
  };
  second_pass<NCH, TAIL, 1, kPasses>(smem, wpack, a_re, a_im, nj, N, N, P,
                                     nz, vec != 0, epi);
}

// The detect pass on the real part alone: for each pair j, Re H^T = Re(G'^T
// W^T) (rows p2, columns p1; G' in g_re, g_im: nj x N x P), then
// sum(pm_t cos), sum(pm_t sin) with pm_t (B, P, P) of series j % B, into
// part (nj, P / 16, nz, 2): each warp's sums of its 16 rows over a slice.
// Two row groups a block of work, each warpgroup its own; kPasses TF32
// passes.
template <int NCH, int TAIL, int kPasses>
__global__ void __launch_bounds__(kDetThreads, 1)
    ar_detect(const float* __restrict__ wpack,
              const float* __restrict__ g_re, const float* __restrict__ g_im,
              const float* __restrict__ pm_t, float* __restrict__ part,
              int nj, int B, int N, int P, int nz) {
  constexpr int PB = 64 * NCH + TAIL;
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const auto epi = [&](int r0, int zb, const auto& gb, const auto& gt) {
    const int R = r0 + ((tid >> 5) & 3) * 16;  // the warp's rows
    const int j = R / P, p2w = R - j * P;
    if (j >= nj) return;  // the whole warp: rows past the last pair
    const float* pm =
        after_products(pm_t) + static_cast<size_t>(j % B) * P * P;
    const int p2 = p2w + (lane >> 2);
    float acc[2] = {0.0f, 0.0f};
    for_each_ht<NCH, TAIL>(gb, gt, lane & 3, [&](int col, float v0, float v1,
                                                 int h) {
      const int p1 = zb * PB + col;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (p1 + e >= P) continue;
        const int idx = (p1 + e) * P + p2 + 8 * h;
        float s, c;
        sincos_cw(e ? v1 : v0, &s, &c);
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
          part + ((static_cast<size_t>(j) * (P / 16) + p2w / 16) * nz + zb) * 2;
      o[0] = acc[0];
      o[1] = acc[1];
    }
  };
  second_pass<NCH, TAIL, 2, kPasses>(smem, wpack, g_re, g_im, nj, N, P, P, nz,
                                     true, epi);
}

struct UpdateArgs {
  uint32_t k0, k1, step0;
  int nsteps, L, layer0, series0, accumulate;
  float *st_re, *st_im;
  const float *ph_re, *ph_im, *ns;
  float *a_re, *a_im;
  int NN, B;
  cudaStream_t stream;
};

template <int LB, int kNoise>
cudaError_t launch_update(const UpdateArgs& u) {
  const dim3 grid((u.NN + kThreads - 1) / kThreads, u.B);
  ar_update<LB, kNoise><<<grid, kThreads, 0, u.stream>>>(
      u.k0, u.k1, u.step0, u.nsteps, u.L, u.layer0, u.series0, u.accumulate,
      u.st_re, u.st_im, u.ph_re, u.ph_im, u.ns, u.a_re, u.a_im, u.NN);
  return cudaGetLastError();
}

template <int LB>
cudaError_t update_noise(int noise, const UpdateArgs& u) {
  switch (noise) {
    case kNone:
      return launch_update<LB, kNone>(u);
    case kUniform:
      return launch_update<LB, kUniform>(u);
    case kGauss:
      return launch_update<LB, kGauss>(u);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t update_layers(int lb, int noise, const UpdateArgs& u) {
#define FAST_CASE(LB) \
  case LB:            \
    return update_noise<LB>(noise, u);
  switch (lb) {
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

// The first product of nj = (steps x B series) layer sums: G' into g_re,
// g_im (nj, N, P), from the laid W table wpack, in `passes` TF32 passes.
cudaError_t first_product(int passes, int P, int nj, const float* wpack,
                          const float* a_re, const float* a_im, float* g_re,
                          float* g_im, int N, cudaStream_t stream) {
  const WSlices w = w_slices(P);
  const dim3 grid = second_pass_grid(N, nj, w.nz);
  const int vec = N % 4 == 0 && ((reinterpret_cast<uintptr_t>(a_re) |
                                  reinterpret_cast<uintptr_t>(a_im)) &
                                 15) == 0;
  return by_passes(passes, [&](auto kp) {
    constexpr int kPasses = decltype(kp)::value;
#define FAST_DFT(PB)                                                      \
  case PB: {                                                              \
    auto* k = ar_dft<PB / 64, PB % 64, kPasses>;                          \
    constexpr int smem = detect_smem(PB, 1, kPasses);                     \
    const cudaError_t e = cudaFuncSetAttribute(                           \
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);            \
    if (e != cudaSuccess) return e;                                       \
    k<<<grid, kDetThreads, smem, stream>>>(wpack, a_re, a_im, g_re, g_im, \
                                           nj, N, P, w.nz, vec);          \
    return cudaGetLastError();                                            \
  }
    FAST_PB_SWITCH(w.PB, FAST_DFT)
#undef FAST_DFT
  });
}

// The detect pass of nj = (steps x B series) pairs' G' (g_re, g_im: nj x
// N x P): the sums into out (nj, 2), through part (nj, detect_parts(P),
// 2), in `passes` TF32 passes.
cudaError_t detect_real(int passes, int P, int nj, int B, const float* wpack,
                        const float* g_re, const float* g_im,
                        const float* pm_t, float* part, float* out, int N,
                        cudaStream_t stream) {
  const WSlices w = w_slices(P);
  const dim3 grid = second_pass_grid(P, nj, w.nz, 2);
  const cudaError_t err = by_passes(passes, [&](auto kp) {
    constexpr int kPasses = decltype(kp)::value;
#define FAST_DETECT(PB)                                                      \
  case PB: {                                                                 \
    auto* k = ar_detect<PB / 64, PB % 64, kPasses>;                          \
    constexpr int smem = detect_smem(PB, 2, kPasses);                        \
    const cudaError_t e = cudaFuncSetAttribute(                              \
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);               \
    if (e != cudaSuccess) return e;                                          \
    k<<<grid, kDetThreads, smem, stream>>>(wpack, g_re, g_im, pm_t, part,    \
                                           nj, B, N, P, w.nz);               \
    return cudaGetLastError();                                               \
  }
    FAST_PB_SWITCH(w.PB, FAST_DETECT)
#undef FAST_DETECT
  });
  if (err != cudaSuccess) return err;
  sum_tiles<2><<<(2 * nj + 255) / 256, 256, 0, stream>>>(part, out, 2 * nj,
                                                        detect_parts(P));
  return cudaGetLastError();
}

// Whether the products take nj pairs of an (N, N) grid at a padded pupil
// P from these tables: rows of both passes below 2^31, the 16-byte
// alignment of the bulk copies of W and of G'.
bool products_take(int P, int nj, int N, const float* wpack,
                   const float* g_re, const float* g_im) {
  return nj > 0 && static_cast<long long>(nj) * N <= 0x7fffffffLL - 128 &&
         static_cast<long long>(nj) * P <= 0x7fffffffLL - 128 &&
         second_pass_takes(P, nj, N, wpack, g_re, g_im);
}

}  // namespace

// One call advances B series by nsteps steps from the absolute step
// step0; series s draws the Philox rows of series series0 + s. Shapes:
// st_re, st_im (B, L, N, N), the states, updated in place;
// ph_re, ph_im (B, L, N, N); ns (B, L, N, N), read only with noise != 0;
// wpack, the laid W table of the padded (P, N) W (ops/synth_detect.py,
// laid_w), shared, laid out for `passes` TF32 passes (1 or 3) of both
// products; pm_t (B, P, P), each series' transposed pupil * mode;
// scratch a_re, a_im (tile * B, N, N), g_re, g_im (tile * B, N, P) and part
// (tile * B, detect_parts(P), 2); out (nsteps, B, 2) = (sum pm cos phi, sum
// pm sin phi) per step and series. lb: layers per thread of the update
// pass, 1..8; lb >= L is K4's counterpart (every layer in one pass), lb <
// L K5's (layer blocks in turn); B > 1 is K6's. noise: 0 none, 1
// 'uniform', 2 'gauss'. P must be a multiple of 16. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int fast_ar_flow(uint32_t k0, uint32_t k1, uint32_t step0,
                            int nsteps, int tile, int B, int series0,
                            int L, int lb, int noise, float* st_re,
                            float* st_im, const float* ph_re,
                            const float* ph_im, const float* ns,
                            const float* wpack, const float* pm_t,
                            float* a_re, float* a_im, float* g_re,
                            float* g_im, float* part, float* out, int N,
                            int P, int passes, void* stream) {
  if (N <= 0 || N > 32768 || nsteps <= 0 || tile <= 0 || B <= 0 ||
      B > 65535 || series0 < 0 || L <= 0 ||
      (static_cast<long long>(series0) + B) * L > 0x7fffffffLL || lb < 1 ||
      lb > kMaxLB || noise < 0 || noise > 2 || (noise != 0 && ns == nullptr) ||
      (passes != 1 && passes != 3) ||
      part == nullptr || static_cast<long long>(tile) * B > 0x7fffffffLL ||
      !products_take(P, tile * B, N, wpack, g_re, g_im))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int t0 = 0; t0 < nsteps; t0 += tile) {
    const int nt = nsteps - t0 < tile ? nsteps - t0 : tile;
    for (int l0 = 0; l0 < L; l0 += lb) {
      const UpdateArgs u = {k0,      k1,     step0 + static_cast<uint32_t>(t0),
                            nt,      L,      l0,
                            series0, l0 > 0, st_re,
                            st_im,   ph_re,  ph_im,
                            ns,      a_re,   a_im,
                            N * N,   B,      st};
      cudaError_t err = update_layers(L - l0 < lb ? L - l0 : lb, noise, u);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaError_t err = first_product(passes, P, nt * B, wpack, a_re, a_im,
                                    g_re, g_im, N, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = detect_real(passes, P, nt * B, B, wpack, g_re, g_im, pm_t, part,
                      out + static_cast<size_t>(t0) * B * 2, N, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The first DFT product alone, as fast_ar_flow runs it: G' = A^T W^T of
// nj layer sums a_re, a_im (nj, N, N) into g_re, g_im (nj, N, P), from
// the laid W table wpack. For timing the pass and holding it element by
// element against its plain version.
extern "C" int fast_ar_dft(int nj, const float* wpack, const float* a_re,
                           const float* a_im, float* g_re, float* g_im,
                           int N, int P, int passes, void* stream) {
  if (N <= 0 || N > 32768 || !products_take(P, nj, N, wpack, g_re, g_im))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(first_product(passes, P, nj, wpack, a_re, a_im,
                                        g_re, g_im, N,
                                        static_cast<cudaStream_t>(stream)));
}

// The detect pass alone, as fast_ar_flow runs it: the (nj, 2) sums of nj
// pairs' G' (g_re, g_im: nj x N x P) with pm_t (B, P, P) of series j % B,
// through part (nj, detect_parts(P), 2). For timing and holding against
// its plain version.
extern "C" int fast_ar_detect(int nj, int B, const float* wpack,
                              const float* g_re, const float* g_im,
                              const float* pm_t, float* part, float* out,
                              int N, int P, int passes, void* stream) {
  if (N <= 0 || N > 32768 || B <= 0 || part == nullptr ||
      !products_take(P, nj, N, wpack, g_re, g_im))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(detect_real(passes, P, nj, B, wpack, g_re, g_im,
                                      pm_t, part, out, N,
                                      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
