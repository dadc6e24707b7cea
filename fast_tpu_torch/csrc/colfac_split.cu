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
// * Products, on the tensor cores: pass 1 on Hopper's warpgroup products
//   (wgmma.mma_async m64nNk8 TF32, wgmma.cuh), three TF32 passes each
//   (3xTF32, tf32x3.cuh) at PRECISION 'high' and 'highest', one at
//   'default' (from the table's hi planes alone), as in K1 and in K2's
//   pass 1, in fold groups of two 8-deep steps added to fp32 sums; the
//   detect pass the same way (detect.cuh). The complex product is four
//   real ones, the sign of -z_i flipped in its A fragment (exactly).
//
// Pass 1, the design: the shape of K2's pass 1 (synth_detect.cu), with the
// noise in place of X' and the column's factor table in place of W^T.
// * B pre-split and pre-laid, once per configuration (ops/colfac_detect.py,
//   lay_tables_split; the engine keeps only that copy on the card): the
//   pupil is cut into nz slices of PB <= 208 px (two of 208 at 416 px; a
//   slice need not be a tile of the detect pass), and per column m, slice
//   and 8-deep step of the lanes (padded to a multiple of 64) the step's
//   B_r hi, B_r lo, B_i hi, B_i lo over the slice's PB px in wgmma's
//   core-matrix layout: one contiguous ring stage of 128 PB bytes. B_r and
//   B_i stay separate regions, not the doubled real-block form: 3.49 GB
//   at 1024^2 with a 402 px pupil.
// * A block per (slice, 64 draws, column m): two consumer warpgroups, 0
//   making Re G' (z_r B_r and -z_i B_i), 1 Im G' (z_r B_i and z_i B_r),
//   over the slice in chunks of 64 px and a tail, two chunks in flight
//   (tile_products of wgmma.cuh); a producer thread streams the stages
//   into a ring of 4 with cp.async.bulk on mbarriers. The blocks of one
//   column are adjacent in launch order, so its table comes from L2.
// * The noise drawn once. The nz slices' blocks of one (draws, column) are
//   a thread-block cluster (nz <= 8, pupils up to 1664 px; past that each
//   block draws its own). The noise goes through x tiles of 64 draws x 64
//   lanes (z_r, z_i), two slots a block; each block draws 1/nz of every
//   tile, one Philox call per (draw, lane), and writes it into the slot of
//   every block of the cluster (st.shared::cluster), then arrives on each
//   block's full barrier of the slot; every warp arrives on each block's
//   empty barrier once it has read the tile. With 'mixed' noise the next
//   tile is drawn while this one's products run; 'gauss' draws it after
//   them (see split_pass1).
//
// The work. At 1024^2 with a 402 px pupil one 'mixed' draw costs N * 2 LW *
// 2P * 2 = 1.74 GFLOP of factor products and 8 P^2 N = 1.42 GFLOP for H,
// against 3.49 GB of split tables read once per launch and 3.4 MB of G' per
// draw through device memory, as in K1 and K2, whose G' this is: pass 2 is
// the shared detect pass of detect.cuh.
//
// What bounds pass 1 now (H100 80GB HBM3, 700 W; scripts/torch_colfac_ab.py
// and scripts/torch_colfac_variants.py): 14.64-14.73 ms a 630 draws at
// 1024^2 with a 402 px pupil, 'mixed' (72 TFLOP/s over the 402 px; on
// mma.sync 29.98), 14.39 'gauss' (29.02-29.04), under the 21.7 ms of one
// torch.bmm of the same product; K3 35.6-35.7 ms (50.8-51.1). Variants,
// 'mixed': one TF32 product a step 11.44 ms, no products 8.59, no split
// 14.37, half the bytes copied 14.41, each block drawing its own noise
// 15.14 ('gauss' 15.90 against 14.39); a hash for Philox reads slower,
// 16.44, for ptxas then serializes the wgmma (C7511). The products take
// 6.2 ms of the 14.8 (at 42% of the 3xTF32 peak); the rest is the A
// fragments' loads and splits, the folds, the noise and its exchange,
// and 2.1 GB of G' written, which overlap the products only in part
// with two consumer warpgroups a SM (168 registers a thread, no spills).

#include <cuda_runtime.h>
#include <stdint.h>

#include "detect.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

using namespace fast;

constexpr int kStages = 4;       // B stages (8-deep steps) in the ring
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kPass1Threads = kConsumers + 128;  // and the producer's
constexpr int kConsumerRegs = 240;  // registers a thread: 2 x 128 x 240 +
constexpr int kProducerRegs = 24;   // 128 x 24 <= 65536
constexpr int kPBMax = 208;      // widest slice of the pupil a block covers
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kBars = 2 * kStages + 4;  // the ring's and the x slots'

// How pass 1 covers the padded pupil P: nz blocks along it, each a slice
// of PB <= 208 px (a multiple of 16), run as clusters of cs blocks (all nz
// of a column's draws, or one past kMaxCluster). _split_geom of
// ops/colfac_detect.py is the same rule.
struct SplitGeom {
  int PB, nz, cs;
};

SplitGeom split_geom(int P) {
  const int nz = (P + kPBMax - 1) / kPBMax;
  return {(P / 16 + nz - 1) / nz * 16, nz, nz <= kMaxCluster ? nz : 1};
}

// Words of a ring stage: an 8-deep step of B_r and B_i, hi and lo (hi
// alone at one pass), over PB px.
__host__ __device__ constexpr int pass1_stage_words(int PB, int kPasses) {
  return 16 * b_planes(kPasses) * PB;
}

// Bytes of pass 1's shared memory: the ring, two x tiles and the
// mbarriers. _split_smem of ops/colfac_detect.py mirrors it.
__host__ __device__ constexpr int pass1_smem(int PB, int kPasses) {
  return 4 * (kStages * pass1_stage_words(PB, kPasses) + 2 * kXTile) +
         8 * kBars;
}

// Pass 1: one block per (slice zb of PB = 64 NCH + TAIL px, 64 draws,
// column m); the nz blocks of a (draws, column) a cluster of cs blocks
// that draw the noise between them. Products in kPasses TF32 passes from
// a table laid out for them. Writes G'[j, m, zb PB ..].
template <bool kMixed, int NCH, int TAIL, int kPasses>
__global__ void __launch_bounds__(kPass1Threads, 1)
    split_pass1(uint32_t k0, uint32_t k1, uint32_t stream, int draw0,
                int nbatch, const float* __restrict__ tab,
                float* __restrict__ g_re, float* __restrict__ g_im, int N,
                int P, int Kq, int LW) {
  constexpr int PB = 64 * NCH + TAIL;
  constexpr int TW = TAIL > 0 ? TAIL : 16;  // the tail's wgmma width
  constexpr int SW = pass1_stage_words(PB, kPasses);
  extern __shared__ __align__(128) float smem[];
  float* xs = smem + kStages * SW;  // two x tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + 2 * kXTile);
  const Ring<kStages> ring{smem, bars, bars + kStages, SW};
  // x tile c in slot c % 2 of every block; xfull[s] completes when all
  // consumer threads of the cluster have written their share of it,
  // xempty[s] when all consumer warps of the cluster have read it
  uint64_t* xfull = bars + 2 * kStages;
  uint64_t* xempty = xfull + 2;
  const int cs = cluster_size(), rank = cluster_rank();
  const int zb = blockIdx.x, nz = gridDim.x;
  const int j0 = blockIdx.y * kXRows;
  const int m = blockIdx.z;
  const int NC = (Kq + kXDepth - 1) / kXDepth;  // x tiles of the lanes
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumers / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&xfull[s], cs * kConsumers);
      mbar_init(&xempty[s], cs * kConsumers / 32);
    }
    mbar_init_fence();
  }
  cluster_sync();  // every block's barriers are set up

  if (tid >= kConsumers) {
    // the producer: the 8 NC steps of the column's slice, in order
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      const float* tm =
          tab + (static_cast<size_t>(m) * nz + zb) * NC * 8 * SW;
      for (int it = 0; it < 8 * NC; ++it)
        ring.load(it, tm + static_cast<size_t>(it) * SW, 4 * SW);
    }
    cluster_sync();  // no block leaves while a peer may write to it
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid >> 7;                   // part of G': 0 Re, 1 Im
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r = ((tid >> 5) & 3) * 16 + g;   // the thread's rows r, r + 8
  float gb[NCH > 0 ? NCH : 1][32], gt[TW / 2];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int v = 0; v < 32; ++v) gb[c][v] = 0.0f;
#pragma unroll
  for (int v = 0; v < TAIL / 2; ++v) gt[v] = 0.0f;

  // Quarter q of this block's share of x tile c: of the tile's 2048 units
  // (draw row, lane pair f), units rank + cs w, w = tid + 256 k for k = q
  // mod 4; each unit's two lanes of z_r and z_i, one Philox call a lane,
  // into slot c % 2 of every block of the cluster. Lanes past Kq and draws
  // past nbatch are zeros.
  const int units = (kXRows * kXDepth / 2 - rank + cs - 1) / cs;
  const auto make = [&](int c, int q) {
    float* x = xs + (c & 1) * kXTile;
    for (int k = q;; k += 4) {
      const int w = tid + kConsumers * k;
      if (w >= units) break;
      const int u = rank + cs * w;
      const int row = u >> 5, f = u & 31;
      const int d = j0 + row, l0 = c * kXDepth + 2 * f;
      float zr[2] = {0.0f, 0.0f}, zi[2] = {0.0f, 0.0f};
#pragma unroll
      for (int v = 0; v < 2; ++v)
        if (d < nbatch && l0 + v < Kq) {
          const U4 b = philox4x32_10(
              static_cast<uint32_t>(m) * static_cast<uint32_t>(LW) + l0 + v,
              static_cast<uint32_t>(draw0 + d), stream, 3u, k0, k1);
          if (kMixed) {
            zr[v] = mixed_uniform(b.x);
            zi[v] = mixed_uniform(b.y);
          } else {
            box_muller(b.x, b.y, &zr[v], &zi[v]);
          }
        }
      const int at = swz(row, f, kXDepth);
      for (int p = 0; p < cs; ++p) {
        st_peer(peer_addr(x + at, p), make_float2(zr[0], zr[1]));
        st_peer(peer_addr(x + kXRows * kXDepth + at, p),
                make_float2(zi[0], zi[1]));
      }
    }
  };
  // this thread's share of tile c is written: arrive on every block's
  // xfull (releasing the writes to the cluster)
  const auto made = [&](int c) {
    for (int p = 0; p < cs; ++p)
      mbar_arrive_peer(peer_addr(&xfull[c & 1], p));
  };

  // 'mixed': the next tile is drawn, a quarter a fold group, while this
  // one's products run. 'gauss': after them; Box-Muller beside the
  // products leaves ptxas too few registers for the wgmma pipeline, which
  // it then serializes (its C7511 at 208 px: 16.87 against 14.39 ms at
  // 1024^2, scripts/torch_colfac_variants.py, variant overlap). Written
  // otherwise (the choice after the loop's arrivals) the 'mixed' loop
  // took 18.0 ms against 14.8.
  constexpr bool kOverlap = kMixed;
#pragma unroll 1
  for (int q = 0; q < 4; ++q) make(0, q);
  made(0);
#pragma unroll 1
  for (int c = 0; c < NC; ++c) {
    const bool more = c + 1 < NC;
    mbar_wait_cluster(&xfull[c & 1], (c >> 1) & 1);
    tile_products<NCH, TAIL, kPasses>(
        gb, gt, xs + (c & 1) * kXTile, ring, 8 * c, wg, r, t, [&](int h) {
          if (!kOverlap || !more) return;
          // every block has read tile c - 1 from the slot
          if (h == 0)
            mbar_wait_cluster(&xempty[(c + 1) & 1], (((c + 1) >> 1) & 1) ^ 1);
          make(c + 1, h);
        });
    __syncwarp();
    if (lane == 0)
      for (int p = 0; p < cs; ++p)
        mbar_arrive_peer(peer_addr(&xempty[c & 1], p));
    if (!kOverlap && more) {
      mbar_wait_cluster(&xempty[(c + 1) & 1], (((c + 1) >> 1) & 1) ^ 1);
      for (int q = 0; q < 4; ++q) make(c + 1, q);
    }
    if (more) made(c + 1);
  }

  // G' rows r, r + 8 of part wg: columns 8i + 2t, + 1 of each chunk
  float* gout = wg ? g_im : g_re;
  const auto put = [&](int col, float v0, float v1, int h) {
    const int j = j0 + r + 8 * h, p = zb * PB + col;
    if (j < nbatch && p < P)
      *reinterpret_cast<float2*>(
          gout + (static_cast<size_t>(j) * N + m) * P + p) =
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
  cluster_sync();
}

template <bool kMixed, int NCH, int TAIL, int kPasses>
cudaError_t launch_pass1(const SplitGeom& geo, uint32_t k0, uint32_t k1,
                         uint32_t stream_id, int draw0, int nbatch,
                         const float* tab, float* g_re, float* g_im, int N,
                         int Kq, int P, int LW, cudaStream_t stream) {
  constexpr int smem = pass1_smem(64 * NCH + TAIL, kPasses);
  auto* k_pass1 = split_pass1<kMixed, NCH, TAIL, kPasses>;
  cudaError_t err = cudaFuncSetAttribute(
      k_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(geo.nz, (nbatch + kXRows - 1) / kXRows, N);
  cfg.blockDim = dim3(kPass1Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, k_pass1, k0, k1, stream_id, draw0, nbatch,
                            tab, g_re, g_im, N, P, Kq, LW);
}

template <bool kMixed, int kPasses>
cudaError_t launch(uint32_t k0, uint32_t k1, uint32_t stream_id, int draw0,
                   int nbatch, const float* tab, float* g_re, float* g_im,
                   int N, int Kq, int P, int LW, cudaStream_t stream) {
  const SplitGeom geo = split_geom(P);
#define FAST_CASE(PB)                                                     \
  case PB:                                                                \
    return launch_pass1<kMixed, PB / 64, PB % 64, kPasses>(               \
        geo, k0, k1, stream_id, draw0, nbatch, tab, g_re, g_im, N, Kq, P, \
        LW, stream);
  switch (geo.PB) {
    FAST_CASE(16)
    FAST_CASE(32)
    FAST_CASE(48)
    FAST_CASE(64)
    FAST_CASE(80)
    FAST_CASE(96)
    FAST_CASE(112)
    FAST_CASE(128)
    FAST_CASE(144)
    FAST_CASE(160)
    FAST_CASE(176)
    FAST_CASE(192)
    FAST_CASE(208)
    default:
      return cudaErrorInvalidValue;
  }
#undef FAST_CASE
}

bool takes(int N, int P, int nbatch, int Kq, int LW) {
  return N > 0 && N <= 65535 && nbatch > 0 && Kq > 0 && Kq % 16 == 0 &&
         Kq <= LW && pass2_takes(P) &&
         (nbatch + kXRows - 1) / kXRows <= 65535 &&
         static_cast<uint64_t>(N) * static_cast<uint64_t>(LW) <= 0xFFFFFFFFull;
}

cudaError_t pass1(int passes, uint32_t k0, uint32_t k1, uint32_t stream_id,
                  int draw0, int nbatch, const float* tab, float* g_re,
                  float* g_im, int N, int P, int Kq, int LW, int mixed,
                  cudaStream_t stream) {
  return by_passes(passes, [&](auto kp) {
    constexpr int kP = decltype(kp)::value;
    return mixed ? launch<true, kP>(k0, k1, stream_id, draw0, nbatch, tab,
                                    g_re, g_im, N, Kq, P, LW, stream)
                 : launch<false, kP>(k0, k1, stream_id, draw0, nbatch, tab,
                                     g_re, g_im, N, Kq, P, LW, stream);
  });
}

}  // namespace

// Shapes: tab (N, nz, Kq64 / 8, 4, 8 PB), the factor table of Kq lanes
// split and laid out for pass 1 ((N, nz, Kq64 / 8, 2, 8 PB), hi alone, at
// one pass; ops/colfac_detect.py, lay_tables_split:
// nz slices of PB px as split_geom(P) cuts them, the lanes padded to
// Kq64, a multiple of 64); wpack, the laid W table of the detect pass
// (ops/synth_detect.py, laid_w); pm_t (P, P); sh_t nullptr or (nbatch, 2,
// P, P) transposed subharmonic screens; g_re, g_im scratch (nbatch, N,
// P); part scratch (nbatch, detect_parts(P), 4), the detect pass's partial
// sums; out (nbatch, 4) = (sum pm cos h1, sum pm sin h1, sum pm cos h2,
// sum pm sin h2). P is a multiple of 16; Kq, the noise lanes a column, is
// a multiple of 16, at most LW, the lane stride of the Philox counter.
// passes: the TF32 passes of every product, 1 or 3, which tab and wpack
// are laid out for. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int fast_colfac_split(uint32_t k0, uint32_t k1, uint32_t stream_id,
                                 int draw0, int nbatch, const float* tab,
                                 const float* wpack, const float* pm_t,
                                 const float* sh_t, float* g_re, float* g_im,
                                 float* part, float* out, int N, int P,
                                 int Kq, int LW, int mixed, int passes,
                                 void* stream) {
  if (!takes(N, P, nbatch, Kq, LW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = pass1(passes, k0, k1, stream_id, draw0, nbatch,
                                tab, g_re, g_im, N, P, Kq, LW, mixed, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_detect(passes, P, nbatch, wpack, g_re, g_im,
                                        pm_t, sh_t, part, out, N, st));
}

// Pass 1 alone: G' of nbatch draws into g_re, g_im (nbatch, N, P), as
// fast_colfac_split makes it before its detect pass. For timing the pass
// and holding it element by element against its plain version. Arguments
// as fast_colfac_split's.
extern "C" int fast_split_pass1(uint32_t k0, uint32_t k1, uint32_t stream_id,
                                int draw0, int nbatch, const float* tab,
                                float* g_re, float* g_im, int N, int P,
                                int Kq, int LW, int mixed, int passes,
                                void* stream) {
  if (!takes(N, P, nbatch, Kq, LW))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(pass1(passes, k0, k1, stream_id, draw0, nbatch,
                                tab, g_re, g_im, N, P, Kq, LW, mixed,
                                static_cast<cudaStream_t>(stream)));
}

extern "C" const char* fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
