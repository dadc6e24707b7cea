// Hopper's asynchronous tensor-core path, shared by the kernels that use
// it (pass 1 of K2 and K7, synth_detect.cu; of K1, colfac_detect.cu; of
// K3, colfac_split.cu; the detect and screens passes of detect.cuh, which
// the AR kernels' two products of ar_flow.cu also run):
// warpgroup products (wgmma.mma_async, TF32, A from registers, B from
// shared memory through a matrix descriptor), the 1-D bulk copies
// (cp.async.bulk) that stage operands from device memory, the mbarriers
// the copies complete on, thread-block clusters, and the pieces the passes
// build from them (the ring of B stages, the fold groups of TF32
// products, the products over a 64-deep tile of A). sm_90a only: wgmma
// does not exist for plain sm_90.
//
// Passes. Every product runs in kPasses TF32 passes, a template argument
// that the kernels' C entries take at run time (by_passes) from the
// PRECISION of the caller: 3 (3xTF32, 'high' and 'highest') splits each
// operand element into hi = tf32(x) and lo = tf32(x - hi) and sums
// a_lo b_hi + a_hi b_lo + a_hi b_hi, fp32-accurate; 1 ('default', the
// JAX package's single bf16 pass, here on TF32's 10-bit mantissa) rounds
// each element once to TF32 and sums a_hi b_hi. A B operand is laid out
// with its hi and lo planes (3 passes) or its hi plane alone (1): half
// the bytes a ring stage.
//
// B's layout in shared memory ("core matrices", no swizzle). wgmma reads
// a K-major B of an 8-deep step and n columns as 8 x 16-byte core
// matrices: column c, depth slot s (0..7) is word
//   (c / 8) * 64 + (s / 4) * 32 + (c % 8) * 4 + s % 4
// of the step's n * 8 words, so the step's two core matrices of an 8-column
// block are 128 bytes apart (the leading byte offset) and 8-column blocks
// 256 bytes apart (the stride byte offset). Every 128-byte core matrix is
// contiguous, so the tensor cores read it without bank conflicts. The
// wrappers lay their tables out so (ops/synth_detect.py, _core_layout;
// ops/colfac_detect.py, lay_tables and lay_tables_split), and a step of a
// stage is one contiguous block of n * 32 bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace fast {

// ---- the pass count ---------------------------------------------------------

// TF32 planes of a B operand a step lays out: hi and lo (3 passes) or hi
// alone (1).
__host__ __device__ constexpr int b_planes(int kPasses) {
  return kPasses == 1 ? 1 : 2;
}

// f(std::integral_constant<int, kPasses>{}) for a pass count taken at run
// time: 1 or 3, else cudaErrorInvalidValue (no other count is built).
template <class F>
cudaError_t by_passes(int passes, F f) {
  if (passes == 1) return f(std::integral_constant<int, 1>{});
  if (passes == 3) return f(std::integral_constant<int, 3>{});
  return cudaErrorInvalidValue;
}

// ---- wgmma ----------------------------------------------------------------

// Matrix descriptor of a K-major B step at shared address `p` in the
// layout above (no swizzle).
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// Orders this thread's register and shared-memory writes before the
// wgmma that follow (needed before a product reads registers written by
// ordinary instructions).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator or an
// A fragment across the (volatile) wgmma fence, commit and wait
// instructions, so that ptxas sees every register a product uses settled
// before its fence and read only after its wait (else it serializes the
// products or injects fences of its own).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x N per warpgroup, N / 2 floats a thread) = a b (acc == 0) or
// d + a b: a 64 x 8 TF32 A from registers (the m16n8k8 fragment of each
// warp's 16 rows), B an 8-deep K-major step of N columns at descriptor b.
// The sum is the tensor cores', rounded toward zero.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<48>(float (&d)[24],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ---- bulk copies and mbarriers -------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised mbarriers visible to the asynchronous proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` of copies to complete on `bar`.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One arrival on `bar` once every cp.async this thread issued before has
// landed (the barrier's count includes it: noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory to shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- thread-block clusters ------------------------------------------------

// This block's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// The number of blocks in this block's cluster.
__device__ __forceinline__ int cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return static_cast<int>(n);
}

// The address of `p` (this block's shared memory) in the shared memory of
// the cluster's block `rank`, for the st/mbarrier forms below.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_peer(uint32_t addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y)
               : "memory");
}

// Arrive on an mbarrier of another block of the cluster (peer_addr),
// releasing this thread's earlier writes to the cluster.
__device__ __forceinline__ void mbar_arrive_peer(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

// mbar_wait that also acquires what other blocks of the cluster released
// to the barrier.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// All threads of all blocks of the cluster (threads may arrive apart).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// Give this warpgroup's threads kRegs registers each (more for the
// consumers, fewer for a producer that only issues copies); all four warps
// of the warpgroup execute it.
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// A barrier of `count` threads (a multiple of 32) on hardware barrier `id`
// (1..15; __syncthreads() is 0).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- pass 1's building blocks ----------------------------------------------

// The ring of B stages: stage `it` of the schedule lands in slot it %
// kStages; full[slot] completes when its bytes have landed, empty[slot]
// when the consumer warps are done with it (each warp's lane 0 arrives;
// the barrier counts the consumer warps).
template <int kStages>
struct Ring {
  float* slots;
  uint64_t* full;
  uint64_t* empty;
  int words;

  __device__ __forceinline__ const float* take(uint32_t it) const {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    return slots + s * words;
  }
  __device__ __forceinline__ void release(uint32_t it) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[it % kStages]);
  }
  __device__ __forceinline__ void load(uint32_t it, const float* src,
                                       uint32_t bytes) const {
    const int s = it % kStages;
    mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
    mbar_expect(&full[s], bytes);
    bulk_copy(slots + s * words, src, bytes, &full[s]);
  }
};

// Word of float pair f of row r in a shared tile whose rows hold `words`
// words: the pair index XOR 4 (r % 4), so that a warp's 64-bit fragment
// loads (rows g, pairs 4 s + t) hit every bank once.
__device__ __forceinline__ int swz(int r, int f, int words) {
  return r * words + 2 * (f ^ ((r & 3) << 2));
}

// One A operand of an 8-deep step: hi and lo fragments (lo unused, and
// left to the compiler to drop, at one pass).
struct Frag {
  uint32_t h[4], l[4];
};

// Four A values, negated (exactly: the sign bits) if neg: split into hi
// and lo (3 passes) or rounded once to TF32 (1).
template <int kPasses>
__device__ __forceinline__ Frag split_frag(const float (&x)[4], bool neg) {
  const uint32_t s = neg ? 0x80000000u : 0u;
  Frag a;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    if constexpr (kPasses == 1) {
      a.h[v] = to_tf32(x[v]) ^ s;
      a.l[v] = 0u;
    } else {
      split(x[v], a.h[v], a.l[v]);
      a.h[v] ^= s;
      a.l[v] ^= s;
    }
  }
  return a;
}

// The A fragment of a warp's rows g and g + 8 at float pair f of a
// shared tile (rows of `words` words), split (split_frag), negated if
// neg. Depth slots t and t + 4 hold the pair's two values, depths 2t and
// 2t + 1 of the step: the tables' slot order.
template <int kPasses>
__device__ __forceinline__ Frag load_frag(const float* tile, int r, int f,
                                          int words, bool neg) {
  const float2 v0 = *reinterpret_cast<const float2*>(tile + swz(r, f, words));
  const float2 v1 =
      *reinterpret_cast<const float2*>(tile + swz(r + 8, f, words));
  return split_frag<kPasses>({v0.x, v1.x, v0.y, v1.y}, neg);
}

// d = the sum over a fold group's two 8-deep steps and NT terms of a b, in
// a fresh accumulator, each wgmma adding 8 products to the tensor cores'
// sum; then commit. 3 passes: the small terms a_lo b_hi + a_hi b_lo of
// every step first, then the a_hi b_hi; 1: the a_hi b_hi alone. bh, bl:
// descriptors of the B steps' hi and lo (bl unused at one pass).
template <int N, int NT, int kPasses>
__device__ __forceinline__ void mma_group(float (&d)[N / 2],
                                          Frag (&a)[NT][2],
                                          const uint64_t (&bh)[NT][2],
                                          const uint64_t (&bl)[NT][2]) {
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      fence_regs(a[q][s].h);
      if constexpr (kPasses != 1) fence_regs(a[q][s].l);
    }
  fence_regs(d);
  wgmma_fence();
  if constexpr (kPasses != 1) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        wgmma_tf32<N>(d, a[q][s].l, bh[q][s], s + q);
        wgmma_tf32<N>(d, a[q][s].h, bl[q][s], 1);
      }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int q = 0; q < NT; ++q)
      wgmma_tf32<N>(d, a[q][s].h, bh[q][s],
                    kPasses == 1 ? s + q : 1);
  wgmma_commit();
}

// Wait until at most kPending groups are in flight, then add the sum d of
// one that has landed to the fp32 sum acc: round to nearest.
template <int kPending = 0, int R>
__device__ __forceinline__ void fold(float (&acc)[R], float (&d)[R]) {
  wgmma_wait<kPending>();
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += d[i];
}

// An x tile: the A operand of 64 rows (a warpgroup's wgmma M) by 64 deep
// (8 steps, 4 fold groups), real and imaginary planes of kXRows x kXDepth
// floats, float pairs swizzled by row (swz).
constexpr int kXRows = 64;
constexpr int kXDepth = 64;
constexpr int kXTile = 2 * kXRows * kXDepth;

// The A fragment of part `part` (0 real, 1 imaginary) of an x tile at
// 8-deep step `step` for the thread's rows r, r + 8 and quad lane t, split
// and negated if neg. tile_products takes its A through this; a tile of
// another layout brings an overload of its own (detect.cuh, KTile).
template <int kPasses>
__device__ __forceinline__ Frag a_frag(const float* x, int part, int step,
                                       int r, int t, bool neg) {
  return load_frag<kPasses>(x + part * kXRows * kXDepth, r, 4 * step + t,
                            kXDepth, neg);
}

// The complex product G' += x B of one A tile `x` (an x tile, or any tile
// with an a_frag overload) against 8 stages of the ring from `it` on, one
// 8-deep step each: B_r hi, B_r lo, B_i hi, B_i lo (3 passes) or B_r hi,
// B_i hi (1) over PB = 64 NCH + TAIL columns (8 PB words each, the
// core-matrix layout), in kPasses TF32 passes. Consumer warpgroup wg makes
// part wg of G': 0 (Re) takes x_r B_r
// and -x_i B_i (the sign flipped in the A fragment, exactly), 1 (Im) x_r
// B_i and x_i B_r; the thread's rows are r and r + 8. In 4 fold groups of
// 2 steps, over the columns in chunks of 64 and the tail, two chunks in
// flight (chunk u + 1 is issued before chunk u is folded into gb, gt);
// `between(h)` runs while group h's first chunk is in flight. Every group
// has landed when it returns: ptxas cannot follow a group in flight
// around a loop (it then serializes every wgmma, warning C7514).
template <int NCH, int TAIL, int kPasses, int kStages, class ATile,
          class Between>
__device__ __forceinline__ void tile_products(
    float (&gb)[NCH > 0 ? NCH : 1][32],
    float (&gt)[(TAIL > 0 ? TAIL : 16) / 2], ATile x,
    const Ring<kStages>& ring, uint32_t it, int wg, int r, int t,
    Between between) {
  constexpr int PB = 64 * NCH + TAIL;
  constexpr int TW = TAIL > 0 ? TAIL : 16;  // the tail's wgmma width
  constexpr int NU = NCH + (TAIL > 0 ? 1 : 0);
  constexpr int kPl = b_planes(kPasses);
#pragma unroll 1
  for (int h = 0; h < 4; ++h) {
    Frag a[2][2];
    const float* st[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      st[s] = ring.take(it + 2 * h + s);
      a[0][s] = a_frag<kPasses>(x, 0, 2 * h + s, r, t, false);
      a[1][s] = a_frag<kPasses>(x, 1, 2 * h + s, r, t, wg == 0);
    }
    // term 0 with B_r (Re) or B_i (Im), term 1 with B_i (Re) or B_r (Im)
    const auto descs = [&](int col, uint64_t (&bh)[2][2],
                           uint64_t (&bl)[2][2]) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float* tab =
              st[s] + ((q ^ wg) ? kPl : 0) * PB * 8 + col * 8;
          bh[q][s] = b_desc(tab);
          bl[q][s] = b_desc(tab + PB * 8);
        }
    };
    float d[2][32];
    const auto issue = [&](int u, float (&dd)[32]) {
      uint64_t bh[2][2], bl[2][2];
      descs(64 * u, bh, bl);
      if (u < NCH)
        mma_group<64, 2, kPasses>(dd, a, bh, bl);
      else
        mma_group<TW, 2, kPasses>(reinterpret_cast<float(&)[TW / 2]>(dd), a,
                                  bh, bl);
    };
    const auto land = [&](int u, float (&dd)[32], bool more) {
      auto& dt = reinterpret_cast<float(&)[TW / 2]>(dd);
      if (u < NCH) {
        if (more) fold<1>(gb[u], dd); else fold(gb[u], dd);
      } else {
        if (more) fold<1>(gt, dt); else fold(gt, dt);
      }
    };
    issue(0, d[0]);
    between(h);
#pragma unroll
    for (int u = 1; u < NU; ++u) {
      issue(u, d[u & 1]);
      land(u - 1, d[(u - 1) & 1], true);
    }
    land(NU - 1, d[(NU - 1) & 1], false);
#pragma unroll
    for (int s = 0; s < 2; ++s) ring.release(it + 2 * h + s);
  }
}

}  // namespace fast
