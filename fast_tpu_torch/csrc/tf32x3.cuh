// Device code shared by the products that run on the tensor cores: TF32
// rounding and the hi/lo split of an fp32 operand, warp-level
// mma.sync.m16n8k8 TF32 products, and the asynchronous copies that stage
// their operands into shared memory. K2's and K7's pass 1
// (synth_detect.cu), the AR kernels' first DFT product (ar_flow.cu), K1's
// and K3's pass 1 (colfac_detect.cu, colfac_split.cu) and the iid kernels'
// detect pass (detect.cuh) use them; each says how it sums the three
// products of a step.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace fast {

// ---- tensor-core arithmetic: 3xTF32 mma.sync.m16n8k8 ----------------------

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest,
// ties away from zero, on the 13 low mantissa bits), in two integer
// instructions: sm_90's cvt.rna.tf32.f32 is a longer sequence, which also
// screens NaN and infinity
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b, a sum of its own (zero accumulators)
__device__ __forceinline__ void mma_tf32_new(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// An A fragment from shared memory already split: p points at word 2t of
// row g of a row-major tile with row stride S words; rows g and g + 8,
// words 2t (slots t) and 2t + 1 (slots t + 4).
__device__ __forceinline__ void load_a(const uint32_t* p, int S,
                                       uint32_t (&f)[4]) {
  const uint2 v0 = *reinterpret_cast<const uint2*>(p);
  const uint2 v1 = *reinterpret_cast<const uint2*>(p + 8 * S);
  f[0] = v0.x;
  f[1] = v1.x;
  f[2] = v0.y;
  f[3] = v1.y;
}

// Split a staged slice of (re, im) pairs into the B fragments' order:
// slice rows 8 ks + 2t and + 1 (fragment slots t and t + 4) of pair column
// 8 nt + g for lane (g, t), NT column blocks of 8 pairs, KS 8-deep steps;
// src has row stride TS floats (pair p at 2 p, 2 p + 1). Unit u = (ks NT +
// nt) 32 + lane of dst holds (re hi, re hi, re lo, re lo) of the two slots,
// unit u + KS NT 32 the same of im: a 16-byte shared load a lane each.
template <int KS, int NT, int TS>
__device__ __forceinline__ void split_pairs(uint4* dst, const float* src) {
  for (int u = threadIdx.x; u < KS * NT * 32; u += kThreads) {
    const int lane = u & 31, kt = u >> 5;
    const float* p = src + (8 * (kt / NT) + 2 * (lane & 3)) * TS +
                     2 * (8 * (kt % NT) + (lane >> 2));
    const float2 b0 = *reinterpret_cast<const float2*>(p);
    const float2 b1 = *reinterpret_cast<const float2*>(p + TS);
    uint4 r, i;
    split(b0.x, r.x, r.z);
    split(b1.x, r.y, r.w);
    split(b0.y, i.x, i.z);
    split(b1.y, i.y, i.w);
    dst[u] = r;
    dst[KS * NT * 32 + u] = i;
  }
}

// ---- asynchronous copies into shared memory -------------------------------

// Copy 16 bytes (vec) or 4 from src to dst, or zeros where !in.
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in,
                                         bool vec) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Start copying rows r0 .. r0 + nrows - 1, columns c0 .. c0 + W - 1 of a
// row-major matrix with row stride N into shared memory with row stride
// S; rows at or past `rows` and columns at or past N read as zeros. With
// vec (N a multiple of 4, aligned rows) in 16-byte pieces, else 4-byte ones.
template <int S, int W, int kWords>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int nrows, int rows,
                                           int N, int c0) {
  constexpr int per_row = W / kWords;
  for (int e = threadIdx.x; e < nrows * per_row; e += kThreads) {
    const int r = e / per_row, cc = (e % per_row) * kWords;
    const bool in = r0 + r < rows && c0 + cc < N;
    cp_async(dst + r * S + cc,
             in ? src + static_cast<size_t>(r0 + r) * N + c0 + cc : src, in,
             kWords == 4);
  }
}

template <int S, int W>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int r0, int nrows, int rows,
                                           int N, int c0, bool vec) {
  if (vec)
    stage_rows<S, W, 4>(dst, src, r0, nrows, rows, N, c0);
  else
    stage_rows<S, W, 1>(dst, src, r0, nrows, rows, N, c0);
}

}  // namespace fast
