// Device code shared by the products that run on the tensor cores: TF32
// rounding and the hi/lo split of an fp32 operand, warp-level
// mma.sync.m16n8k8 TF32 products, and the asynchronous copies (cp.async)
// that stage their operands into shared memory. The AR kernels' first DFT
// product (ar_flow.cu) uses them and says how it sums the three products
// of a step.
//
// Pass 1 of K2 and K7 (synth_detect.cu), of K1 (colfac_detect.cu) and of
// K3 (colfac_split.cu), and the iid kernels' second pass (detect.cuh),
// take only the split from here: their products are
// Hopper's warpgroup products (wgmma.cuh), with B split once by the
// wrapper and staged by bulk copies on mbarriers, A split in registers,
// and fold groups of two 8-deep steps added in fp32. Moving them off
// mma.sync took K2's 256^2 'mixed' pass from 16.5 to 7.4 ms a 4096 draws,
// K7's 1024^2 G' from 134.9 to 33.8 ms a 630 (scripts/torch_pass1_ab.py),
// K1's 512^2 pass from 5.87 to 3.59 ms a 4096 and K3's 1024^2 'mixed'
// pass from 29.7-29.9 to 14.4-14.5 ms a 630 (scripts/torch_colfac_ab.py;
// H100 80GB HBM3, 700 W, the parent in turns): with the fragment loads of
// B, its split in registers and the per-step barriers gone, what bounds
// them is the noise and the fragment work of A around the products (the
// kernels' notes say how much of each).

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
