// Device code shared by the products that run on the tensor cores: TF32
// rounding and the hi/lo split of an fp32 operand, and the 4- and 16-byte
// asynchronous copies (cp.async) that stage an A operand into shared
// memory.
//
// Every product of the kernels is a Hopper warpgroup product (wgmma.cuh):
// pass 1 of K2 and K7 (synth_detect.cu), of K1 (colfac_detect.cu) and of
// K3 (colfac_split.cu), the iid kernels' second pass and the AR kernels'
// two products (detect.cuh, ar_flow.cu), with B split once by the wrapper
// and staged by bulk copies on mbarriers, A split in registers, and fold
// groups of two 8-deep steps added in fp32 (at PRECISION='default' one
// TF32 pass: both operands rounded once, wgmma.cuh). Moving them off mma.sync took
// K2's 256^2 'mixed' pass from 16.5 to 7.4 ms a 4096 draws, K7's 1024^2 G'
// from 134.9 to 33.8 ms a 630 (scripts/torch_pass1_ab.py), K1's 512^2 pass
// from 5.87 to 3.59 ms a 4096 and K3's 1024^2 'mixed' pass from 29.7-29.9
// to 14.4-14.5 ms a 630 (scripts/torch_colfac_ab.py; H100 80GB HBM3, 700
// W, the parent in turns): with the fragment loads of B, its split in
// registers and the per-step barriers gone, what bounds them is the noise
// and the fragment work of A around the products (the kernels' notes say
// how much of each).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace fast {

// ---- the 3xTF32 split -----------------------------------------------------

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

}  // namespace fast
