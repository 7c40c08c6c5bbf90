// The float32 -> tf32 operand split of the 3xTF32 tensor-core products
// (gemm_tf32x3.cuh; conv3x3_dw.cu's float32 body): a = hi + lo + r, with
// hi = rna(a), lo = rna(a - hi) (round to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds). lo.hi + hi.lo + hi.hi keeps ~22 of float32's
// 24 significand bits of a product; lo.lo and r are dropped.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// The bits of cvt.rna.tf32.f32(a) for every finite a (and an infinity or
// a NaN for those): half a tf32 step added to the magnitude, the 13 low
// bits cleared. Two integer operations on the full-rate pipe instead of a
// conversion instruction.
__device__ __forceinline__ uint32_t rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = rna(a);
  lo = rna(a - __uint_as_float(hi));
}

}  // namespace tf32
