// The primitives shared by the attention tile (attention_tile.cuh: K4, K8 and
// the attention stage of K2 and K6) and the GEMM (gemm_tf32x3.cuh: K2, K5, K6
// and K7): cp.async staging into shared memory, and the small part of the
// truncating TF32 split.
//
// The split. A TF32 operand keeps 10 mantissa bits. The H100's tensor core
// reads only the top 19 bits of a .tf32 operand (it ignores the low 13), so
// x = big + small needs no rounding instruction: big is x's own bits, read as
// trunc(x), and small is x - trunc(x), exact in fp32 (one LOP3 and one FADD),
// read as trunc(x - trunc(x)). A product a * b then runs as three TF32 passes,
// a_small * b_big + a_big * b_small + a_big * b_big, which keep about 20 bits:
// tests/port/test_torch_tf32_split.py and test_torch_tf32_gemm.py emulate it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// 16 bytes from device memory to shared memory, bypassing L1; src_bytes = 0
// fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x - trunc(x), exact: the part of x that a TF32 read of x drops.
__device__ __forceinline__ float small_part(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

}  // namespace tf32x3
