// LayerNorm row statistics shared by K2 (csrc/attn_block.cu), K3
// (csrc/mlp_block.cu), K5 (csrc/mlp_stream.cu), K6 (csrc/attn_stream.cu) and
// K7 (csrc/mlp_chunked.cu): stats[m] = (mean, 1 / sqrt(var + eps)) of row m
// of a [M, D] float32 or bfloat16 tensor, always in float32 (the TPU
// kernels' _ln takes fp32 statistics whatever the compute dtype), the
// variance taken about the mean (two passes), as the plain versions'
// layer_norm computes it. One warp per row. The kernels that consume the
// statistics apply the normalisation and the affine where they load the
// rows, so LN(x) itself never reaches device memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ln_stats {

constexpr int kThreads = 256;

// An element widened to fp32 as it is read: the sums and the statistics
// stay fp32 whatever x's type.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads) ln_stats_kernel(const T* __restrict__ x,
                                                            float2* __restrict__ stats, int M,
                                                            int D, float eps) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // warp-uniform
  const T* xr = x + row * D;
  float sum = 0.0f;
  for (int d = lane; d < D; d += 32) sum += to_float(xr[d]);
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / D;
  float sq = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float c = to_float(xr[d]) - mean;
    sq += c * c;
  }
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if (lane == 0) stats[row] = make_float2(mean, rsqrtf(sq / D + eps));
}

// T is float or __nv_bfloat16. Returns a cudaError_t.
template <typename T>
int launch(const T* x, float2* stats, int M, int D, float eps, cudaStream_t st) {
  const long long blocks = (static_cast<long long>(M) * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ln_stats_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(x, stats, M, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ln_stats
