// LayerNorm row statistics shared by K2 (csrc/attn_block.cu), K5
// (csrc/mlp_stream.cu), K6 (csrc/attn_stream.cu) and K7
// (csrc/mlp_chunked.cu): stats[m] = (mean, 1 / sqrt(var + eps)) of row m of a
// [M, D] float32 tensor, the variance taken about the mean (two passes), as
// the plain versions' layer_norm computes it. One warp per row. The kernels
// that consume the statistics apply the normalisation and the affine where
// they load the rows, so LN(x) itself never reaches device memory.

#pragma once

#include <cuda_runtime.h>

namespace ln_stats {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) ln_stats_kernel(const float* __restrict__ x,
                                                            float2* __restrict__ stats, int M,
                                                            int D, float eps) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // warp-uniform
  const float* xr = x + row * D;
  float sum = 0.0f;
  for (int d = lane; d < D; d += 32) sum += xr[d];
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / D;
  float sq = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float c = xr[d] - mean;
    sq += c * c;
  }
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if (lane == 0) stats[row] = make_float2(mean, rsqrtf(sq / D + eps));
}

inline int launch(const float* x, float2* stats, int M, int D, float eps, cudaStream_t st) {
  const long long blocks = (static_cast<long long>(M) * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ln_stats_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(x, stats, M, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ln_stats
