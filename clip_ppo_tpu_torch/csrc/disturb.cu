// K1: the batched-semantics disturbance, noise -> contrast -> blur -> cutout,
// in one pass per image.
//
// Replaces: clip_ppo_tpu/ops/pallas_disturb.py::_disturb_kernel (entry
// disturb_pallas). Same function: Gaussian noise clamped to [0,1]; contrast
// blend toward the per-image luma mean (channel mean when C != 3) with one
// factor for the batch; separable Gaussian blur with BORDER_REFLECT_101; one
// cutout rectangle shared by the batch.
//
// Bound on Hopper: bytes. Per image the function reads H*W*C floats and writes
// as many, about 85 KB at 84x84x3, and does a few dozen flops per element, so
// the least time for the [8,84,84,3] batch is well under a microsecond. What
// bounds this design instead is its grid: one block per image is 8 blocks on
// the card's 132 SMs, so each image's noise draws and blur passes run on one
// SM while the rest idle. Design: one block per image. The image stays in
// shared memory from the first read to the last write (two planar buffers,
// one for the contrast output and one for the vertical blur pass), so device
// memory sees exactly one read and one write per element. The banded-matmul
// blur of the TPU kernel was a matrix-unit trick; here each output sums
// ksize taps with reflect-101 indices. Noise is either read from an input
// tensor (exact parity with a reference) or drawn in the kernel from a
// counter-based Philox4x32-10 keyed by (seed, image) with the element index
// as counter. The contrast factor, the noise seed and the cutout origin are
// read from device memory, so the caller never synchronises to pass them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxTaps = 31;

// Luma weights of torchvision's rgb_to_grayscale.
__device__ __forceinline__ float luma(int c) {
  return c == 0 ? 0.2989f : (c == 1 ? 0.587f : 0.114f);
}

__device__ __forceinline__ void philox_round(uint32_t (&c)[4], uint32_t (&k)[2]) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  uint32_t hi0 = __umulhi(M0, c[0]), lo0 = M0 * c[0];
  uint32_t hi1 = __umulhi(M1, c[2]), lo1 = M1 * c[2];
  uint32_t n0 = hi1 ^ c[1] ^ k[0];
  uint32_t n2 = hi0 ^ c[3] ^ k[1];
  c[0] = n0; c[1] = lo1; c[2] = n2; c[3] = lo0;
  k[0] += 0x9E3779B9u;
  k[1] += 0xBB67AE85u;
}

// One standard normal for element `idx` of image `img`: Philox4x32-10 on
// counter (idx, 0, 0, 0) with key (seed, img), Box-Muller on two outputs.
__device__ __forceinline__ float philox_normal(uint32_t seed, uint32_t img, uint32_t idx) {
  uint32_t c[4] = {idx, 0u, 0u, 0u};
  uint32_t k[2] = {seed, img};
#pragma unroll
  for (int r = 0; r < 10; ++r) philox_round(c, k);
  const float inv = 1.0f / 4294967296.0f;
  float u1 = (static_cast<float>(c[0]) + 0.5f) * inv;  // (0, 1)
  float u2 = (static_cast<float>(c[1]) + 0.5f) * inv;
  u1 = fminf(u1, 1.0f - 1e-7f);
  return sqrtf(-2.0f * logf(u1)) * cospif(2.0f * u2);
}

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  float s = red[0];
  __syncthreads();
  return s;
}

// x, noise, out: [B, H, W, C] float32 (NHWC). iscalars: int32 [3] =
// (seed, r0, c0). factor: float32 [1]. taps: float32 [ksize].
__global__ void __launch_bounds__(kThreads) disturb_kernel(
    const float* __restrict__ x, const float* __restrict__ noise,
    const int32_t* __restrict__ iscalars, const float* __restrict__ factor_p,
    const float* __restrict__ taps_g, float* __restrict__ out, int H, int W,
    int C, float sigma, int ksize, int ph, int pw) {
  extern __shared__ float smem[];
  const int n = H * W * C;
  const int hw = H * W;
  float* a = smem;       // [C][H][W] after noise and contrast
  float* bbuf = a + n;   // [C][H][W] after the vertical pass
  __shared__ float red[32];
  __shared__ float taps[kMaxTaps];
  const int img = blockIdx.x;
  const float* xi = x + static_cast<size_t>(img) * n;
  const float* ni = noise ? noise + static_cast<size_t>(img) * n : nullptr;
  const uint32_t seed = static_cast<uint32_t>(iscalars[0]);
  const int r0 = iscalars[1], c0 = iscalars[2];
  const float f = factor_p[0];
  if (threadIdx.x < ksize) taps[threadIdx.x] = taps_g[threadIdx.x];

  // -- noise, clamped; luma (or channel) partial sums ----------------------
  float part = 0.0f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    float v = xi[e];
    if (sigma > 0.0f) {
      float z = ni ? ni[e] : philox_normal(seed, static_cast<uint32_t>(img), static_cast<uint32_t>(e));
      v = fminf(fmaxf(v + sigma * z, 0.0f), 1.0f);
    }
    const int c = e % C, p = e / C;
    a[c * hw + p] = v;
    part += (C == 3) ? luma(c) * v : v;
  }
  const float mean = block_sum(part, red) / static_cast<float>(C == 3 ? hw : n);

  // -- contrast blend toward the mean ----------------------------------------
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    a[e] = fminf(fmaxf(f * a[e] + (1.0f - f) * mean, 0.0f), 1.0f);
  }
  __syncthreads();

  // -- blur along H (rows), reflect-101 -------------------------------------
  const int half = ksize / 2;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e / hw, r = (e / W) % H, col = e % W;
    const float* plane = a + c * hw;
    float s = 0.0f;
    for (int k = 0; k < ksize; ++k) s += taps[k] * plane[reflect101(r + k - half, H) * W + col];
    bbuf[e] = s;
  }
  __syncthreads();

  // -- blur along W, cutout, write NHWC --------------------------------------
  float* oi = out + static_cast<size_t>(img) * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e % C, p = e / C, r = p / W, col = p % W;
    const float* row = bbuf + c * hw + r * W;
    float s = 0.0f;
    for (int k = 0; k < ksize; ++k) s += taps[k] * row[reflect101(col + k - half, W)];
    const bool inside = r >= r0 && r < r0 + ph && col >= c0 && col < c0 + pw;
    oi[e] = inside ? 0.0f : s;
  }
}

__global__ void normal_kernel(float* __restrict__ out, uint32_t seed, uint32_t img, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) out[e] = philox_normal(seed, img, static_cast<uint32_t>(e));
}

}  // namespace

extern "C" {

int disturb_launch(const float* x, const float* noise, const int32_t* iscalars,
                   const float* factor, const float* taps, float* out, int B,
                   int H, int W, int C, float sigma, int ksize, int ph, int pw,
                   void* stream) {
  if (ksize > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * H * W * C * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      disturb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  disturb_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, noise, iscalars, factor, taps, out, H, W, C, sigma, ksize, ph, pw);
  return static_cast<int>(cudaGetLastError());
}

// The in-kernel noise stream for image `img`, for checking its distribution.
int philox_normal_launch(float* out, uint32_t seed, uint32_t img, int n, void* stream) {
  normal_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, seed, img, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
