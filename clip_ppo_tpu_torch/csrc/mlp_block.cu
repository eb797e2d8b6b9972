// K3: the MLP half of a pre-LN CLIP resblock,
//   out = x + proj(QuickGELU(fc(LN2(x)))),   QuickGELU(h) = h * sigmoid(1.702 h),
// with fp32 LayerNorm statistics, in float32.
//
// Replaces: clip_ppo_tpu/models/clip/pallas_block.py::_mlp_block_kernel
// (entry fused_mlp_block).
//
// Bound on Hopper: operations. At [1024, 77, 512] one layer is ~331 GFLOP
// against ~0.33 GB of activations and 8 MB of weights, so the least time is
// the flops over the fp32 CUDA-core peak.
//
// Design: one block per 32 rows of the flattened [B*T, D] input, in a single
// launch. The block writes LN2 of its rows into shared memory once, then walks
// the 4D hidden units in chunks of 64: it forms that [32, 64] slice of the
// hidden layer from LN2(x) and a streamed slice of fc, applies QuickGELU in
// shared memory, and folds it straight into a [32, D] register accumulator
// through the matching [D, 64] slice of proj. The [B, T, 4D] hidden therefore
// never exists in device memory; each block reads the 8 MB of weights through
// L2 once. Plain shared-memory-tiled fp32 FMA loops: right first, tensor
// cores later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;   // rows of x per block
constexpr int kHid = 64;    // hidden units per chunk
constexpr int kFK = 32;     // reduction slice of the fc product
constexpr int kPK = 16;     // reduction slice of the proj product
// The one width on this path: the ViT-B/32 text tower's. Other widths come
// with the models that use them, where they can be checked on the card.
constexpr int D = 512;
constexpr int DC = D / 64;  // output columns per thread
constexpr int kSmemFloats = kRows * D + kFK * kHid + kRows * (kHid + 1) + kPK * D;

__global__ void __launch_bounds__(kThreads) mlp_block_kernel(
    const float* __restrict__ x, const float* __restrict__ ln_g,
    const float* __restrict__ ln_b, const float* __restrict__ w_fc,
    const float* __restrict__ b_fc, const float* __restrict__ w_proj,
    const float* __restrict__ b_proj, float* __restrict__ out, int M,
    int D4, float eps) {
  extern __shared__ float smem[];
  float* y = smem;                 // [kRows][D]  LN2(x)
  float* wf = y + kRows * D;       // [kFK][kHid] fc slice, transposed
  float* hs = wf + kFK * kHid;     // [kRows][kHid + 1] activated hidden
  float* wp = hs + kRows * (kHid + 1);  // [kPK][D] proj slice, transposed

  const int m0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // -- LN2 of the block's rows into shared memory ----------------------------
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float* yr = y + r * D;
    const int m = m0 + r;
    if (m >= M) {
      for (int d = lane; d < D; d += 32) yr[d] = 0.0f;
      continue;
    }
    const float* xr = x + static_cast<size_t>(m) * D;
    float sum = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float v = xr[d];
      yr[d] = v;
      sum += v;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / D;
    float sq = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float c = yr[d] - mean;
      sq += c * c;
    }
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq / D + eps);
    for (int d = lane; d < D; d += 32) yr[d] = (yr[d] - mean) * rstd * ln_g[d] + ln_b[d];
  }
  __syncthreads();

  // Accumulator layout: rows rg + 4*i (i < 8), columns cg + 64*j (j < DC).
  const int rg = tid / 64, cg = tid % 64;
  float acc[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;
  // fc tile layout: rows fr and fr + 16, hidden columns fc_ + 16*q (q < 4).
  const int fr = tid / 16, fcol = tid % 16;

  for (int j0 = 0; j0 < D4; j0 += kHid) {
    // -- hidden slice [32, 64] = LN2(x) @ w_fc[j0:j0+64]^T ---------------------
    float h[2][4] = {};
    for (int k0 = 0; k0 < D; k0 += kFK) {
      for (int e = tid; e < kFK * kHid; e += kThreads) {
        const int u = e / kFK, kk = e % kFK;
        wf[kk * kHid + u] = w_fc[static_cast<size_t>(j0 + u) * D + k0 + kk];
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kFK; ++kk) {
        const float a0 = y[fr * D + k0 + kk];
        const float a1 = y[(fr + 16) * D + k0 + kk];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float w = wf[kk * kHid + fcol + 16 * q];
          h[0][q] = fmaf(a0, w, h[0][q]);
          h[1][q] = fmaf(a1, w, h[1][q]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = fcol + 16 * q;
      const float bias = b_fc[j0 + u];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v = h[i][q] + bias;
        hs[(fr + 16 * i) * (kHid + 1) + u] = v / (1.0f + __expf(-1.702f * v));
      }
    }
    __syncthreads();

    // -- acc += hidden slice @ w_proj[:, j0:j0+64]^T ---------------------------
    for (int k0 = 0; k0 < kHid; k0 += kPK) {
      for (int e = tid; e < kPK * D; e += kThreads) {
        const int n = e / kPK, kk = e % kPK;
        wp[kk * D + n] = w_proj[static_cast<size_t>(n) * D4 + j0 + k0 + kk];
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kPK; ++kk) {
        float a[8], w[DC];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = hs[(rg + 4 * i) * (kHid + 1) + k0 + kk];
#pragma unroll
        for (int j = 0; j < DC; ++j) w[j] = wp[kk * D + cg + 64 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // -- residual and bias -------------------------------------------------------
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + rg + 4 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int n = cg + 64 * j;
      const size_t o = static_cast<size_t>(m) * D + n;
      out[o] = x[o] + (acc[i][j] + b_proj[n]);
    }
  }
}

}  // namespace

extern "C" {

// x, out: [M, D]; w_fc: [D4, D]; b_fc: [D4]; w_proj: [D, D4]; b_proj, ln_g,
// ln_b: [D]. D == 512; D4 % 64 == 0.
int mlp_block_launch(const float* x, const float* ln_g, const float* ln_b,
                     const float* w_fc, const float* b_fc, const float* w_proj,
                     const float* b_proj, float* out, int M, int width, int D4,
                     float eps, void* stream) {
  if (width != D || D4 % kHid != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_block_kernel<<<(M + kRows - 1) / kRows, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, ln_g, ln_b, w_fc, b_fc, w_proj, b_proj, out, M, D4, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
