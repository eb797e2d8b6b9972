// K2: the attention half of a pre-LN CLIP resblock,
//   out = x + out_proj(MHA(qkv_proj(LN1(x)))),
// with fp32 LayerNorm statistics and an optional causal mask, in float32.
//
// Replaces: clip_ppo_tpu/models/clip/pallas_block.py::_attn_block_kernel
// (entry fused_attn_block).
//
// Bound on Hopper: operations. At the text-table shape [1024, 77, 512] one
// layer is ~178 GFLOP (qkv 124, out-proj 41, attention 12) against ~0.3 GB of
// activations and weights, far above the fp32 ridge point, so the least time
// is the flops over the fp32 CUDA-core peak. The same holds at the vision
// tower's [1024, 50, 768], non-causal: 249.5 GFLOP.
//
// Design: two launches.
//   1. attn_heads_kernel, one block per (batch element, head): LN1 of the
//      element's rows is formed on the fly while tiles of it stream through
//      shared memory into the head's q/k/v projection (a [T, 3*64] tile of
//      the [B, T, 3D] qkv that never leaves the SM), then each warp runs the
//      softmax attention of one query row at a time. Only the [B, T, D]
//      attention output is written to device memory.
//   2. linear_residual_kernel: out = x + attn @ W_out^T + b_out, a tiled fp32
//      product with the bias and residual in its epilogue.
// So the one intermediate that round-trips device memory is the attention
// output (as large as x); the qkv buffer (3x that) and LN1(x) never do.
// Both products are plain shared-memory-tiled fp32 FMA loops: simple and
// right first; tensor cores (TF32 wgmma) would change the numerics and are
// later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeadDim = 64;
constexpr int kQKV = 3 * kHeadDim;  // q, k, v columns of one head
constexpr int kBK = 32;             // reduction slice of the qkv product

struct HeadSmem {
  float* mean;  // [TP]
  float* rstd;  // [TP]
  float* ys;    // [kBK][TP]  LN1(x) slice, transposed
  float* ws;    // [kBK][kQKV] weight slice, transposed
  float* q;     // [T][64]
  float* k;     // [T][65]  padded against bank conflicts
  float* v;     // [T][64]
  float* p;     // [8][TP]  softmax row per warp
};

// Rows per thread in the qkv tile; the tile covers TP = 16 * RI >= T rows.
// RI = 5 covers T <= 80: the text context of 77 tokens and ViT-B/32's 50
// (the tile's rows past T are zero). ViT-B/16's 197 tokens need a longer
// tile, checked on the card with the model that uses it.
constexpr int RI = 5;
constexpr int TP = 16 * RI;

__host__ __device__ inline int head_smem_floats(int T) {
  return 2 * TP + kBK * TP + kBK * kQKV + T * 64 + T * 65 + T * 64 + 8 * TP;
}

__global__ void __launch_bounds__(kThreads) attn_heads_kernel(
    const float* __restrict__ x, const float* __restrict__ ln_g,
    const float* __restrict__ ln_b, const float* __restrict__ w_qkv,
    const float* __restrict__ b_qkv, float* __restrict__ attn, int T, int D,
    int causal, float eps) {
  extern __shared__ float smem[];
  HeadSmem s;
  s.mean = smem;
  s.rstd = s.mean + TP;
  s.ys = s.rstd + TP;
  s.ws = s.ys + kBK * TP;
  s.q = s.ws + kBK * kQKV;
  s.k = s.q + T * 64;
  s.v = s.k + T * 65;
  s.p = s.v + T * 64;

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* xb = x + static_cast<size_t>(b) * T * D;

  // -- LN1 statistics per row (two passes, fp32) -----------------------------
  for (int t = warp; t < T; t += kThreads / 32) {
    const float* row = xb + static_cast<size_t>(t) * D;
    float sum = 0.0f;
    for (int d = lane; d < D; d += 32) sum += row[d];
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / D;
    float sq = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float c = row[d] - mean;
      sq += c * c;
    }
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if (lane == 0) {
      s.mean[t] = mean;
      s.rstd[t] = rsqrtf(sq / D + eps);
    }
  }
  __syncthreads();

  // -- q/k/v of this head: [T, 192] = LN1(x_b) @ W_h^T, K = D ----------------
  const int ty = tid / 16, tx = tid % 16;
  float acc[RI][12];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    for (int e = tid; e < kBK * TP; e += kThreads) {
      const int t = e / kBK, kk = e % kBK;
      float val = 0.0f;
      if (t < T) {
        const int d = k0 + kk;
        val = (xb[static_cast<size_t>(t) * D + d] - s.mean[t]) * s.rstd[t] * ln_g[d] + ln_b[d];
      }
      s.ys[kk * TP + t] = val;
    }
    for (int e = tid; e < kBK * kQKV; e += kThreads) {
      const int n = e / kBK, kk = e % kBK;
      const int wrow = (n / kHeadDim) * D + h * kHeadDim + (n % kHeadDim);
      s.ws[kk * kQKV + n] = w_qkv[static_cast<size_t>(wrow) * D + k0 + kk];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[RI], w[12];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = s.ys[kk * TP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 12; ++j) w[j] = s.ws[kk * kQKV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 12; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int t = ty + 16 * i;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int n = tx + 16 * j;
      const int part = n / kHeadDim, c = n % kHeadDim;
      const float val = acc[i][j] + b_qkv[part * D + h * kHeadDim + c];
      if (part == 0) s.q[t * 64 + c] = val;
      else if (part == 1) s.k[t * 65 + c] = val;
      else s.v[t * 64 + c] = val;
    }
  }
  __syncthreads();

  // -- softmax attention, one query row per warp at a time -------------------
  const float scale = rsqrtf(static_cast<float>(kHeadDim));
  float* pw = s.p + warp * TP;
  for (int t = warp; t < T; t += kThreads / 32) {
    const int jmax = causal ? t + 1 : T;
    float sc[(TP + 31) / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < (TP + 31) / 32; ++m) {
      const int j = lane + 32 * m;
      float val = -INFINITY;
      if (j < jmax) {
        float dot = 0.0f;
#pragma unroll 16
        for (int c = 0; c < kHeadDim; ++c) dot = fmaf(s.q[t * 64 + c], s.k[j * 65 + c], dot);
        val = dot * scale;
      }
      sc[m] = val;
      mx = fmaxf(mx, val);
    }
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
#pragma unroll
    for (int m = 0; m < (TP + 31) / 32; ++m) {
      const int j = lane + 32 * m;
      const float e = j < jmax ? __expf(sc[m] - mx) : 0.0f;
      sc[m] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.0f / sum;
#pragma unroll
    for (int m = 0; m < (TP + 31) / 32; ++m) {
      const int j = lane + 32 * m;
      if (j < TP) pw[j] = sc[m] * inv;
    }
    __syncwarp();
    float o0 = 0.0f, o1 = 0.0f;
    for (int j = 0; j < jmax; ++j) {
      const float pj = pw[j];
      o0 = fmaf(pj, s.v[j * 64 + lane], o0);
      o1 = fmaf(pj, s.v[j * 64 + lane + 32], o1);
    }
    float* dst = attn + (static_cast<size_t>(b) * T + t) * D + h * kHeadDim;
    dst[lane] = o0;
    dst[lane + 32] = o1;
    __syncwarp();
  }
}

// out[M, N] = res[M, N] + a[M, K] @ w[N, K]^T + bias[N]; N % 64 == 0, K % 16 == 0.
constexpr int kBM = 64, kBN = 64, kLK = 16;

__global__ void __launch_bounds__(kThreads) linear_residual_kernel(
    const float* __restrict__ a, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ res,
    float* __restrict__ out, int M, int N, int K) {
  __shared__ float as[kLK][kBM + 4];
  __shared__ float bs[kLK][kBN + 4];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kLK) {
    for (int e = tid; e < kBM * kLK; e += kThreads) {
      const int r = e / kLK, kk = e % kLK;
      const int m = m0 + r;
      as[kk][r] = m < M ? a[static_cast<size_t>(m) * K + k0 + kk] : 0.0f;
      bs[kk][r] = w[static_cast<size_t>(n0 + r) * K + k0 + kk];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kLK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      const size_t o = static_cast<size_t>(m) * N + n;
      out[o] = res[o] + (acc[i][j] + bias[n]);
    }
  }
}

}  // namespace

extern "C" {

// x, attn, out: [B, T, D]; w_qkv: [3D, D]; b_qkv: [3D]; w_out: [D, D];
// b_out, ln_g, ln_b: [D]. D == heads * 64, T <= 80, D % 64 == 0.
int attn_block_launch(const float* x, const float* ln_g, const float* ln_b,
                      const float* w_qkv, const float* b_qkv,
                      const float* w_out, const float* b_out, float* attn,
                      float* out, int B, int T, int D, int heads, int causal,
                      float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != heads * kHeadDim || D % kBN != 0 || T < 1 || T > TP)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = head_smem_floats(T) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      attn_heads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_heads_kernel<<<dim3(B, heads), kThreads, smem, st>>>(
      x, ln_g, ln_b, w_qkv, b_qkv, attn, T, D, causal, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = B * T;
  dim3 grid((M + kBM - 1) / kBM, D / kBN);
  linear_residual_kernel<<<grid, kThreads, 0, st>>>(attn, w_out, b_out, x, out, M, D, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
