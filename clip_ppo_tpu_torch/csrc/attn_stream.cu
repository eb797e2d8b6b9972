// K6: the attention half of a pre-LN CLIP resblock at widths whose weights
// are streamed,
//   out = x + out_proj(MHA(qkv_proj(LN1(x)))),
// with fp32 LayerNorm statistics and an optional causal mask, in float32: the
// same function as K2 (csrc/attn_block.cu), at widths and lengths K2's
// 80-row tile cannot take (ViT-L/14's vision tower: D = 1024, 16 heads,
// T = 257).
//
// Replaces: clip_ppo_tpu/models/clip/pallas_block.py::_attn_stream_kernel
// (entry fused_attn_block_stream, taken under CLIP_PPO_ATTN_STREAM=1 by the
// resblocks whose MLP weights exceed the 12 MiB budget in bf16).
//
// Bound on Hopper: operations. At [256, 257, 1024] the qkv and output
// projections are 2 * B*T * D * 4D = 552 GFLOP and the scores and weighted
// values 2 * 2 * B * T^2 * D = 69 GFLOP, against 2 x 269 MB of activations and
// 16.8 MB of weights: 9.3 ms of fp32 FMA at 67 TFLOP/s, 0.17 ms of bytes.
//
// The TPU kernel forms LN1 of a batch block once, streams the qkv weights
// from HBM in double-buffered [D, ck] column tiles, keeps the block's qkv in
// VMEM scratch, runs the attention there and applies the resident output
// projection, so the LN, qkv and attention intermediates never reach HBM. On
// Hopper one batch element's qkv alone is 257 x 3072 x 4 B = 3.2 MB, against
// at most 227 KB of shared memory a block, so this kernel keeps its qkv and
// its attention output in device memory between launches:
//   1. ln_stats_kernel (ln_stats.cuh): the mean and 1/std of every row.
//   2. gemm_kernel<LN>: qkv[B*T, 3D] = LN1(x) @ w_qkv^T + b_qkv. The
//      normalisation and the affine are applied as the x tiles are loaded,
//      so LN1(x) never reaches device memory.
//   3. attention_kernel (attention_tile.cuh, K4's body): the heads' softmax
//      attention from the packed qkv, keys in tiles of 64 with an online
//      softmax, into attn[B*T, D].
//   4. gemm_kernel<residual>: out = x + (attn @ w_out^T + b_out).
// The products are the kernel's own: a 128 x 128 output tile a block, 256
// threads each owning 8 x 8 outputs, the reduction in slices of 8 staged
// through two shared-memory buffers, so the weight tiles ([128 x 8] of w_qkv
// or w_out) stream through shared memory while the previous slice's 64 FMAs a
// thread run. Consecutive blocks share one row block of x and walk the
// columns, so a row block is read from device memory once and the weights
// (12.6 MB of w_qkv) stay in the 50 MB L2. Plain fp32 FMA loops on the CUDA
// cores: right first; wgmma (TF32 or bf16) would change the numerics and is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "ln_stats.cuh"

namespace {

constexpr int kBM = 128;  // rows of an output tile
constexpr int kBN = 128;  // columns of an output tile
constexpr int kBK = 8;    // reduction slice
constexpr int kGemmThreads = 256;
constexpr int kTileStride = kBM + 4;  // shared row stride: 16-byte aligned, no bank conflicts

// C[M, N] = A'[M, K] @ W[N, K]^T + bias[N], plus R[M, N] when kResidual;
// A' = LN(A) from the row statistics and the affine when kLN. N a multiple of
// 128, K a multiple of 8, every pointer 16-byte aligned.
template <bool kLN, bool kResidual>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(
    const float* __restrict__ A, const float2* __restrict__ stats,
    const float* __restrict__ ln_g, const float* __restrict__ ln_b,
    const float* __restrict__ W, const float* __restrict__ bias,
    const float* __restrict__ R, float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[2][kBK][kTileStride];
  __shared__ __align__(16) float Ws[2][kBK][kTileStride];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  // Loads: thread tid copies row tid / 2, reduction offsets 4 (tid % 2) .. +3,
  // of both the x tile and the weight tile.
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const int am = m0 + lr;
  const bool a_ok = am < M;
  const float* a_row = A + static_cast<size_t>(a_ok ? am : 0) * K + lk;
  const float* w_row = W + static_cast<size_t>(n0 + lr) * K + lk;
  float2 st = make_float2(0.0f, 1.0f);
  if (kLN && a_ok) st = stats[am];

  auto load_a = [&](int k0) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (a_ok) {
      v = *reinterpret_cast<const float4*>(a_row + k0);
      if (kLN) {
        const float4 g = *reinterpret_cast<const float4*>(ln_g + k0 + lk);
        const float4 b = *reinterpret_cast<const float4*>(ln_b + k0 + lk);
        v.x = (v.x - st.x) * st.y * g.x + b.x;
        v.y = (v.y - st.x) * st.y * g.y + b.y;
        v.z = (v.z - st.x) * st.y * g.z + b.z;
        v.w = (v.w - st.x) * st.y * g.w + b.w;
      }
    }
    return v;
  };
  auto store = [&](float (*S)[kTileStride], float4 v) {
    S[lk + 0][lr] = v.x;
    S[lk + 1][lr] = v.y;
    S[lk + 2][lr] = v.z;
    S[lk + 3][lr] = v.w;
  };

  // Compute: thread (ty, tx) owns rows 4 ty + {0..3} and 64 + 4 ty + {0..3},
  // columns 4 tx + {0..3} and 64 + 4 tx + {0..3} of the tile.
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 ra = load_a(0);
  float4 rw = *reinterpret_cast<const float4*>(w_row);
  store(As[0], ra);
  store(Ws[0], rw);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) {  // the next slice's loads run behind this slice's products
      ra = load_a(k0 + kBK);
      rw = *reinterpret_cast<const float4*>(w_row + k0 + kBK);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[buf][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ws[buf][kk][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {  // the other buffer was last read before the previous barrier
      store(As[buf ^ 1], ra);
      store(Ws[buf ^ 1], rw);
    }
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + 4 * tx;
      const size_t o = static_cast<size_t>(m) * N + n;
      const float4 bv = *reinterpret_cast<const float4*>(bias + n);
      float4 v = make_float4(acc[i][4 * h] + bv.x, acc[i][4 * h + 1] + bv.y,
                             acc[i][4 * h + 2] + bv.z, acc[i][4 * h + 3] + bv.w);
      if (kResidual) {
        const float4 r = *reinterpret_cast<const float4*>(R + o);
        v = make_float4(r.x + v.x, r.y + v.y, r.z + v.z, r.w + v.w);
      }
      *reinterpret_cast<float4*>(C + o) = v;
    }
  }
}

template <bool kLN, bool kResidual>
int gemm(const float* A, const float2* stats, const float* ln_g, const float* ln_b,
         const float* W, const float* bias, const float* R, float* C, int M, int N, int K,
         cudaStream_t st) {
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<kLN, kResidual><<<grid, kGemmThreads, 0, st>>>(A, stats, ln_g, ln_b, W, bias,
                                                             R, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, attn, out: [B, T, D]; qkv: [B, T, 3D] scratch; stats: [B*T, 2] scratch;
// w_qkv: [3D, D]; b_qkv: [3D]; w_out: [D, D]; b_out, ln_g, ln_b: [D].
// D == heads * 64 and a multiple of 128; every pointer 16-byte aligned.
int attn_stream_launch(const float* x, const float* ln_g, const float* ln_b,
                       const float* w_qkv, const float* b_qkv, const float* w_out,
                       const float* b_out, float* stats, float* qkv, float* attn, float* out,
                       int B, int T, int D, int heads, int causal, float eps, void* stream) {
  const long long M = static_cast<long long>(B) * T;
  if (B < 1 || T < 1 || heads < 1 || D != heads * attention_tile::kHeadDim || D % kBN != 0 ||
      (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(M);
  float2* st2 = reinterpret_cast<float2*>(stats);

  int err = ln_stats::launch(x, st2, m, D, eps, st);
  if (err != cudaSuccess) return err;
  err = gemm<true, false>(x, st2, ln_g, ln_b, w_qkv, b_qkv, nullptr, qkv, m, 3 * D, D, st);
  if (err != cudaSuccess) return err;

  attention_tile::Args<float> a;
  a.q = qkv;
  a.k = qkv + D;
  a.v = qkv + 2 * D;
  a.o = attn;
  a.qb = a.kb = a.vb = static_cast<long long>(T) * 3 * D;
  a.qt = a.kt = a.vt = 3 * D;
  a.qh = a.kh = a.vh = attention_tile::kHeadDim;
  a.ob = static_cast<long long>(T) * D;
  a.ot = D;
  a.oh = attention_tile::kHeadDim;
  a.T = T;
  a.H = heads;
  a.q_tiles = (T + attention_tile::kRows - 1) / attention_tile::kRows;
  a.causal = causal != 0;
  err = attention_tile::launch(a, B, st);
  if (err != cudaSuccess) return err;

  return gemm<false, true>(attn, nullptr, nullptr, nullptr, w_out, b_out, x, out, m, D, D, st);
}

}  // extern "C"
