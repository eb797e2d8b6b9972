// The attention half of a pre-LN CLIP resblock,
//   out = x + out_proj(MHA(qkv_proj(LN1(x)))),
// as four launches on one stream, shared by K2 (attn_block.cu) and K6
// (attn_stream.cu), which compute the same function for two TPU kernels and
// keep an entry point each:
//   1. ln_stats (ln_stats.cuh): the mean and 1/std of every row of x.
//   2. GEMM with LN1 on load (gemm_tf32x3.cuh):
//      qkv[B*T, 3D] = LN1(x) @ w_qkv^T + b_qkv. LN1(x) never reaches device
//      memory.
//   3. attention_tile::launch (attention_tile.cuh, K4's body) on the packed
//      qkv, causal or not: attn[B*T, D].
//   4. GEMM with the residual: out = x + (attn @ w_out^T + b_out).
// Every product runs on the tensor cores in 3xTF32. The qkv and the
// attention output are device scratch allocated by the caller: 4 B*T*D
// floats, plus 8 bytes a row of statistics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "gemm_tf32x3.cuh"
#include "ln_stats.cuh"

namespace attn_half {

// x, attn, out: [B, T, D]; qkv: [B, T, 3D] scratch; stats: [B*T, 2] scratch;
// w_qkv: [3D, D]; b_qkv: [3D]; w_out: [D, D]; b_out, ln_g, ln_b: [D].
// D == heads * 64, B*T fits an int; every pointer 16-byte aligned. Returns a
// cudaError_t.
inline int launch(const float* x, const float* ln_g, const float* ln_b, const float* w_qkv,
                  const float* b_qkv, const float* w_out, const float* b_out, float* stats,
                  float* qkv, float* attn, float* out, int B, int T, int D, int heads,
                  int causal, float eps, cudaStream_t st) {
  const long long M = static_cast<long long>(B) * T;
  if (B < 1 || T < 1 || heads < 1 || D != heads * attention_tile::kHeadDim || M > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = static_cast<int>(M);
  float2* st2 = reinterpret_cast<float2*>(stats);

  int err = ln_stats::launch(x, st2, m, D, eps, st);
  if (err != cudaSuccess) return err;

  gemm_tf32x3::Params g{x, st2, ln_g, ln_b, w_qkv, b_qkv, nullptr, qkv, m, 3 * D, D};
  err = gemm_tf32x3::launch<true, gemm_tf32x3::kBias>(g, st);
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
  a.causal = causal != 0;
  err = attention_tile::launch(a, B, st);
  if (err != cudaSuccess) return err;

  g = gemm_tf32x3::Params{attn, nullptr, nullptr, nullptr, w_out, b_out, x, out, m, D, D};
  return gemm_tf32x3::launch<false, gemm_tf32x3::kBiasResidual>(g, st);
}

}  // namespace attn_half
