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
// In float32 every product runs on the tensor cores in 3xTF32
// (gemm_tf32x3.cuh, attention_kernel). In bfloat16 (K2's bf16 entry point)
// the same four launches run ln_stats on bf16 rows, the bf16 GEMM (gemm_bf16.cuh) and
// attention_bf16_kernel, one bf16 pass a product, rounding where the TPU
// kernel rounds: LN1(x), the qkv, P and the attention output to bf16, the
// out-projection to bf16 before the residual add. The qkv and the attention
// output are device scratch allocated by the caller: 4 B*T*D elements of
// x's type, plus 8 bytes a row of fp32 statistics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"
#include "gemm_bf16.cuh"
#include "gemm_tf32x3.cuh"
#include "ln_stats.cuh"

namespace attn_half {

// x, attn, out: [B, T, D]; qkv: [B, T, 3D] scratch; stats: [B*T, 2] fp32
// scratch; w_qkv: [3D, D]; b_qkv: [3D]; w_out: [D, D]; b_out, ln_g, ln_b:
// [D]; Elem is float or __nv_bfloat16, every tensor but stats of that type.
// D == heads * 64, B*T fits an int; every pointer 16-byte aligned. Returns a
// cudaError_t.
template <typename Elem>
int launch(const Elem* x, const Elem* ln_g, const Elem* ln_b, const Elem* w_qkv,
           const Elem* b_qkv, const Elem* w_out, const Elem* b_out, float* stats, Elem* qkv,
           Elem* attn, Elem* out, int B, int T_len, int D, int heads, int causal, float eps,
           cudaStream_t st) {
  constexpr bool kF32 = std::is_same<Elem, float>::value;
  static_assert(kF32 || std::is_same<Elem, __nv_bfloat16>::value, "float or bfloat16");
  const long long M = static_cast<long long>(B) * T_len;
  if (B < 1 || T_len < 1 || heads < 1 || D != heads * attention_tile::kHeadDim ||
      M > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = static_cast<int>(M);
  float2* st2 = reinterpret_cast<float2*>(stats);

  int err = ln_stats::launch(x, st2, m, D, eps, st);
  if (err != cudaSuccess) return err;

  if constexpr (kF32) {
    gemm_tf32x3::Params g{x, st2, ln_g, ln_b, w_qkv, b_qkv, nullptr, qkv, m, 3 * D, D};
    err = gemm_tf32x3::launch<true, gemm_tf32x3::kBias>(g, st);
  } else {
    gemm_bf16::Params g{x, st2, ln_g, ln_b, w_qkv, b_qkv, nullptr, qkv, m, 3 * D, D};
    err = gemm_bf16::launch<true, gemm_bf16::kBias>(g, st);
  }
  if (err != cudaSuccess) return err;

  attention_tile::Args<Elem> a;
  a.q = qkv;
  a.k = qkv + D;
  a.v = qkv + 2 * D;
  a.o = attn;
  a.qb = a.kb = a.vb = static_cast<long long>(T_len) * 3 * D;
  a.qt = a.kt = a.vt = 3 * D;
  a.qh = a.kh = a.vh = attention_tile::kHeadDim;
  a.ob = static_cast<long long>(T_len) * D;
  a.ot = D;
  a.oh = attention_tile::kHeadDim;
  a.T = T_len;
  a.H = heads;
  a.causal = causal != 0;
  err = attention_tile::launch(a, B, st);
  if (err != cudaSuccess) return err;

  if constexpr (kF32) {
    const gemm_tf32x3::Params g{attn, nullptr, nullptr, nullptr, w_out, b_out, x, out, m, D, D};
    return gemm_tf32x3::launch<false, gemm_tf32x3::kBiasResidual>(g, st);
  } else {
    const gemm_bf16::Params g{attn, nullptr, nullptr, nullptr, w_out, b_out, x, out, m, D, D};
    return gemm_bf16::launch<false, gemm_bf16::kBiasResidual>(g, st);
  }
}

}  // namespace attn_half
