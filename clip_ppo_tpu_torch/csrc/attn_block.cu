// K2: the attention half of a pre-LN CLIP resblock,
//   out = x + out_proj(MHA(qkv_proj(LN1(x)))),
// with fp32 LayerNorm statistics and an optional causal mask, in float32,
// every product on the tensor cores in 3xTF32 (about 20 bits, within the
// full-fp32 tolerance of the card check).
//
// Replaces: clip_ppo_tpu/models/clip/pallas_block.py::_attn_block_kernel
// (entry fused_attn_block): the text tower's [1024, 77, 512] causal blocks
// that build the description table, ViT-B/32's vision tower [1024, 50, 768]
// and ViT-L/14's text tower [1024, 77, 768] causal.
//
// Bound on Hopper: operations. The qkv and output projections are
// 2 * B*T * D * 4D flops and the scores and weighted values 2 * 2 * B * T^2
// * D (the causal triangle where masked): at [1024, 77, 768] causal 381.5
// GFLOP, 5.69 ms of fp32 FMA at the CUDA cores' 67 TFLOP/s, 2.31 ms as three
// TF32 passes at the tensor cores' 495 TFLOP/s; at [1024, 50, 768] 249.5
// GFLOP, 3.72 and 1.51 ms; against 2 x 242 MB of x read and out written
// plus 9.4 MB of weights, 0.15 ms at 3.35 TB/s.
//
// Design: four launches, K6's sequence (attn_stream.cu) on the shared
// tensor-core GEMM (gemm_tf32x3.cuh):
//   1. ln_stats (ln_stats.cuh): the mean and 1/std of every row of x.
//   2. GEMM with LN1 on load: qkv[B*T, 3D] = LN1(x) @ in_proj_w^T + in_proj_b.
//      LN1(x) never reaches device memory.
//   3. attention_tile::launch (attention_tile.cuh, K4's body) on the packed
//      qkv, causal or not: attn[B*T, D].
//   4. GEMM with the residual: out = x + (attn @ out_proj_w^T + out_proj_b).
// The TPU kernel keeps a batch block's qkv in VMEM. The first CUDA K2 kept
// one (batch, head)'s [T, 192] qkv in shared memory, which capped T at 80
// and left the qkv product with M <= 80 rows a block, recomputing LN1 of
// the element for every head, all on the CUDA cores. Here the qkv and the
// attention output are device scratch, allocated by the wrapper: 4 B*T*D
// floats, 0.97 GB at [1024, 77, 768] (qkv 727 MB, attn 242 MB), 0.63 GB at
// [1024, 50, 768], plus 8 bytes a row of statistics. Writing and reading
// them once moves 1.94 GB at [1024, 77, 768], 0.58 ms at 3.35 TB/s, against
// the 2.31 ms bound of the products: the price of products whose M is the
// whole B*T. T is not bounded.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "gemm_tf32x3.cuh"
#include "ln_stats.cuh"

extern "C" {

// x, attn, out: [B, T, D]; qkv: [B, T, 3D] scratch; stats: [B*T, 2] scratch;
// w_qkv: [3D, D]; b_qkv: [3D]; w_out: [D, D]; b_out, ln_g, ln_b: [D].
// D == heads * 64; every pointer 16-byte aligned.
int attn_block_launch(const float* x, const float* ln_g, const float* ln_b,
                      const float* w_qkv, const float* b_qkv, const float* w_out,
                      const float* b_out, float* stats, float* qkv, float* attn, float* out,
                      int B, int T, int D, int heads, int causal, float eps, void* stream) {
  const long long M = static_cast<long long>(B) * T;
  if (B < 1 || T < 1 || heads < 1 || D != heads * attention_tile::kHeadDim || M > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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

}  // extern "C"
