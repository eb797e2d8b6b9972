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
// Design: the four launches of attn_half.cuh, shared with K6 (attn_stream.cu):
// LN statistics, the qkv GEMM with LN1 applied on load (gemm_tf32x3.cuh),
// K4's attention body (attention_tile.cuh), the out-projection GEMM with
// the residual. LN1(x) never reaches device memory.
//
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

#include "attn_half.cuh"

extern "C" {

// x, attn, out: [B, T, D]; qkv: [B, T, 3D] scratch; stats: [B*T, 2] scratch;
// w_qkv: [3D, D]; b_qkv: [3D]; w_out: [D, D]; b_out, ln_g, ln_b: [D].
// D == heads * 64; every pointer 16-byte aligned.
int attn_block_launch(const float* x, const float* ln_g, const float* ln_b,
                      const float* w_qkv, const float* b_qkv, const float* w_out,
                      const float* b_out, float* stats, float* qkv, float* attn, float* out,
                      int B, int T, int D, int heads, int causal, float eps, void* stream) {
  return attn_half::launch(x, ln_g, ln_b, w_qkv, b_qkv, w_out, b_out, stats, qkv, attn, out, B,
                           T, D, heads, causal, eps, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
