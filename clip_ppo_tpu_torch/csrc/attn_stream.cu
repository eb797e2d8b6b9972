// K6: the attention half of a pre-LN CLIP resblock at widths whose weights
// are streamed,
//   out = x + out_proj(MHA(qkv_proj(LN1(x)))),
// with fp32 LayerNorm statistics and an optional causal mask, in float32,
// every product on the tensor cores in 3xTF32: the same function as K2
// (csrc/attn_block.cu), on the same four launches (attn_half.cuh).
//
// Replaces: clip_ppo_tpu/models/clip/pallas_block.py::_attn_stream_kernel
// (entry fused_attn_block_stream, taken under CLIP_PPO_ATTN_STREAM=1 by the
// resblocks whose MLP weights exceed the 12 MiB budget in bf16: ViT-L/14's
// vision tower, D = 1024, 16 heads, T = 257).
//
// Bound on Hopper: operations. At [256, 257, 1024] the qkv and output
// projections are 2 * B*T * D * 4D = 552 GFLOP and the scores and weighted
// values 2 * 2 * B * T^2 * D = 69 GFLOP: 3.77 ms as three TF32 passes at the
// tensor cores' 495 TFLOP/s (9.27 ms of fp32 FMA at the CUDA cores' 67
// TFLOP/s), against 2 x 269 MB of x read and out written and 16.8 MB of
// weights, 0.17 ms at 3.35 TB/s.
//
// Where the TPU kernel's memory plan went. The TPU kernel forms LN1 of a
// batch block once, streams the qkv weights from HBM in double-buffered
// [D, ck] column tiles, keeps the block's qkv in VMEM scratch, runs the
// attention there and applies the resident output projection, so the LN,
// qkv and attention intermediates never reach HBM. On the card one batch
// element's qkv alone is 257 x 3072 x 4 B = 3.2 MB, against at most 227 KB
// of shared memory a block, so the qkv and the attention output are device
// scratch between launches, allocated by the wrapper: 4 B*T*D floats, 1.08 GB
// at [256, 257, 1024] (qkv 808 MB, attn 269 MB), plus 8 bytes a row of
// statistics. Writing and reading them once moves 2.16 GB, 0.64 ms at 3.35
// TB/s against the 3.77 ms bound of the products. LN1(x) never reaches
// device memory: the qkv GEMM applies it as x arrives in shared memory. The
// weights are not streamed by hand: the GEMM's column walk keeps each row
// block's weights (12.6 MB of w_qkv) in the 50 MB L2.

#include <cuda_runtime.h>

#include "attn_half.cuh"

extern "C" {

// x, attn, out: [B, T, D]; qkv: [B, T, 3D] scratch; stats: [B*T, 2] scratch;
// w_qkv: [3D, D]; b_qkv: [3D]; w_out: [D, D]; b_out, ln_g, ln_b: [D].
// D == heads * 64; every pointer 16-byte aligned.
int attn_stream_launch(const float* x, const float* ln_g, const float* ln_b,
                       const float* w_qkv, const float* b_qkv, const float* w_out,
                       const float* b_out, float* stats, float* qkv, float* attn, float* out,
                       int B, int T, int D, int heads, int causal, float eps, void* stream) {
  return attn_half::launch(x, ln_g, ln_b, w_qkv, b_qkv, w_out, b_out, stats, qkv, attn, out, B,
                           T, D, heads, causal, eps, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
