// K7: the MLP half of a pre-LN CLIP resblock as a sum over chunks of the
// hidden dimension,
//   out = x + sum_c QuickGELU(LN2(x) @ fc_w[units of c, :]^T + fc_b[c])
//                   @ proj_w[:, units of c]^T + proj_b,
// QuickGELU(h) = h * sigmoid(1.702 h), fp32 LayerNorm statistics (eps given),
// in float32, every product on the tensor cores in 3xTF32 (about 20 bits,
// within the full-fp32 tolerance of the card check). fc_w is [4D, D] and
// proj_w [D, 4D] ([out, in]).
//
// Replaces: clip_ppo_tpu/models/clip/pallas_block.py::_mlp_block_chunked_kernel
// (entry fused_mlp_block under CLIP_PPO_MLP_CHUNKED=1, taken where
// 2 * D * 4D * itemsize > 12 MiB: ViT-L/14's vision tower, D = 1024, and its
// text tower, D = 768, in fp32).
//
// Bound on Hopper: operations. The products are 2 * 2 * B*T * D * 4D flops:
// at [256, 257, 1024] 1.104 TFLOP, 6.69 ms as three TF32 passes at the
// tensor cores' 495 TFLOP/s (16.5 ms of fp32 FMA at the CUDA cores' 67
// TFLOP/s); at [1024, 77, 768] 744 GFLOP, 4.51 ms (11.1); against 2 x 269 MB
// of x read and out written and 33.6 MB of weights, 0.17 ms at 3.35 TB/s, at
// the first.
//
// The TPU kernel's grid is (batch blocks, chunks of 4D) with the chunk axis
// innermost and sequential: each step holds one [D, ck] slice of fc and the
// matching [ck, D] slice of proj in VMEM and adds its product into an fp32
// accumulator in scratch, which the last step writes out with the bias and
// the residual. There the chunks bound what must be resident at once. Here
// they bound the scratch: K5 (csrc/mlp_stream.cu) computes the same
// function with the whole [B*T, 4D] hidden in device memory between its two
// GEMMs; K7 holds one chunk's [B*T, 4D / chunks] at a time. The chunk axis
// becomes mlp_half.cuh's loop of launches on one stream, on the shared GEMM
// (gemm_tf32x3.cuh): per chunk, the fc GEMM with LN2 on load over the
// chunk's rows of fc_w, then the proj GEMM over the chunk's columns of
// proj_w (a reduction ck deep), chunk 0 with proj_b and the residual, each
// later chunk adding its product to out in place. Stream order is the TPU
// grid's sequential chunk axis, and fixes the order of out's sum.
//
// Chunk count: the wrapper passes 4 (ck = D: 1,024 hidden units at
// ViT-L/14's vision tower, 768 at its text tower), so the hidden scratch is
// B*T x D floats, the activations' size: 269 MB at [256, 257, 1024] against
// K5's 1.08 GB. The TPU's 16 come from its 2 MiB VMEM budget per weight
// slice, which has no counterpart. What the chunks cost over K5: x is read
// by each chunk's fc (3 more reads), out is read and written by each later
// chunk (3 more of each, ~1.6 GB at [256, 257, 1024], ~0.5 ms at 3.35 TB/s),
// and each proj tile's reduction is ck deep instead of 4D, so the ring's
// fill and the epilogue weigh more. More chunks would shrink the scratch
// further at more of those costs.
//
// Widths: D a multiple of 32 (the GEMM's reduction slice), 4D a multiple of
// 32 x chunks; any B*T that fits an int.
//
// bf16 (mlp_chunked_bf16_launch): the encoder benchmark's default dtype
// runs ViT-L/14's vision tower in bfloat16, and under CLIP_PPO_MLP_CHUNKED=1
// its MLP halves come here (its text tower's D = 768 fits the budget in bf16
// and takes K3). The TPU kernel sums the chunks' proj products in an fp32
// acc_scratch and rounds once, at its last chunk (pallas_block.py:160-167).
// So does this entry point: mlp_half.cuh's bf16 chunk loop on gemm_bf16.cuh,
// each chunk's proj GEMM but the last writing the fp32 sum so far into an
// [M, D] fp32 scratch the wrapper allocates (acc32), the last adding it
// before proj_b, one rounding to bf16 and the residual. Adding each chunk
// into the bf16 output in place, as the fp32 entry point adds into out,
// would round once a chunk. The scratch is one chunk's [M, 4D / chunks] bf16
// hidden, acc32 and the statistics: at [256, 257, 1024] with 4 chunks 135 +
// 269 MB, against K5's 539 MB of hidden. What the chunks cost over K5 in
// bf16: acc32 is written by chunks 0-2 and read by chunks 1-3, 1.6 GB at
// 3.35 TB/s, ~0.48 ms against the 1.116 ms bound of the products. Widths:
// D a multiple of 64, 4D of 64 x chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_half.cuh"

extern "C" {

// x, out: [M, D]; w_fc: [D4, D]; b_fc: [D4]; w_proj: [D, D4]; b_proj, ln_g,
// ln_b: [D]; stats: [M, 2] and h: [M, D4 / n_chunks] scratch. D a multiple of
// 32, D4 a multiple of 32 * n_chunks; every pointer 16-byte aligned.
int mlp_chunked_launch(const float* x, const float* ln_g, const float* ln_b,
                       const float* w_fc, const float* b_fc, const float* w_proj,
                       const float* b_proj, float* stats, float* h, float* out, int M, int D,
                       int D4, int n_chunks, float eps, void* stream) {
  return mlp_half::launch(x, ln_g, ln_b, w_fc, b_fc, w_proj, b_proj, stats, h, out, M, D, D4,
                          n_chunks, eps, static_cast<cudaStream_t>(stream));
}

// As mlp_chunked_launch, every tensor but stats and acc32 bfloat16; acc32:
// [M, D] fp32 scratch; D a multiple of 64, D4 of 64 * n_chunks.
int mlp_chunked_bf16_launch(const __nv_bfloat16* x, const __nv_bfloat16* ln_g,
                            const __nv_bfloat16* ln_b, const __nv_bfloat16* w_fc,
                            const __nv_bfloat16* b_fc, const __nv_bfloat16* w_proj,
                            const __nv_bfloat16* b_proj, float* stats, __nv_bfloat16* h,
                            float* acc32, __nv_bfloat16* out, int M, int D, int D4, int n_chunks,
                            float eps, void* stream) {
  return mlp_half::launch(x, ln_g, ln_b, w_fc, b_fc, w_proj, b_proj, stats, h, out, M, D, D4,
                          n_chunks, eps, static_cast<cudaStream_t>(stream), acc32);
}

}  // extern "C"
