// K5: the MLP half of a pre-LN CLIP resblock at widths whose weights are
// streamed,
//   out = x + QuickGELU(LN2(x) @ fc_w^T + fc_b) @ proj_w^T + proj_b,
// QuickGELU(h) = h * sigmoid(1.702 h), fp32 LayerNorm statistics (eps given),
// in float32, both products on the tensor cores in 3xTF32 (about 20 bits,
// within the full-fp32 tolerance of the card check). fc_w is [4D, D] and
// proj_w [D, 4D] ([out, in]).
//
// Replaces: clip_ppo_tpu/models/clip/pallas_block.py::_mlp_stream_kernel
// (entry fused_mlp_block, taken where 2 * D * 4D * itemsize > 12 MiB: the
// ViT-B/32 vision tower in fp32, D = 768, and ViT-L/14's D = 1024 and 768).
//
// Bound on Hopper: operations. The two products are 2 * 2 * B*T * D * 4D
// flops: at ViT-L/14's [256, 257, 1024] 1.104 TFLOP, 16.5 ms of fp32 FMA at
// the CUDA cores' 67 TFLOP/s and 6.7 ms as three TF32 passes at the tensor
// cores' 495 TFLOP/s; at ViT-B/32's [1024, 50, 768] 483 GFLOP, 7.2 and 2.9
// ms; against 2 x 269 MB of x read and out written plus 33.6 MB of weights
// (0.17 ms at 3.35 TB/s) at ViT-L/14.
//
// Design: mlp_half.cuh's launches with one chunk: ln_stats, the fc GEMM
// with LN2 on load and QuickGELU in the epilogue, h[B*T, 4D] =
// QuickGELU(LN2(x) @ fc_w^T + fc_b), then the proj GEMM with the residual,
// out = x + (h @ proj_w^T + proj_b). LN2(x) never reaches device memory.
// The hidden h round-trips device memory. The TPU kernel keeps it in VMEM,
// and the first CUDA K5 kept it on the SM: one block owned 32 rows for the
// whole launch, with their [32, D] output sum in registers, and streamed all
// of fc_w and proj_w through shared memory. The register file capped that
// block at 32 rows (64 would have filled it at D = 1024), so at ViT-L/14
// 2,056 blocks each read the 33.5 MB of weights: 69 GB through L2 a launch,
// on the CUDA cores. Here each GEMM's block tile is 128 x 128 with the
// weights read by a column walk that keeps them in L2, and h costs one write
// and one read: 2 x 1.08 GB = 2.16 GB at ViT-L/14 batch 256, 0.64 ms at 3.35
// TB/s, against the 6.7 ms bound of the products; 2 x 0.63 GB = 1.26 GB at
// [1024, 50, 768], 0.38 ms against 2.9 ms. The wrapper allocates h
// (1.08 GB at ViT-L/14 batch 256) and the statistics (8 bytes a row).
//
// Widths: D and 4D multiples of 32 (the GEMM's reduction slice); the
// towers' 768 and 1024 and their 3,072 and 4,096.
//
// bf16 (mlp_stream_bf16_launch): the encoder benchmark's default dtype runs
// ViT-L/14's vision tower in bfloat16, where 2 * 1024 * 4096 * 2 bytes = 16
// MiB of MLP weights still exceed the TPU kernel's budget, so its MLP halves
// come here. mlp_half.cuh's launches in bf16 with one chunk, as K3's bf16
// entry point runs them (gemm_bf16.cuh, wgmma m64n128k16, one bf16 pass a
// product): the proj GEMM sums all 4D hidden units in fp32 accumulators and
// rounds once, which is what _mlp_stream_kernel's fp32 acc_scratch over its
// streamed chunks computes (pallas_block.py:410, 442-450). Bound: the 1.104
// TFLOP at [256, 257, 1024] take 1.116 ms at the dense bf16 peak, 989
// TFLOP/s, against 2 x 135 MB of x and out and 16.8 MB of weights, 0.085 ms
// at 3.35 TB/s. Widths: D and 4D multiples of 64; scratch: the [B*T, 4D]
// bf16 hidden, 539 MB there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_half.cuh"

extern "C" {

// x, out: [M, D]; w_fc: [D4, D]; b_fc: [D4]; w_proj: [D, D4]; b_proj, ln_g,
// ln_b: [D]; stats: [M, 2] and h: [M, D4] scratch. D and D4 multiples of
// 32; every pointer 16-byte aligned.
int mlp_stream_launch(const float* x, const float* ln_g, const float* ln_b,
                      const float* w_fc, const float* b_fc, const float* w_proj,
                      const float* b_proj, float* stats, float* h, float* out, int M, int D,
                      int D4, float eps, void* stream) {
  return mlp_half::launch(x, ln_g, ln_b, w_fc, b_fc, w_proj, b_proj, stats, h, out, M, D, D4, 1,
                          eps, static_cast<cudaStream_t>(stream));
}

// As mlp_stream_launch, every tensor but stats bfloat16; stats fp32; D and
// D4 multiples of 64.
int mlp_stream_bf16_launch(const __nv_bfloat16* x, const __nv_bfloat16* ln_g,
                           const __nv_bfloat16* ln_b, const __nv_bfloat16* w_fc,
                           const __nv_bfloat16* b_fc, const __nv_bfloat16* w_proj,
                           const __nv_bfloat16* b_proj, float* stats, __nv_bfloat16* h,
                           __nv_bfloat16* out, int M, int D, int D4, float eps, void* stream) {
  return mlp_half::launch(x, ln_g, ln_b, w_fc, b_fc, w_proj, b_proj, stats, h, out, M, D, D4, 1,
                          eps, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
