// K3: the MLP half of a pre-LN CLIP resblock at widths whose weights fit the
// TPU kernel's budget,
//   out = x + QuickGELU(LN2(x) @ fc_w^T + fc_b) @ proj_w^T + proj_b,
// QuickGELU(h) = h * sigmoid(1.702 h), fp32 LayerNorm statistics (eps given),
// in float32, both products on the tensor cores in 3xTF32 (about 20 bits,
// within the full-fp32 tolerance of the card check). fc_w is [4D, D] and
// proj_w [D, 4D] ([out, in]).
//
// Replaces: clip_ppo_tpu/models/clip/pallas_block.py::_mlp_block_kernel
// (entry fused_mlp_block, taken where 2 * D * 4D * itemsize <= 12 MiB: in
// fp32 the ViT-B/32 text tower's D = 512, which builds the MiniGrid
// description table at startup).
//
// Bound on Hopper: operations. At [1024, 77, 512] the two products are
// 2 * 2 * B*T * D * 4D = 330.7 GFLOP: 2.00 ms as three TF32 passes at the
// tensor cores' 495 TFLOP/s (4.94 ms of fp32 FMA at the CUDA cores' 67
// TFLOP/s), against 2 x 161.5 MB of x read and out written plus 8.4 MB of
// weights, 0.10 ms at 3.35 TB/s.
//
// Design: K5's three launches (mlp_half.cuh, one chunk): ln_stats, the fc
// GEMM with LN2 on load and QuickGELU in the epilogue into a [B*T, 4D]
// hidden scratch, the proj GEMM with bias and residual. The TPU kernel keeps
// the hidden in VMEM; here a block tile of LN2(x) alone, 128 rows of D =
// 512 floats, is 256 KB, past the 227 KB a block may use, and the round trip
// is cheap beside the products: 2 x 646 MB = 1.29 GB at [1024, 77, 512],
// 0.39 ms at 3.35 TB/s against the 2.0 ms bound. The first CUDA K3 did keep
// it on chip, one block per 32 rows streaming all 8 MB of weights through
// shared memory on the CUDA cores (~20 GB through L2 a launch). The wrapper
// allocates the hidden (646 MB at the table's shape) and the statistics
// (8 bytes a row).
//
// Widths: D and 4D multiples of 32 (the GEMM's reduction slice); any B*T
// that fits an int.

// bf16 (mlp_block_bf16_launch): in bfloat16 both weight matrices of
// ViT-B/32's vision tower, 2 * 768 * 3,072 * 2 bytes = 9.4 MB, fit the TPU
// kernel's budget, so the FROZEN_CLIP trunk and benchmark_clip's default
// dtype run their D = 768 MLP halves here. The same three launches in bf16
// (mlp_half.cuh): both products one bf16 pass on the tensor cores (wgmma
// m64n128k16, gemm_bf16.cuh), fp32 accumulators and LN statistics. Bound:
// 2 * 2 * B*T * D * 4D flops at the dense bf16 peak, 989 TFLOP/s: at the
// FROZEN_CLIP update's [256, 50, 768], 121 GFLOP, 0.122 ms, against 2 x
// 19.7 MB of x and out plus 9.4 MB of weights, 0.015 ms at 3.35 TB/s; at
// the rollout's [8, 50, 768], 3.8 GFLOP, 0.004 ms, and 9.4 MB of weights,
// 0.003 ms, below the cost of its launches. Widths: D and 4D multiples of
// 64 (the bf16 reduction slice); scratch: the [B*T, 4D] bf16 hidden.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_half.cuh"

extern "C" {

// x, out: [M, D]; w_fc: [D4, D]; b_fc: [D4]; w_proj: [D, D4]; b_proj, ln_g,
// ln_b: [D]; stats: [M, 2] and h: [M, D4] scratch. D and D4 multiples of
// 32; every pointer 16-byte aligned.
int mlp_block_launch(const float* x, const float* ln_g, const float* ln_b,
                     const float* w_fc, const float* b_fc, const float* w_proj,
                     const float* b_proj, float* stats, float* h, float* out, int M, int D,
                     int D4, float eps, void* stream) {
  return mlp_half::launch(x, ln_g, ln_b, w_fc, b_fc, w_proj, b_proj, stats, h, out, M, D, D4, 1,
                          eps, static_cast<cudaStream_t>(stream));
}

// As mlp_block_launch, every tensor but stats bfloat16; stats fp32; D and D4
// multiples of 64.
int mlp_block_bf16_launch(const __nv_bfloat16* x, const __nv_bfloat16* ln_g,
                          const __nv_bfloat16* ln_b, const __nv_bfloat16* w_fc,
                          const __nv_bfloat16* b_fc, const __nv_bfloat16* w_proj,
                          const __nv_bfloat16* b_proj, float* stats, __nv_bfloat16* h,
                          __nv_bfloat16* out, int M, int D, int D4, float eps, void* stream) {
  return mlp_half::launch(x, ln_g, ln_b, w_fc, b_fc, w_proj, b_proj, stats, h, out, M, D, D4, 1,
                          eps, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
