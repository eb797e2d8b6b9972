// The MLP half of a pre-LN CLIP resblock,
//   out = x + QuickGELU(LN2(x) @ fc_w^T + fc_b) @ proj_w^T + proj_b,
// QuickGELU(h) = h * sigmoid(1.702 h), fp32 LayerNorm statistics (eps given),
// as launches on one stream on the shared tensor-core GEMM (gemm_tf32x3.cuh,
// every product in 3xTF32), shared by K3 (mlp_block.cu), K5 (mlp_stream.cu)
// and K7 (mlp_chunked.cu), which compute this function for three TPU kernels
// and keep an entry point each. fc_w is [4D, D] and proj_w [D, 4D] ([out,
// in]). The hidden dimension runs in n_chunks chunks of ck = 4D / n_chunks
// units, in order:
//   1. ln_stats (ln_stats.cuh): the mean and 1/std of every row of x.
//   2. For c = 0, 1, ...:
//      - h[B*T, ck] = QuickGELU(LN2(x) @ fc_w[c ck : (c + 1) ck, :]^T
//        + fc_b[c ck :]): the GEMM with LN2 on load, W the chunk's rows of
//        fc_w (contiguous). LN2(x) never reaches device memory.
//      - out (+)= h @ proj_w[:, c ck : (c + 1) ck]^T: W the chunk's columns
//        of proj_w, rows 4D floats apart. Chunk 0 adds proj_b and the
//        residual x and writes out; each later chunk adds its product to out
//        in place (the GEMM's kAccumulate epilogue).
// K3 and K5 run one chunk: three launches, the whole [B*T, 4D] hidden as
// scratch between the two GEMMs. K7 runs several, with one chunk's hidden
// at a time. Stream order makes chunk c + 1's fc overwrite h only after
// chunk c's proj has read it, and fixes out's sum in the order 0, 1, ...:
// the same result from run to run, with no atomics and no partial sums.
//
// Widths: D a multiple of 32 (the GEMM's reduction slice), 4D a multiple of
// 32 x n_chunks; any B*T that fits an int; every pointer 16-byte aligned.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tf32x3.cuh"
#include "ln_stats.cuh"

namespace mlp_half {

// x, out: [M, D]; w_fc: [D4, D]; b_fc: [D4]; w_proj: [D, D4]; b_proj, ln_g,
// ln_b: [D]; stats: [M, 2] and h: [M, D4 / n_chunks] scratch. Returns a
// cudaError_t.
inline int launch(const float* x, const float* ln_g, const float* ln_b, const float* w_fc,
                  const float* b_fc, const float* w_proj, const float* b_proj, float* stats,
                  float* h, float* out, int M, int D, int D4, int n_chunks, float eps,
                  cudaStream_t st) {
  using gemm_tf32x3::Params;
  if (M < 1 || D < 32 || D % 32 != 0 || n_chunks < 1 || D4 < 32 * n_chunks ||
      D4 % (32 * n_chunks) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float2* st2 = reinterpret_cast<float2*>(stats);
  const int ck = D4 / n_chunks;

  int err = ln_stats::launch(x, st2, M, D, eps, st);
  if (err != cudaSuccess) return err;

  for (int c = 0; c < n_chunks; ++c) {
    const size_t u0 = static_cast<size_t>(c) * ck;  // the chunk's first hidden unit
    const Params fc{x, st2, ln_g, ln_b, w_fc + u0 * D, b_fc + u0, nullptr, h, M, ck, D};
    err = gemm_tf32x3::launch<true, gemm_tf32x3::kBiasQuickGelu>(fc, st);
    if (err != cudaSuccess) return err;
    if (c == 0) {
      const Params proj{h, nullptr, nullptr, nullptr, w_proj, b_proj, x, out, M, D, ck, D4};
      err = gemm_tf32x3::launch<false, gemm_tf32x3::kBiasResidual>(proj, st);
    } else {
      const Params proj{h, nullptr, nullptr, nullptr, w_proj + u0, nullptr, out, out, M, D, ck,
                        D4};
      err = gemm_tf32x3::launch<false, gemm_tf32x3::kAccumulate>(proj, st);
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace mlp_half
