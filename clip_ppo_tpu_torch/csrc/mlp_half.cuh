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
//
// In bfloat16 (the bf16 entry points of K3, K5 and K7) the same launches
// run ln_stats on bf16 rows and the bf16 GEMM (gemm_bf16.cuh), one bf16
// pass a product, rounding where the TPU kernels round: LN2(x) to bf16
// before fc, the hidden to bf16 after QuickGELU in fp32, the projection to
// bf16 before the residual add. With several chunks (K7) the projection is
// summed in fp32 and rounded once, as _mlp_block_chunked_kernel sums it in
// its fp32 acc_scratch: each chunk's proj GEMM but the last writes the sum
// so far into an fp32 [M, D] scratch (acc32; the GEMM's kAccumulate, chunk 0
// with nothing to add), and the last adds it, then proj_b, rounds to bf16,
// adds the residual and rounds again. Rounding each chunk's product into
// the bf16 output instead would round once a chunk: not the TPU kernel's
// function. The bf16 reduction slice is 64 deep, so D is a multiple of 64
// and 4D of 64 x n_chunks there.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_bf16.cuh"
#include "gemm_tf32x3.cuh"
#include "ln_stats.cuh"

namespace mlp_half {

// x, out: [M, D]; w_fc: [D4, D]; b_fc: [D4]; w_proj: [D, D4]; b_proj, ln_g,
// ln_b: [D]; stats: [M, 2] fp32 and h: [M, D4 / n_chunks] scratch; Elem is
// float or __nv_bfloat16, every tensor but stats and acc32 of that type;
// acc32: [M, D] fp32 scratch, read only in bf16 with n_chunks > 1. Returns a
// cudaError_t.
template <typename Elem>
int launch(const Elem* x, const Elem* ln_g, const Elem* ln_b, const Elem* w_fc,
           const Elem* b_fc, const Elem* w_proj, const Elem* b_proj, float* stats, Elem* h,
           Elem* out, int M, int D, int D4, int n_chunks, float eps, cudaStream_t st,
           float* acc32 = nullptr) {
  constexpr bool kF32 = std::is_same<Elem, float>::value;
  static_assert(kF32 || std::is_same<Elem, __nv_bfloat16>::value, "float or bfloat16");
  const int slice = kF32 ? gemm_tf32x3::kBK : gemm_bf16::kBK;
  if (M < 1 || D < slice || D % slice != 0 || n_chunks < 1 || D4 < slice * n_chunks ||
      D4 % (slice * n_chunks) != 0 || (!kF32 && n_chunks > 1 && acc32 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float2* st2 = reinterpret_cast<float2*>(stats);
  const int ck = D4 / n_chunks;

  int err = ln_stats::launch(x, st2, M, D, eps, st);
  if (err != cudaSuccess) return err;
  if constexpr (!kF32) {
    using gemm_bf16::Params;
    for (int c = 0; c < n_chunks; ++c) {
      const size_t u0 = static_cast<size_t>(c) * ck;  // the chunk's first hidden unit
      const Params fc{x, st2, ln_g, ln_b, w_fc + u0 * D, b_fc + u0, nullptr, h, M, ck, D};
      err = gemm_bf16::launch<true, gemm_bf16::kBiasQuickGelu>(fc, st);
      if (err != cudaSuccess) return err;
      const float* sum = c == 0 ? nullptr : acc32;  // the fp32 sum of chunks 0 .. c - 1
      if (c == n_chunks - 1) {
        const Params proj{h,  nullptr, nullptr, nullptr, w_proj + u0, b_proj, x, out, M, D, ck,
                          D4, nullptr, sum};
        err = gemm_bf16::launch<false, gemm_bf16::kBiasResidual>(proj, st);
      } else {
        const Params proj{h,  nullptr, nullptr, nullptr, w_proj + u0, nullptr, nullptr, nullptr,
                          M,  D,       ck,      D4,      acc32,       sum};
        err = gemm_bf16::launch<false, gemm_bf16::kAccumulate>(proj, st);
      }
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  } else {
    using gemm_tf32x3::Params;
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
}

}  // namespace mlp_half
