// The bf16 GEMM of K2, K3, K5, K6 and K7 in bfloat16 (attn_half.cuh,
// mlp_half.cuh):
//   C[M, N] = epilogue(A'[M, K] @ W[N, K]^T),
// bf16 in and out, the products on Hopper's tensor cores (wgmma) in one
// bf16 pass with float32 accumulators. The sibling of gemm_tf32x3.cuh, with
// its tiles, 128-byte swizzle, descriptors, cp.async ring and epilogue
// layout (shared from there): a 128-byte swizzled row holds 64 bf16 values
// where it held 32 floats, so a reduction slice is 64 deep, four wgmma
// k16 steps, and a product runs once instead of three times.
//
// What is rounded where, as the TPU kernels round it
// (clip_ppo_tpu/models/clip/pallas_block.py::_attn_block_kernel and
// ::_mlp_block_kernel, with bf16 x and weights):
// * A' is A, or LN(A) rounded to bf16: (a - mean) * rstd * gamma + beta in
//   fp32 from ln_stats.cuh's fp32 (mean, rstd) and the bf16 gamma and beta,
//   rounded to bf16 in shared memory as each slice of A arrives (the TPU
//   kernel's _ln returns y.astype(x.dtype) before the product).
// * The product plus the bias in fp32, then: kBias rounds to bf16 (the qkv);
//   kBiasQuickGelu applies QuickGELU in fp32, then rounds (the hidden);
//   kBiasResidual rounds the projection to bf16 first and adds it to the
//   bf16 residual, rounding the sum again (o = x + out.astype(x.dtype)).
// * K7's chunks of the hidden dimension (mlp_half.cuh) sum in fp32, as
//   _mlp_block_chunked_kernel sums them in its fp32 acc_scratch and rounds
//   once: kAccumulate writes the fp32 sum C32 = R32 + A' @ W^T (R32 null:
//   0; R32 == C32 allowed) and no bf16 C; kBiasResidual with R32 given adds
//   R32 to the product in fp32 before the bias and the rounding.
//
// Bound on Hopper: operations, 2 M N K flops at the dense bf16 peak, 989
// TFLOP/s. At K3's fc in the FROZEN_CLIP update, [12,800 x 768] @ [3,072 x
// 768]^T, 60.4 GFLOP, 0.061 ms, against 19.7 MB of A read and 78.6 MB of
// the hidden written, 0.029 ms at 3.35 TB/s.
//
// Design: the f32 GEMM's. 128 x 128 tiles, two warpgroups of 64 rows each,
// wgmma.m64n128k16 with A and B from shared memory by descriptor; a
// 4-stage cp.async ring of raw slices (rows past M and N zero-filled);
// each thread applies LN to the chunks it copied; one barrier a slice. The
// bf16 product needs no big/small split, so there are no small tiles
// (128 KB of shared memory where the f32 GEMM takes 192 KB), and the sum
// stays in one set of accumulators for the whole reduction: the tensor
// core's truncating adder drifts by an fp32 ulp a step at most, ~2^-13 of
// the sum over K = 3,072, far inside a bf16 ulp (2^-8).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tf32x3.cuh"

namespace gemm_bf16 {

using gemm_tf32x3::descriptor;
using gemm_tf32x3::fence_proxy_async;
using gemm_tf32x3::kAccumulate;
using gemm_tf32x3::kBias;
using gemm_tf32x3::kBiasQuickGelu;
using gemm_tf32x3::kBiasResidual;
using gemm_tf32x3::kBM;
using gemm_tf32x3::kBN;
using gemm_tf32x3::kStages;
using gemm_tf32x3::kThreads;
using gemm_tf32x3::ld_coherent;
using gemm_tf32x3::swizzle;
using gemm_tf32x3::wgmma_commit;
using gemm_tf32x3::wgmma_fence;
using gemm_tf32x3::wgmma_wait;

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                                     // one 128-byte swizzle row of bf16
constexpr int kTileBytes = kBM * kBK * 2;                   // 16 KB, A or W
constexpr int kSmemBytes = kStages * 2 * kTileBytes + 1024;  // + alignment to the swizzle's 1 KB

// C = epilogue(A' @ W^T). stats, ln_g, ln_b are read only with LN; R only
// with kBiasResidual; bias and C not with kAccumulate, which writes C32; R32
// (fp32 [M, N], may be null) with kAccumulate and kBiasResidual. A, W, C,
// R, C32, R32, bias, ln_g, ln_b 16-byte aligned; K a multiple of kBK, N a
// multiple of 8; W's rows ldw elements apart (0: K), ldw >= K and a
// multiple of 8.
struct Params {
  const bf16* A;
  const float2* stats;  // [M] (mean, rstd), fp32
  const bf16* ln_g;
  const bf16* ln_b;
  const bf16* W;
  const bf16* bias;
  const bf16* R;
  bf16* C;
  int M, N, K;
  int ldw;
  float* C32;
  const float* R32;
};

// d (+)= A[64 x 16] @ B[128 x 16]^T in bf16, fp32 accumulators; both from
// shared memory, both K-major (no transpose); zero_d starts d at 0.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int zero_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(zero_d)
      : "memory");
}

template <bool kLN, int kEpi>
__global__ void __launch_bounds__(kThreads, 1) gemm_bf16_kernel(const Params p) {
  static_assert(kEpi == kBias || kEpi == kBiasQuickGelu || kEpi == kBiasResidual ||
                kEpi == kAccumulate, "an epilogue of gemm_tf32x3::Epilogue");
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_bf16));
  unsigned char* smem = smem_bf16 + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int n_blocks = (p.N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / n_blocks) * kBM, n0 = (blockIdx.x % n_blocks) * kBN;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int slices = p.K / kBK;

  // Thread tid copies (and normalizes) chunk c = tid % 8, 8 elements, of
  // rows tid / 8 + 32 j (j < 4) of the A tile and of the W tile.
  const int c = tid & 7;
  int off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) off[j] = swizzle((tid >> 3) + 32 * j, c);

  auto stage = [&](int i) { return smem + (i % kStages) * 2 * kTileBytes; };  // A, then W

  auto load_slice = [&](int i) {
    unsigned char* s = stage(i);
    const int k = i * kBK + 8 * c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + (tid >> 3) + 32 * j, n = n0 + (tid >> 3) + 32 * j;
      tf32x3::cp_async16(reinterpret_cast<float*>(s + off[j]),
                         reinterpret_cast<const float*>(
                             p.A + static_cast<size_t>(m < p.M ? m : 0) * p.K + k),
                         m < p.M ? 16 : 0);
      tf32x3::cp_async16(reinterpret_cast<float*>(s + kTileBytes + off[j]),
                         reinterpret_cast<const float*>(
                             p.W + static_cast<size_t>(n < p.N ? n : 0) * p.ldw + k),
                         n < p.N ? 16 : 0);
    }
  };

  // LN of the thread's rows: a' = fma(fma(a, rstd, -mean * rstd), gamma, beta).
  float2 ln[4];
  if (kLN) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + (tid >> 3) + 32 * j;
      const float2 s = m < p.M ? p.stats[m] : make_float2(0.0f, 1.0f);
      ln[j] = make_float2(s.y, -s.x * s.y);
    }
  }

  // Slice i's chunks of this thread (landed): LN(A) rounded to bf16 in
  // place where asked; then every thread's writes, the copies' included,
  // made visible to the wgmma.
  auto prepare = [&](int i) {
    if (kLN) {
      unsigned char* s = stage(i);
      // Eight bf16 a chunk, read as four bf16 pairs.
      const uint4 g = __ldg(reinterpret_cast<const uint4*>(p.ln_g + i * kBK + 8 * c));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(p.ln_b + i * kBK + 8 * c));
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        __nv_bfloat162* a2 = reinterpret_cast<__nv_bfloat162*>(s + off[j]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 x = __bfloat1622float2(a2[q]);
          const float2 gq = __bfloat1622float2(g2[q]), bq = __bfloat1622float2(b2[q]);
          a2[q] = __floats2bfloat162_rn(fmaf(fmaf(x.x, ln[j].x, ln[j].y), gq.x, bq.x),
                                        fmaf(fmaf(x.y, ln[j].x, ln[j].y), gq.y, bq.y));
        }
      }
    }
    fence_proxy_async();
  };

  float acc[64];  // zeroed by the first wgmma
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < slices) load_slice(i);
    tf32x3::cp_async_commit();
  }
  tf32x3::cp_async_wait<kStages - 2>();
  prepare(0);

  for (int i = 0; i < slices; ++i) {
    __syncthreads();  // slice i prepared by every thread; slice i - 1's wgmma done everywhere
    // This warpgroup's 64 rows: 8 KB into the A tile.
    const uint32_t a_addr = smem_addr + static_cast<uint32_t>(stage(i) - smem) + wg * 8192;
    const uint32_t w_addr = smem_addr + static_cast<uint32_t>(stage(i) - smem) + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s)  // k-step s: 32 bytes into each 128-byte row
      wgmma(acc, descriptor(a_addr + 32 * s), descriptor(w_addr + 32 * s), i == 0 && s == 0);
    wgmma_commit();
    // Behind the wgmma: the copy of slice i + 3 (into slice i - 1's stage,
    // whose wgmma are done) and the preparation of slice i + 1.
    if (i + kStages - 1 < slices) load_slice(i + kStages - 1);
    tf32x3::cp_async_commit();
    if (i + 1 < slices) {
      tf32x3::cp_async_wait<kStages - 2>();
      prepare(i + 1);
    }
    wgmma_wait<0>();
  }
  tf32x3::cp_async_wait<0>();  // no copy may be left in flight at exit

  // acc[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h of the warpgroup's 64,
  // column 8 j + 2 (lane % 4) + e.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= p.N) continue;
      const size_t o = static_cast<size_t>(m) * p.N + n;
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if ((kEpi == kAccumulate || kEpi == kBiasResidual) && p.R32 != nullptr) {
        const float2 r = ld_coherent(p.R32 + o);  // R32 may be C32 itself
        v = make_float2(r.x + v.x, r.y + v.y);
      }
      if (kEpi == kAccumulate) {
        *reinterpret_cast<float2*>(p.C32 + o) = v;
        continue;
      }
      const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bias + n));
      v = make_float2(v.x + bias.x, v.y + bias.y);
      if (kEpi == kBiasQuickGelu) {
        v.x = v.x / (1.0f + __expf(-1.702f * v.x));
        v.y = v.y / (1.0f + __expf(-1.702f * v.y));
      }
      __nv_bfloat162 out = __float22bfloat162_rn(v);
      if (kEpi == kBiasResidual) {
        const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.R + o));
        const float2 f = __bfloat1622float2(out);
        out = __floats2bfloat162_rn(r.x + f.x, r.y + f.y);
      }
      *reinterpret_cast<__nv_bfloat162*>(p.C + o) = out;
    }
  }
}

// Launches C = epilogue(A' @ W^T) on st. Returns a cudaError_t.
template <bool kLN, int kEpi>
int launch(Params p, cudaStream_t st) {
  if (p.ldw == 0) p.ldw = p.K;
  if (p.M < 1 || p.N < 8 || p.N % 8 != 0 || p.K < kBK || p.K % kBK != 0 || p.ldw < p.K ||
      p.ldw % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>((p.M + kBM - 1) / kBM) * ((p.N + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16_kernel<kLN, kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_bf16_kernel<kLN, kEpi><<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm_bf16
