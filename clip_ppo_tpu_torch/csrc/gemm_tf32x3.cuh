// The GEMM shared by K2 (attn_block.cu), K5 (mlp_stream.cu), K6
// (attn_stream.cu) and K7 (mlp_chunked.cu):
//   C[M, N] = epilogue(A'[M, K] @ W[N, K]^T),
// float32 in and out, the products on Hopper's tensor cores (wgmma) in
// 3xTF32. A' is A, or LN(A): (a - mean) * rstd * gamma + beta from
// ln_stats.cuh's per-row (mean, rstd), applied in shared memory as each
// slice of A arrives, so LN(A) never reaches device memory. The epilogue
// adds the bias, then applies QuickGELU (h * sigmoid(1.702 h)) or adds the
// residual R[M, N]; or adds R with no bias, where R may be C itself (K7 adds
// each chunk of the hidden dimension's product to its output in place). W
// is a weight stored [out, in], as the resblocks keep theirs, so both
// operands are K-major: the layout wgmma takes TF32 in. W's rows may lie
// further apart than K (ldw): K7 reads a block of columns of proj_w [D, 4D]
// as a [D, 4D / chunks] W.
//
// Bound on Hopper: operations. A product of 2 M N K flops runs as three TF32
// passes, 6 M N K flops of tensor-core work at the 495 TFLOP/s TF32 peak
// (against 2 M N K at the fp32 CUDA cores' 67 TFLOP/s). At K5's fc at
// ViT-L/14, [65,792 x 1,024] @ [4,096 x 1,024]^T, that is 1.66 PFLOP of
// TF32 work, 3.4 ms, against 0.27 GB of A read and 1.08 GB of C written,
// 0.40 ms at 3.35 TB/s.
//
// Numerics (tf32x3.cuh). Each fp32 operand x is split into big and small:
// big is x itself, which wgmma reads truncated to TF32 as mma.sync does
// (writing trunc(x) explicitly gave bit-identical results on an H100), and
// small = x - trunc(x), exact in fp32. Each k-step of 8 adds a_small * b_big,
// then a_big * b_small, then a_big * b_big (a_small * b_small, ~2^-22 of
// the product, is dropped). The tensor core's adder truncates toward zero,
// so a long sum kept in its accumulator drifts by up to an ulp a step: over
// K = 4,096 the first version of this GEMM, one accumulator throughout,
// erred by 2.2e-4 against 7.7e-4 allowed at ViT-L/14, as
// tests/port/test_torch_tf32_gemm.py's emulation predicts. So each slice
// of 32 accumulates in a register set of its own (12 wgmma, the first with
// its accumulator zeroed), which the threads then add to the running fp32
// sum with ordinary rounded adds: 2.3e-5 on an H100.
//
// Design:
// * Tiles. A block computes a 128 x 128 tile of C with two warpgroups
//   (256 threads), one a 64-row half: wgmma.m64n128k8.tf32 with A and B
//   read from shared memory by descriptors, 64 fp32 accumulators a thread,
//   plus 64 for the slice. The launch bounds allow 255 registers: one block
//   an SM.
// * Staging. The reduction runs in slices of 32 columns: one 128-byte row of
//   A and of W a tile row, stored in the 128-byte swizzle wgmma reads (16-
//   byte chunk c of row r at chunk c ^ (r % 8)). Raw slices go through a
//   4-stage cp.async ring (4 x 32 KB); rows past M and N are zero-filled by
//   cp.async's source-size operand and never stored. Each thread then
//   prepares the chunks it copied itself (so no barrier is needed before):
//   LN(A) written back in place where asked, and the small parts of A' and
//   W into a second, double-buffered pair of tiles (2 x 32 KB). 192 KB of
//   shared memory.
// * Overlap. While slice i's 12 wgmma run, the threads issue the copy of
//   slice i + 3 and prepare slice i + 1; then they wait for the wgmma, add
//   the slice's sum into the running one, and meet at one barrier a slice.
//   (On an H100, letting the wgmma chain run on across slices, with a sum
//   every 4 slices, a third set of small tiles and copies 2 slices ahead,
//   was 3-8% slower; reading A from registers, wgmma's RS form, which
//   spares A's small tiles, was level.)
// * Raster. Consecutive blocks share a row block of A and walk the column
//   blocks, so A is read from device memory about once and W (at most
//   16.8 MB here) stays in the 50 MB L2.
// * Epilogue. A thread holds columns 8 j + 2 (lane % 4) and + 1 of rows
//   lane / 4 and + 8 of its warp's 16: bias, activation and residual on
//   float2 pairs, stored as float2.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace gemm_tf32x3 {

constexpr int kBM = 128;    // rows of a block tile (two warpgroups of 64)
constexpr int kBN = 128;    // columns of a block tile: the wgmma's N
constexpr int kBK = 32;     // reduction slice: one 128-byte swizzle row
constexpr int kStages = 4;  // raw slices in the cp.async ring
constexpr int kThreads = 256;
constexpr int kTileBytes = kBM * kBK * 4;               // 16 KB, A or W
constexpr int kRawBytes = kStages * 2 * kTileBytes;     // 128 KB
constexpr int kSmallBytes = 2 * 2 * kTileBytes;         // 64 KB
constexpr int kSmemBytes = kRawBytes + kSmallBytes + 1024;  // + alignment to the swizzle's 1 KB
static_assert(kBM == kBN, "A and W tiles share one layout");

// kAccumulate: C = R + A' @ W^T, no bias, R == C allowed. Each element of R
// is read, and the same element of C written, by one thread; the read is a
// coherent ld.global (never __ldg or ld.global.nc, whose path assumes the
// data does not change while the kernel runs).
enum Epilogue { kBias, kBiasQuickGelu, kBiasResidual, kAccumulate };

// C = epilogue(A' @ W^T). stats, ln_g, ln_b are read only with LN; R only
// with kBiasResidual and kAccumulate; bias not with kAccumulate. A, W, C, R, bias, ln_g,
// ln_b 16-byte aligned; K a multiple of kBK, N a multiple of 8; W's rows
// ldw floats apart (0: K), ldw >= K and a multiple of 4.
struct Params {
  const float* A;
  const float2* stats;  // [M] (mean, rstd)
  const float* ln_g;
  const float* ln_b;
  const float* W;
  const float* bias;
  const float* R;
  float* C;
  int M, N, K;
  int ldw;
};

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ int swizzle(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// A wgmma matrix descriptor: K-major, 128-byte swizzle, 8-row groups 1 KB
// apart; the leading byte offset is unused in this layout.
__device__ __forceinline__ uint64_t descriptor(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes by the threads, visible to the wgmma that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A[64 x 8] @ B[128 x 8]^T, both from shared memory; zero_d starts d at 0.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int zero_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n}\n"
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

// Two floats from device memory through the coherent path.
__device__ __forceinline__ float2 ld_coherent(const float* p) {
  float2 v;
  asm volatile("ld.global.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}

__device__ __forceinline__ float4 small_part(float4 x) {
  return make_float4(tf32x3::small_part(x.x), tf32x3::small_part(x.y),
                     tf32x3::small_part(x.z), tf32x3::small_part(x.w));
}

template <bool kLN, int kEpi>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const Params p) {
  using namespace tf32x3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int n_blocks = (p.N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / n_blocks) * kBM, n0 = (blockIdx.x % n_blocks) * kBN;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int slices = p.K / kBK;

  // Thread tid copies and prepares chunk c = tid % 8 of rows tid / 8 + 32 j
  // (j < 4) of the A tile and of the W tile.
  const int c = tid & 7;
  int off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) off[j] = swizzle((tid >> 3) + 32 * j, c);

  auto raw = [&](int i) { return smem + (i % kStages) * 2 * kTileBytes; };  // A, then W
  auto small = [&](int i) { return smem + kRawBytes + (i & 1) * 2 * kTileBytes; };

  auto load_slice = [&](int i) {
    unsigned char* s = raw(i);
    const int k = i * kBK + 4 * c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + (tid >> 3) + 32 * j, n = n0 + (tid >> 3) + 32 * j;
      cp_async16(reinterpret_cast<float*>(s + off[j]),
                 p.A + static_cast<size_t>(m < p.M ? m : 0) * p.K + k, m < p.M ? 16 : 0);
      cp_async16(reinterpret_cast<float*>(s + kTileBytes + off[j]),
                 p.W + static_cast<size_t>(n < p.N ? n : 0) * p.ldw + k, n < p.N ? 16 : 0);
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

  // Slice i's chunks of this thread (landed): LN(A) in place where asked,
  // and the small parts of A' and W beside.
  auto prepare = [&](int i) {
    unsigned char* s = raw(i);
    unsigned char* t = small(i);
    float4 g, b;
    if (kLN) {
      g = __ldg(reinterpret_cast<const float4*>(p.ln_g + i * kBK + 4 * c));
      b = __ldg(reinterpret_cast<const float4*>(p.ln_b + i * kBK + 4 * c));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 a = *reinterpret_cast<const float4*>(s + off[j]);
      if (kLN) {
        a.x = fmaf(fmaf(a.x, ln[j].x, ln[j].y), g.x, b.x);
        a.y = fmaf(fmaf(a.y, ln[j].x, ln[j].y), g.y, b.y);
        a.z = fmaf(fmaf(a.z, ln[j].x, ln[j].y), g.z, b.z);
        a.w = fmaf(fmaf(a.w, ln[j].x, ln[j].y), g.w, b.w);
      }
      if (kLN) *reinterpret_cast<float4*>(s + off[j]) = a;
      *reinterpret_cast<float4*>(t + off[j]) = small_part(a);
      const float4 w = *reinterpret_cast<const float4*>(s + kTileBytes + off[j]);
      *reinterpret_cast<float4*>(t + kTileBytes + off[j]) = small_part(w);
    }
    fence_proxy_async();
  };

  float acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = part[e] = 0.0f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < slices) load_slice(i);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  prepare(0);

  for (int i = 0; i < slices; ++i) {
    __syncthreads();  // slice i prepared by every thread; slice i - 1's wgmma done everywhere
    // This warpgroup's 64 rows: 8 KB into each A tile.
    const uint32_t a_big = smem_addr + static_cast<uint32_t>(raw(i) - smem) + wg * 8192;
    const uint32_t a_small = smem_addr + static_cast<uint32_t>(small(i) - smem) + wg * 8192;
    const uint32_t w_big = smem_addr + static_cast<uint32_t>(raw(i) - smem) + kTileBytes;
    const uint32_t w_small = smem_addr + static_cast<uint32_t>(small(i) - smem) + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {  // k-step s: 32 bytes into each 128-byte row
      wgmma(part, descriptor(a_small + 32 * s), descriptor(w_big + 32 * s), s == 0);
      wgmma(part, descriptor(a_big + 32 * s), descriptor(w_small + 32 * s), 0);
      wgmma(part, descriptor(a_big + 32 * s), descriptor(w_big + 32 * s), 0);
    }
    wgmma_commit();
    // Behind the wgmma: the copy of slice i + 3 (into slice i - 1's stage,
    // whose wgmma are done) and the preparation of slice i + 1 (its small
    // tiles are slice i - 1's).
    if (i + kStages - 1 < slices) load_slice(i + kStages - 1);
    cp_async_commit();
    if (i + 1 < slices) {
      cp_async_wait<kStages - 2>();
      prepare(i + 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += part[e];
  }
  cp_async_wait<0>();  // no copy may be left in flight at exit

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
      if (kEpi == kAccumulate) {
        const float2 r = ld_coherent(p.R + o);
        *reinterpret_cast<float2*>(p.C + o) = make_float2(r.x + v.x, r.y + v.y);
        continue;
      }
      const float2 bias = __ldg(reinterpret_cast<const float2*>(p.bias + n));
      v = make_float2(v.x + bias.x, v.y + bias.y);
      if (kEpi == kBiasQuickGelu) {
        v.x = v.x / (1.0f + __expf(-1.702f * v.x));
        v.y = v.y / (1.0f + __expf(-1.702f * v.y));
      } else if (kEpi == kBiasResidual) {
        const float2 r = *reinterpret_cast<const float2*>(p.R + o);
        v = make_float2(r.x + v.x, r.y + v.y);
      }
      *reinterpret_cast<float2*>(p.C + o) = v;
    }
  }
}

// Launches C = epilogue(A' @ W^T) on st. Returns a cudaError_t.
template <bool kLN, int kEpi>
int launch(Params p, cudaStream_t st) {
  if (p.ldw == 0) p.ldw = p.K;
  if (p.M < 1 || p.N < 8 || p.N % 8 != 0 || p.K < kBK || p.K % kBK != 0 || p.ldw < p.K ||
      p.ldw % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>((p.M + kBM - 1) / kBM) * ((p.N + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<kLN, kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_kernel<kLN, kEpi><<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm_tf32x3
