// K7: the MLP half of a pre-LN CLIP resblock as a sum over chunks of the
// hidden dimension,
//   out = x + sum_c [ QuickGELU(LN2(x) @ fc_w[units of c, :]^T + fc_b[c]) @ proj_w[:, units of c]^T ]
//           + proj_b,
// QuickGELU(h) = h * sigmoid(1.702 h), fp32 LayerNorm statistics (eps given),
// fp32 accumulation, in float32. fc_w is [4D, D] and proj_w [D, 4D] ([out, in]).
//
// Replaces: clip_ppo_tpu/models/clip/pallas_block.py::_mlp_block_chunked_kernel
// (entry fused_mlp_block under CLIP_PPO_MLP_CHUNKED=1, taken where
// 2 * D * 4D * itemsize > 12 MiB: ViT-L/14's vision tower, D = 1024, and its
// text tower, D = 768, in fp32).
//
// Bound on Hopper: operations. At ViT-L/14's [256, 257, 1024] one layer is
// 4 * 65,792 * 1,024 * 4,096 = 1.10 TFLOP against 2 x 269 MB of activations
// and 33.6 MB of weights: 16.5 ms of fp32 FMA at 67 TFLOP/s, 0.17 ms of bytes.
//
// The TPU kernel's grid is (batch blocks, chunks of 4D) with the chunk axis
// innermost and sequential: each step holds one [D, ck] slice of fc and the
// matching [ck, D] slice of proj in VMEM and adds its product into an fp32
// accumulator in scratch, which the last step writes out with the bias and
// the residual. On Hopper blocks run in parallel and in no order, so the
// chunk becomes an axis of the launch and the sum a second pass:
//   1. ln_stats_kernel: the mean and 1/std of every row, once per row.
//   2. mlp_chunk_kernel, grid (row blocks of 32, chunks): block (r, c) forms
//      LN2(x) of its rows in shared memory from the statistics, walks the
//      chunk's hidden units and writes its fp32 partial sum to partial[c] in
//      device memory.
//   3. mlp_chunk_sum_kernel: out = x + (sum over c in order 0, 1, ... of
//      partial[c] + proj_b). A fixed order and no atomics, so the result does
//      not change from run to run.
// The [B*T, 4D] hidden never reaches device memory; the partials do
// (n_chunks x the activations, the price of making the chunk a launch axis).
//
// Chunk count: the wrapper passes 4 (ck = D, 1024 hidden units at ViT-L/14's
// vision tower and 768 at its text tower). The TPU's 16 come from its 2 MiB
// VMEM budget per weight slice, which has no counterpart: a block streams its
// slice through shared memory whatever its size. The row axis alone gives
// 2,056 blocks at [256, 257, 1024] (for 132 SMs), so more chunks would add
// partial traffic (1.08 GB written and read at 4 chunks) without filling the
// card any better; 4 still gives a ragged [3, 257, 1024] 100 blocks.
//
// Within a block the walk is K5's (csrc/mlp_stream.cu), over the chunk's
// units only: the units go in sub-chunks of 64, each formed from LN2(x) and
// its fc rows, biased and activated into a [32, 64] slice in shared memory,
// and folded into a [32, D] register sum through its proj columns. The
// weights stream from device memory (L2 after the first blocks) as tiles, for
// each sub-chunk D/64 fc tiles of [64 units x 64 k] and then 8 proj tiles of
// [D x 8 units], through a two-slot ring in shared memory filled with
// cp.async, so tile i+1's copy is in flight while tile i's products run (the
// TPU kernels' double-buffered weight copies). Shared memory: LN2(x) 32 x
// (D+4) floats, the activated slice 32 x 68, two slots of max(64 x 68, 8 x D)
// floats: 153 KB at D = 768, 201 KB at 1024. The walk is written out here
// rather than shared with K5 through a device function: built that way, K5's
// D = 1024 instance spilled 332 bytes of registers instead of 148 and took
// 61.0 ms at [256, 257, 1024] instead of 57.8-58.3 (chip_smoke.py's kernel
// phase on an H100 80GB HBM3 at 700 W). Plain fp32 FMA loops on the CUDA
// cores: right first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_stats.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 32;             // rows of x per block
constexpr int kChunk = 64;            // hidden units per sub-chunk
constexpr int kFK = 64;               // reduction depth of one fc tile
constexpr int kFStride = kFK + 4;     // fc tile row stride (floats)
constexpr int kPK = 8;                // hidden units of one proj tile
constexpr int kHStride = kChunk + 4;  // activated slice row stride (floats)
constexpr int kSumThreads = 256;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int slot_floats(int D) {
  return kChunk * kFStride > kPK * D ? kChunk * kFStride : kPK * D;
}
__host__ __device__ constexpr int smem_floats(int D) {
  return kRows * (D + 4) + kRows * kHStride + 2 * slot_floats(D);
}
template <int D>
__host__ __device__ constexpr int tiles_per_chunk() {
  return D / kFK + kChunk / kPK;
}

// Tile t of the walk: sub-chunk t / tiles_per_chunk; within it, fc tiles
// first (k0 = 64 s), then proj tiles (units 8 (s - D/64)).
template <int D>
__device__ __forceinline__ void copy_tile(int t, float* slot, const float* __restrict__ w_fc,
                                          const float* __restrict__ w_proj, int D4, int tid) {
  constexpr int nF = D / kFK;
  constexpr int per_chunk = tiles_per_chunk<D>();
  const int c0 = (t / per_chunk) * kChunk, s = t % per_chunk;
  if (s < nF) {
    // fc rows c0..c0+63, columns 64 s .. +63: 16 copies of 16 bytes per row.
    for (int e = tid; e < kChunk * (kFK / 4); e += kThreads) {
      const int u = e >> 4, q = e & 15;
      cp_async16(slot + u * kFStride + 4 * q,
                 w_fc + static_cast<size_t>(c0 + u) * D + s * kFK + 4 * q);
    }
  } else {
    // proj columns c0 + j0 .. +7 of every row n: two 16-byte halves, swapped
    // on every other group of 4 rows so 8 lanes reading one half of 8
    // consecutive rows hit 32 different banks.
    const int j0 = (s - nF) * kPK;
    for (int e = tid; e < 2 * D; e += kThreads) {
      const int n = e >> 1, half = e & 1;
      cp_async16(slot + n * kPK + 4 * (half ^ ((n >> 2) & 1)),
                 w_proj + static_cast<size_t>(n) * D4 + c0 + j0 + 4 * half);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) mlp_chunk_kernel(
    const float* __restrict__ x, const float2* __restrict__ stats,
    const float* __restrict__ ln_g, const float* __restrict__ ln_b,
    const float* __restrict__ w_fc, const float* __restrict__ b_fc,
    const float* __restrict__ w_proj, float* __restrict__ partial, int M, int D4,
    int chunk_tiles) {
  constexpr int NC = D / 128;  // output columns per thread
  constexpr int kYStride = D + 4;
  constexpr int nF = D / kFK;
  constexpr int per_chunk = tiles_per_chunk<D>();
  extern __shared__ __align__(16) float smem[];
  float* y = smem;                          // [kRows][D + 4]   LN2(x)
  float* hs = y + kRows * kYStride;         // [kRows][68]      activated slice
  float* slots = hs + kRows * kHStride;     // 2 x slot_floats(D)

  const int m0 = blockIdx.x * kRows, c = blockIdx.y;
  const int tid = threadIdx.x;
  const int t0 = c * chunk_tiles, t1 = t0 + chunk_tiles;

  // The chunk's first tile is copied while LN2(x) of the rows is formed.
  copy_tile<D>(t0, slots, w_fc, w_proj, D4, tid);
  cp_async_commit();
  for (int e = tid; e < kRows * (D / 4); e += kThreads) {
    const int r = e / (D / 4), d = 4 * (e % (D / 4));
    const int m = m0 + r;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (m < M) {
      const float2 st = stats[m];
      const float4 xv = *reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * D + d);
      const float4 g = *reinterpret_cast<const float4*>(ln_g + d);
      const float4 b = *reinterpret_cast<const float4*>(ln_b + d);
      v.x = (xv.x - st.x) * st.y * g.x + b.x;
      v.y = (xv.y - st.x) * st.y * g.y + b.y;
      v.z = (xv.z - st.x) * st.y * g.z + b.z;
      v.w = (xv.w - st.x) * st.y * g.w + b.w;
    }
    *reinterpret_cast<float4*>(y + r * kYStride + d) = v;
  }

  // fc layout: unit fu, rows fr + 8 i (i < 4); a warp shares its rows.
  const int fu = tid % kChunk, fr = tid / kChunk;
  // proj layout: rows pr + 4 i (i < 8), columns pc + 128 j (j < NC).
  const int pc = tid % 128, pr = tid / 128;
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
  float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int t = t0; t < t1; ++t) {
    const int slot = (t - t0) & 1;
    if (t + 1 < t1) {
      copy_tile<D>(t + 1, slots + (slot ^ 1) * slot_floats(D), w_fc, w_proj, D4, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = t0, LN2(x)) visible to all threads
    const float* tile = slots + slot * slot_floats(D);
    const int u0 = (t / per_chunk) * kChunk, s = t % per_chunk;
    if (s < nF) {
      // -- h[32, 64] += LN2(x)[:, k0:k0+64] @ fc tile^T ----------------------
      const float* yk = y + s * kFK;
      const float* wk = tile + fu * kFStride;
#pragma unroll 4
      for (int k = 0; k < kFK; k += 4) {
        const float4 w = *reinterpret_cast<const float4*>(wk + k);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(yk + (fr + 8 * i) * kYStride + k);
          h[i] = fmaf(a.x, w.x, h[i]);
          h[i] = fmaf(a.y, w.y, h[i]);
          h[i] = fmaf(a.z, w.z, h[i]);
          h[i] = fmaf(a.w, w.w, h[i]);
        }
      }
      if (s == nF - 1) {  // the sub-chunk's hidden slice is complete: bias, QuickGELU
        const float bias = b_fc[u0 + fu];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = h[i] + bias;
          hs[(fr + 8 * i) * kHStride + fu] = v / (1.0f + __expf(-1.702f * v));
          h[i] = 0.0f;
        }
      }
    } else {
      // -- acc[32, D] += hs[:, j0:j0+8] @ proj tile^T ------------------------
      const int j0 = (s - nF) * kPK;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 w[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int n = pc + 128 * j;
          w[j] = *reinterpret_cast<const float4*>(tile + n * kPK + 4 * (half ^ ((n >> 2) & 1)));
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a =
              *reinterpret_cast<const float4*>(hs + (pr + 4 * i) * kHStride + j0 + 4 * half);
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            acc[i][j] = fmaf(a.x, w[j].x, acc[i][j]);
            acc[i][j] = fmaf(a.y, w[j].y, acc[i][j]);
            acc[i][j] = fmaf(a.z, w[j].z, acc[i][j]);
            acc[i][j] = fmaf(a.w, w[j].w, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();  // the slot is refilled by the next iteration's copy
  }

  float* part = partial + static_cast<size_t>(c) * M * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + pr + 4 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) part[static_cast<size_t>(m) * D + pc + 128 * j] = acc[i][j];
  }
}

__global__ void __launch_bounds__(kSumThreads) mlp_chunk_sum_kernel(
    const float* __restrict__ x, const float* __restrict__ partial,
    const float* __restrict__ b_proj, float* __restrict__ out, long long MD, int D,
    int n_chunks) {
  const long long stride = static_cast<long long>(gridDim.x) * kSumThreads * 4;
  for (long long e = (static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x) * 4;
       e < MD; e += stride) {
    float4 s = *reinterpret_cast<const float4*>(partial + e);
    for (int c = 1; c < n_chunks; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(partial + c * MD + e);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    const float4 b = *reinterpret_cast<const float4*>(b_proj + e % D);
    const float4 xv = *reinterpret_cast<const float4*>(x + e);
    *reinterpret_cast<float4*>(out + e) =
        make_float4(xv.x + (s.x + b.x), xv.y + (s.y + b.y), xv.z + (s.z + b.z),
                    xv.w + (s.w + b.w));
  }
}

template <int D>
int launch(const float* x, const float* ln_g, const float* ln_b, const float* w_fc,
           const float* b_fc, const float* w_proj, const float* b_proj, float* stats,
           float* partial, float* out, int M, int D4, int n_chunks, float eps,
           cudaStream_t st) {
  int err = ln_stats::launch(x, reinterpret_cast<float2*>(stats), M, D, eps, st);
  if (err != cudaSuccess) return err;
  const int smem = smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      mlp_chunk_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int chunk_tiles = (D4 / n_chunks / kChunk) * tiles_per_chunk<D>();
  const dim3 grid((M + kRows - 1) / kRows, n_chunks);
  mlp_chunk_kernel<D><<<grid, kThreads, smem, st>>>(
      x, reinterpret_cast<const float2*>(stats), ln_g, ln_b, w_fc, b_fc, w_proj, partial, M,
      D4, chunk_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long MD = static_cast<long long>(M) * D;
  const long long want = (MD / 4 + kSumThreads - 1) / kSumThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  mlp_chunk_sum_kernel<<<blocks, kSumThreads, 0, st>>>(x, partial, b_proj, out, MD, D,
                                                         n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: [M, D]; w_fc: [D4, D]; b_fc: [D4]; w_proj: [D, D4]; b_proj, ln_g,
// ln_b: [D]; stats: [M, 2] scratch; partial: [n_chunks, M, D] scratch. D a
// multiple of 128 up to 1024; D4 a multiple of 64 * n_chunks; every pointer
// 16-byte aligned (rows are read and written in 16-byte pieces).
int mlp_chunked_launch(const float* x, const float* ln_g, const float* ln_b,
                       const float* w_fc, const float* b_fc, const float* w_proj,
                       const float* b_proj, float* stats, float* partial, float* out, int M,
                       int width, int D4, int n_chunks, float eps, void* stream) {
  if (M < 1 || n_chunks < 1 || n_chunks > 65535 || D4 < kChunk * n_chunks ||
      D4 % (kChunk * n_chunks) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CLIP_PPO_MLP_CHUNKED_CASE(W)                                                        \
  case W:                                                                                  \
    return launch<W>(x, ln_g, ln_b, w_fc, b_fc, w_proj, b_proj, stats, partial, out, M, D4, \
                     n_chunks, eps, st);
  switch (width) {
    CLIP_PPO_MLP_CHUNKED_CASE(128)
    CLIP_PPO_MLP_CHUNKED_CASE(256)
    CLIP_PPO_MLP_CHUNKED_CASE(384)
    CLIP_PPO_MLP_CHUNKED_CASE(512)
    CLIP_PPO_MLP_CHUNKED_CASE(640)
    CLIP_PPO_MLP_CHUNKED_CASE(768)
    CLIP_PPO_MLP_CHUNKED_CASE(896)
    CLIP_PPO_MLP_CHUNKED_CASE(1024)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CLIP_PPO_MLP_CHUNKED_CASE
}

}  // extern "C"
