// K5: the MLP half of a pre-LN CLIP resblock with its weights streamed,
//   out = x + sum_c QuickGELU(LN2(x) @ fc_w[c,:]^T + fc_b[c]) @ proj_w[:,c]^T + proj_b,
// QuickGELU(h) = h * sigmoid(1.702 h), fp32 LayerNorm statistics (eps given),
// fp32 accumulation, in float32. fc_w is [4D, D] and proj_w [D, 4D] ([out, in]).
//
// Replaces: clip_ppo_tpu/models/clip/pallas_block.py::_mlp_stream_kernel
// (entry fused_mlp_block, taken where 2 * D * 4D * itemsize > 12 MiB: the
// ViT-B/32 vision tower in fp32, D = 768, and ViT-L/14's D = 1024).
//
// Bound on Hopper: operations. At the vision tower's [1024, 50, 768] one layer
// is 4 * 51,200 * 768 * 3,072 = 483 GFLOP against 2 x 157 MB of activations
// and 18.9 MB of weights: 7.2 ms of fp32 FMA at 67 TFLOP/s, 0.10 ms of bytes.
//
// What the TPU kernel keeps out of device memory, and how this one does it:
// the [B*T, 4D] hidden never exists in device memory. One block owns 32 rows
// of the flattened [B*T, D] input for the whole launch: it writes LN2 of those
// rows into shared memory once and keeps the [32, D] output sum in registers
// (8 rows x D/128 columns per thread). It then walks 4D in chunks of 64 hidden
// units. A chunk is formed from LN2(x) and the chunk's fc rows, biased and
// activated into a [32, 64] slice in shared memory, and folded into the
// register sum through the chunk's proj columns. The weights stream from
// device memory (L2 after the first blocks) as a sequence of tiles:
// for each chunk, D/64 fc tiles of [64 units x 64 k] and then 8 proj tiles of
// [D x 8 units]. Tiles pass through a two-slot ring in shared memory filled
// with cp.async, so tile i+1's copy is in flight while tile i's products run
// (the TPU kernel's two-semaphore double buffer). A whole [D, 64] fc slice and
// its proj slice (2 x 192 KB at D = 768) do not fit beside LN2(x) in the 227 KB
// a Hopper block may hold, hence tiles finer than a chunk.
//
// Shared memory: LN2(x) 32 x (D+4) floats, the activated chunk 32 x 68, and
// two slots of max(64 x 68, 8 x D) floats: 153 KB at D = 768, 201 KB at 1024.
// Padding and the proj tile's swizzle keep every 16-byte shared load free of
// bank conflicts. Plain fp32 FMA loops on the CUDA cores: right first; wgmma
// (TF32 or bf16) would change the numerics and is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 32;             // rows of x per block
constexpr int kChunk = 64;            // hidden units per chunk
constexpr int kFK = 64;               // reduction depth of one fc tile
constexpr int kFStride = kFK + 4;     // fc tile row stride (floats)
constexpr int kPK = 8;                // hidden units of one proj tile
constexpr int kHStride = kChunk + 4;  // activated chunk row stride (floats)

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

// Tile t of the walk: chunk t / per_chunk; within it, fc tiles first (k0 =
// 64 s), then proj tiles (units 8 (s - nF)).
template <int D>
__device__ __forceinline__ void copy_tile(int t, float* slot, const float* __restrict__ w_fc,
                                          const float* __restrict__ w_proj, int D4, int tid) {
  constexpr int nF = D / kFK;
  constexpr int per_chunk = nF + kChunk / kPK;
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
__global__ void __launch_bounds__(kThreads, 1) mlp_stream_kernel(
    const float* __restrict__ x, const float* __restrict__ ln_g,
    const float* __restrict__ ln_b, const float* __restrict__ w_fc,
    const float* __restrict__ b_fc, const float* __restrict__ w_proj,
    const float* __restrict__ b_proj, float* __restrict__ out, int M, int D4,
    float eps) {
  constexpr int NC = D / 128;  // output columns per thread
  constexpr int kYStride = D + 4;
  constexpr int nF = D / kFK;
  constexpr int per_chunk = nF + kChunk / kPK;
  extern __shared__ __align__(16) float smem[];
  float* y = smem;                          // [kRows][D + 4]   LN2(x)
  float* hs = y + kRows * kYStride;         // [kRows][68]      activated chunk
  float* slots = hs + kRows * kHStride;     // 2 x slot_floats(D)

  const int m0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // The first tile's copy runs behind LN2.
  copy_tile<D>(0, slots, w_fc, w_proj, D4, tid);
  cp_async_commit();

  // -- LN2 of the block's rows into shared memory ----------------------------
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float* yr = y + r * kYStride;
    const int m = m0 + r;
    if (m >= M) {
      for (int d = lane; d < D; d += 32) yr[d] = 0.0f;
      continue;
    }
    const float* xr = x + static_cast<size_t>(m) * D;
    float sum = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float v = xr[d];
      yr[d] = v;
      sum += v;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / D;
    float sq = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float c = yr[d] - mean;
      sq += c * c;
    }
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq / D + eps);
    for (int d = lane; d < D; d += 32) yr[d] = (yr[d] - mean) * rstd * ln_g[d] + ln_b[d];
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

  const int n_tiles = (D4 / kChunk) * per_chunk;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      copy_tile<D>(t + 1, slots + ((t + 1) & 1) * slot_floats(D), w_fc, w_proj, D4, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = 0, LN2(x)) visible to all threads
    const float* tile = slots + (t & 1) * slot_floats(D);
    const int c0 = (t / per_chunk) * kChunk, s = t % per_chunk;
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
      if (s == nF - 1) {  // chunk's hidden slice complete: bias, QuickGELU
        const float bias = b_fc[c0 + fu];
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
    __syncthreads();  // slot (t & 1) is refilled by the next iteration's copy
  }

  // -- residual and bias -------------------------------------------------------
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + pr + 4 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int n = pc + 128 * j;
      const size_t o = static_cast<size_t>(m) * D + n;
      out[o] = x[o] + (acc[i][j] + b_proj[n]);
    }
  }
}

template <int D>
int launch(const float* x, const float* ln_g, const float* ln_b, const float* w_fc,
           const float* b_fc, const float* w_proj, const float* b_proj, float* out, int M,
           int D4, float eps, cudaStream_t stream) {
  const int smem = smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_stream_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_stream_kernel<D><<<(M + kRows - 1) / kRows, kThreads, smem, stream>>>(
      x, ln_g, ln_b, w_fc, b_fc, w_proj, b_proj, out, M, D4, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: [M, D]; w_fc: [D4, D]; b_fc: [D4]; w_proj: [D, D4]; b_proj, ln_g,
// ln_b: [D]. D a multiple of 128 up to 1024; D4 a multiple of 64; w_fc and
// w_proj 16-byte aligned (they are copied in 16-byte pieces).
int mlp_stream_launch(const float* x, const float* ln_g, const float* ln_b,
                      const float* w_fc, const float* b_fc, const float* w_proj,
                      const float* b_proj, float* out, int M, int width, int D4,
                      float eps, void* stream) {
  if (M < 1 || D4 < kChunk || D4 % kChunk != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CLIP_PPO_MLP_STREAM_CASE(W) \
  case W:                           \
    return launch<W>(x, ln_g, ln_b, w_fc, b_fc, w_proj, b_proj, out, M, D4, eps, st);
  switch (width) {
    CLIP_PPO_MLP_STREAM_CASE(128)
    CLIP_PPO_MLP_STREAM_CASE(256)
    CLIP_PPO_MLP_STREAM_CASE(384)
    CLIP_PPO_MLP_STREAM_CASE(512)
    CLIP_PPO_MLP_STREAM_CASE(640)
    CLIP_PPO_MLP_STREAM_CASE(768)
    CLIP_PPO_MLP_STREAM_CASE(896)
    CLIP_PPO_MLP_STREAM_CASE(1024)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CLIP_PPO_MLP_STREAM_CASE
}

}  // extern "C"
