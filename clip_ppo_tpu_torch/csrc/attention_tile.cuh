// The attention tile shared by K4/K8 (csrc/fused_qkv.cu) and K6
// (csrc/attn_stream.cu): softmax attention of 64 query rows of one (batch,
// head) against all keys, in tiles of 64 keys with an online softmax, Dh = 64,
// float32, optionally causal. Design and bounds: csrc/fused_qkv.cu.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attention_tile {

constexpr int kHeadDim = 64;
constexpr int kRows = 64;       // query rows per block
constexpr int kKeys = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr int kStride = 68;     // padded row stride of q, k and p in shared memory
constexpr float kScale = 0.125f;  // 1 / sqrt(kHeadDim), exact
constexpr int kSmemFloats = 3 * kRows * kStride + kKeys * kHeadDim;

// Four consecutive elements of the tensor type <-> a float4.
template <typename scalar_t>
struct Vec;

template <>
struct Vec<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

// Element strides of each operand: batch, token, head (the last dimension is
// contiguous).
template <typename scalar_t>
struct Args {
  const scalar_t* q;
  const scalar_t* k;
  const scalar_t* v;
  scalar_t* o;
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh, ob, ot, oh;
  int T, H, q_tiles, causal;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads) attention_kernel(const Args<scalar_t> a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [kRows][kStride], q * scale
  float* ks = qs + kRows * kStride;   // [kKeys][kStride]
  float* ps = ks + kKeys * kStride;   // [kRows][kStride], exp(s - m) of the tile
  float* vs = ps + kRows * kStride;   // [kKeys][kHeadDim]

  const int T = a.T;
  const int tile = blockIdx.x % a.q_tiles;
  const int bh = blockIdx.x / a.q_tiles;
  const int h = bh % a.H, b = bh / a.H;
  const int q0 = tile * kRows;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, warp = tid >> 5;

  const scalar_t* qg = a.q + b * a.qb + h * a.qh;
  const scalar_t* kg = a.k + b * a.kb + h * a.kh;
  const scalar_t* vg = a.v + b * a.vb + h * a.vh;
  scalar_t* og = a.o + b * a.ob + h * a.oh;

  for (int e = tid; e < kRows * (kHeadDim / 4); e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < T) {
      val = Vec<scalar_t>::load(qg + (q0 + r) * a.qt + c);
      val.x *= kScale;
      val.y *= kScale;
      val.z *= kScale;
      val.w *= kScale;
    }
    st4(qs + r * kStride + c, val);
  }

  const int last_row = min(q0 + kRows, T) - 1;
  const int warp_row0 = q0 + warp * 8;  // the warp's rows: warp_row0 .. warp_row0 + 7
  const int key_end = a.causal ? last_row + 1 : T;

  float m[4], l[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < key_end; k0 += kKeys) {
    __syncthreads();  // the last tile's k, v and p are consumed
    for (int e = tid; e < kKeys * (kHeadDim / 4); e += kThreads) {
      const int r = e >> 4, c = (e & 15) * 4;
      float4 kv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vv = kv;
      if (k0 + r < T) {
        kv = Vec<scalar_t>::load(kg + (k0 + r) * a.kt + c);
        vv = Vec<scalar_t>::load(vg + (k0 + r) * a.vt + c);
      }
      st4(ks + r * kStride + c, kv);
      st4(vs + r * kHeadDim + c, vv);
    }
    __syncthreads();
    // Warp-uniform: rows past T, or (causal) rows that see no key of the tile.
    if (warp_row0 >= T || (a.causal && k0 > warp_row0 + 7)) continue;
    const int kn = min(kKeys, key_end - k0);  // keys of the tile that any row may see
    const int jn = (kn + 15) >> 4;            // groups of 16 keys with work

    // -- scores s[i][j] of rows 4ty + i, keys k0 + tx + 16j ------------------
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < kHeadDim; c += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = ld4(qs + (4 * ty + i) * kStride + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < jn) {
          const float4 kv = ld4(ks + (tx + 16 * j) * kStride + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i][j] = dot4(qv[i], kv, s[i][j]);
        }
      }
    }

    // -- online softmax over the tile, rows reduced across the 16 tx lanes ----
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        if (key >= T || (a.causal && key > row)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // Finite from the first tile on: key 0 is seen by every row.
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[i][j] - m_new);
        sum += p;
        ps[(4 * ty + i) * kStride + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
    }
    __syncwarp();  // p rows of this warp are written by its own lanes

    // -- o[i][:] += p[4ty + i, :] @ v[:, 4tx .. 4tx + 3] ----------------------
    const int kn4 = (kn + 3) & ~3;  // p and v are zero past kn
    for (int kk = 0; kk < kn4; kk += 4) {
      float4 vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) vv[u] = ld4(vs + (kk + u) * kHeadDim + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p = ld4(ps + (4 * ty + i) * kStride + kk);
        const float pu[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          o[i][0] = fmaf(pu[u], vv[u].x, o[i][0]);
          o[i][1] = fmaf(pu[u], vv[u].y, o[i][1]);
          o[i][2] = fmaf(pu[u], vv[u].z, o[i][2]);
          o[i][3] = fmaf(pu[u], vv[u].w, o[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= T) continue;
    const float inv = 1.0f / l[i];
    Vec<scalar_t>::store(og + row * a.ot + 4 * tx,
                         make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv));
  }
}

template <typename scalar_t>
int launch(const Args<scalar_t>& a, int B, cudaStream_t st) {
  const long long blocks = static_cast<long long>(B) * a.H * a.q_tiles;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<scalar_t>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_kernel<scalar_t><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attention_tile
