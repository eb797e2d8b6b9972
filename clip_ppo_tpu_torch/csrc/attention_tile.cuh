// The attention tile shared by K4/K8 (csrc/fused_qkv.cu) and the attention
// halves K2 and K6 (csrc/attn_half.cuh): softmax attention of the query rows of one (batch,
// head) against all keys, in tiles of 64 keys with an online softmax, Dh = 64,
// float32, optionally causal, both products on the tensor cores in 3xTF32.
//
// Replaces the bodies of clip_ppo_tpu/models/clip/pallas_attention.py::
// _fused_qkv_kernel (:91, entry fused_qkv_attention) and ::_attn_kernel (:391,
// entry packed_attention); K2 and K6 run it as their attention stage.
//
// Bound on Hopper. At ViT-L/14's vision tower ([256, 257, 3 x 1024], 16 heads)
// the scores and the weighted sum are 2 * 2 * B * T^2 * D = 69.3 GFLOP; in
// 3xTF32 that is 208 GFLOP of tensor-core work, 0.42 ms at the 495 TFLOP/s
// TF32 peak, against 4 * B * T * D * 4 = 1.08 GB of q, k, v read and output
// written, 0.32 ms at 3.35 TB/s: bound by operations. At ViT-B/32's
// [64, 50, 12 heads] the work is 0.12 GFLOP against 39 MB: bound by bytes.
//
// Numerics. A TF32 operand keeps 10 mantissa bits, so one TF32 pass misses
// the full-fp32 tolerance of the card check (1e-4 x max(1, max |ref|)) at
// unit-variance inputs. Each fp32 operand x is split into big and small and
// each product is accumulated as a_small * b_big + a_big * b_small (into two
// accumulators of their own) + a_big * b_big, the small sums added last. The
// H100's tensor core reads only the top 19 bits of a .tf32 operand (it
// ignores the low 13: a probe that fed it fp32 bits got them truncated), so
// the split needs no rounding instruction: big is x's own bits, read as
// trunc(x), and small is x - trunc(x), exact in fp32 (one LOP3 and one FADD),
// read as trunc(x - trunc(x)). cvt.rna.tf32.f32, the rounding the first
// design named, is no single instruction on sm_90a (ptxas expands it into
// compares, adds and selects) and made the kernel slower. With truncation
// the three passes keep about 20 bits, with rounding 21:
// tests/port/test_torch_tf32_split.py emulates both schemes, and one pass,
// against float64. The softmax runs in fp32 on the accumulators.
//
// Design, and what it does about the bound:
// * Warps and tiles. A warp owns 16 query rows (the m16 of
//   mma.sync.m16n8k8.tf32); a block owns rows = 16 * ceil(T / (16 q_tiles))
//   query rows of one (batch, head), q_tiles = ceil(T / 96), so at most 6
//   warps and no mostly-empty last tile (T = 257: three blocks of 96 rows,
//   not five of 64 with a 1-row fifth; T = 77: one block of 80). Each warp
//   holds its pre-scaled q as big and small A fragments in registers for the
//   whole key walk (64 registers), the scores of a key tile as 8 C fragments
//   (32) and its output as 8 C fragments (32). The launch bounds cap a
//   thread at 168 registers, so two blocks of 6 warps share an SM (one block
//   at the 190-odd registers the compiler takes uncapped); ptxas spills
//   nothing at that cap.
// * K/V staging. The key tiles ([64 keys x 64] of k and of v) go through a
//   two-stage cp.async.cg ring in shared memory: tile i + 1 is in flight
//   while tile i's products run. Rows past T are zero-filled by cp.async's
//   source-size operand, so no garbage reaches a product (0 * NaN).
// * Free index maps instead of a fragment shuffle. A sum over an index does
//   not care which k-position of the mma a term takes, as long as both
//   operands agree. In P . V the C fragment of the scores (columns 2(lane%4)
//   and 2(lane%4)+1 of each 8-key group) is used as the A fragment of P as it
//   lies, by giving k-position t the key 2t and k-position t + 4 the key
//   2t + 1; v's B fragment reads the same keys. The head dimension of q . k
//   and the output columns of P . V are permuted alike, so that every lane
//   reads its k and v operands as 16-byte vectors: k row (key) lane/4,
//   columns 8(lane%4) + {0..7, 32..39}; v rows (keys) 2(lane%4) + {0, 1},
//   columns 4(lane/4) + {0..3, 32..35}. With a row stride of 68 floats
//   (4 mod 32) both are free of bank conflicts, and the output comes out as
//   16-byte runs too.
// * Softmax in the accumulator layout. A row's scores lie across the 4 lanes
//   of a quad: the row max is reduced with __shfl_xor_sync over 1 and 2 for
//   every tile; the row sum is kept per lane and reduced once at the end.
//   Exponents are ex2.approx of s * log2(e) - m * log2(e) by one FMA, with the
//   running max kept in log2 units so every rescale uses the same rounded m.
// * Edges. Keys past T, and (causal) keys past the row, get -inf before the
//   max. Key 0 is seen by every row, so the max is finite from the first tile
//   on. A warp whose rows are all past T, or (causal) all before the tile's
//   first key, skips the tile's products; so do groups of 8 keys past T or
//   (causal) past the warp's last row. The warp still takes its part in the
//   copies and barriers.
//
// The element type of q, k, v and the output is a template parameter; only
// float is instantiated (a bf16 one takes m16n8k16 and its own fragments).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace attention_tile {

using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

constexpr int kHeadDim = 64;
constexpr int kKeys = 64;        // keys per tile
constexpr int kWarpRows = 16;    // query rows per warp
constexpr int kMaxRows = 96;     // query rows per block at most (6 warps)
constexpr int kMinBlocks = 2;    // blocks per SM the registers must allow
constexpr int kStride = 68;      // row stride (floats) of the k and v tiles in shared memory
constexpr int kTileFloats = kKeys * kStride;
constexpr int kSmemFloats = 2 * 2 * kTileFloats;  // two stages of k and v
constexpr float kScale = 0.125f;                  // 1 / sqrt(kHeadDim), exact
constexpr float kLog2e = 1.4426950408889634f;

// Four consecutive elements of the tensor type <-> a float4.
template <typename scalar_t>
struct Vec;

template <>
struct Vec<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

// Element strides of each operand: batch, token, head (the last dimension is
// contiguous). rows and q_tiles are set by launch().
template <typename scalar_t>
struct Args {
  const scalar_t* q;
  const scalar_t* k;
  const scalar_t* v;
  scalar_t* o;
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh, ob, ot, oh;
  int T, H, rows, q_tiles, causal;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// x = big + small to about 20 bits as the tensor core reads them (the top 19
// bits of each): big = x, read as trunc(x); small = x - trunc(x), exact.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x);
  small = __float_as_uint(tf32x3::small_part(x));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a * b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), d 16 x 8.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32, the small terms first, each product into its own
// accumulator: d_sb += a_small * b_big, d_bs += a_big * b_small,
// d += a_big * b_big. Passing d for all three sums in place; separate
// accumulators let a long sum run as three independent chains of products.
// b0 and b1 are split here.
__device__ __forceinline__ void mma3(float (&d)[4], float (&d_sb)[4], float (&d_bs)[4],
                                     const uint32_t (&a_big)[4], const uint32_t (&a_small)[4],
                                     float b0, float b1) {
  uint32_t b0_big, b0_small, b1_big, b1_small;
  split(b0, b0_big, b0_small);
  split(b1, b1_big, b1_small);
  mma(d_sb, a_small, b0_big, b1_big);
  mma(d_bs, a_big, b0_small, b1_small);
  mma(d, a_big, b0_big, b1_big);
}

__device__ __forceinline__ float elem(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename scalar_t>
__global__ void __launch_bounds__(kMaxRows / kWarpRows * 32, kMinBlocks) attention_kernel(const Args<scalar_t> a) {
  static_assert(sizeof(scalar_t) == sizeof(float), "only float is instantiated");
  extern __shared__ __align__(16) float smem[];

  const int T = a.T;
  const int tile = blockIdx.x % a.q_tiles;
  const int bh = blockIdx.x / a.q_tiles;
  const int h = bh % a.H, b = bh / a.H;
  const int q0 = tile * a.rows;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + (tid >> 5) * kWarpRows;  // the warp's rows: row0 .. row0 + 15

  const scalar_t* qg = a.q + b * a.qb + h * a.qh;
  const scalar_t* kg = a.k + b * a.kb + h * a.kh;
  const scalar_t* vg = a.v + b * a.vb + h * a.vh;
  scalar_t* og = a.o + b * a.ob + h * a.oh;

  const int last_row = min(q0 + a.rows, T) - 1;
  const int key_end = a.causal ? last_row + 1 : T;
  const int n_tiles = (key_end + kKeys - 1) / kKeys;

  // Tile i of k and v into stage i % 2: 16 copies of 16 bytes per row.
  auto load_tile = [&](int i) {
    float* ks = smem + (i & 1) * 2 * kTileFloats;
    const int k0 = i * kKeys;
    for (int e = tid; e < 2 * kKeys * (kHeadDim / 4); e += nthreads) {
      const int is_v = e >= kKeys * (kHeadDim / 4);
      const int r = (e >> 4) & (kKeys - 1), c = (e & 15) * 4;
      const int key = k0 + r < T ? k0 + r : 0;
      const scalar_t* src = is_v ? vg + key * a.vt : kg + key * a.kt;
      cp_async16(ks + is_v * kTileFloats + r * kStride + c, src + c, k0 + r < T ? 16 : 0);
    }
  };
  load_tile(0);
  cp_async_commit();

  // q * scale as big and small A fragments. k-step kk = 4 hh + p reads
  // head dimensions 32 hh + 8 t + 2 p (k-position t) and + 1 (k-position
  // t + 4); rows g (a0, a2) and g + 8 (a1, a3).
  uint32_t q_big[8][4], q_small[8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x[8];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (row < T) val = Vec<scalar_t>::load(qg + row * a.qt + 32 * hh + 8 * t + 4 * u);
        x[4 * u + 0] = val.x * kScale;
        x[4 * u + 1] = val.y * kScale;
        x[4 * u + 2] = val.z * kScale;
        x[4 * u + 3] = val.w * kScale;
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        split(x[2 * p], q_big[4 * hh + p][half], q_small[4 * hh + p][half]);
        split(x[2 * p + 1], q_big[4 * hh + p][2 + half], q_small[4 * hh + p][2 + half]);
      }
    }
  }

  // o[n]: output columns 8 t + 32 (n / 4) + n % 4 (c0, c2) and + 4 (c1, c3) of
  // rows g (c0, c1) and g + 8 (c2, c3). m in log2 units; l per lane.
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile i has landed (this thread's copies) ...
    __syncthreads();     // ... and everyone's
    const int k0 = i * kKeys;
    // Warp-uniform: rows past T, or (causal) rows that see no key of the tile.
    const bool active = row0 < T && !(a.causal && k0 > row0 + kWarpRows - 1);
    if (active) {
      const float* ks = smem + (i & 1) * 2 * kTileFloats;
      const float* vs = ks + kTileFloats;
      int kn = min(kKeys, key_end - k0);  // keys of the tile that a row of the warp may see
      if (a.causal) kn = min(kn, row0 + kWarpRows - k0);
      const int jn = (kn + 7) >> 3;  // groups of 8 keys with work

      // -- s[j] = (q * scale) . k for keys k0 + 8 j + 2 t + {0, 1} ------------
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        if (j < jn) {
          const float* kr = ks + (8 * j + g) * kStride + 8 * t;
          const float4 kv[2][2] = {{ld4(kr), ld4(kr + 4)}, {ld4(kr + 32), ld4(kr + 36)}};
          float s_sb[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s_bs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int p = 0; p < 4; ++p)
              mma3(s[j], s_sb, s_bs, q_big[4 * hh + p], q_small[4 * hh + p],
                   elem(kv[hh][p >> 1], 2 * (p & 1)), elem(kv[hh][p >> 1], 2 * (p & 1) + 1));
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += s_sb[e] + s_bs[e];
        }
      }

      // -- mask, row max over the quad, rescale ----------------------------
      if (k0 + kKeys > T || (a.causal && k0 + kKeys - 1 > row0)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) if (j < jn) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int row = row0 + g + 8 * (e >> 1);
            if (key >= T || (a.causal && key > row)) s[j][e] = -INFINITY;
          }
      }
      float m_new[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < jn) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // Finite from the first tile on: key 0 is seen by every row.
        m_new[r] = fmaxf(m[r], mx * kLog2e);
        const float alpha = ex2(m[r] - m_new[r]);
        m[r] = m_new[r];
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
      }

      // -- o += p . v, p = exp(s - m) as the A fragment it already is --------
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < jn) {
          float pr[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pr[e] = ex2(fmaf(s[j][e], kLog2e, -m_new[e >> 1]));
            l[e >> 1] += pr[e];
          }
          // k-position t <-> key 8 j + 2 t, t + 4 <-> key 8 j + 2 t + 1.
          uint32_t p_big[4], p_small[4];
          split(pr[0], p_big[0], p_small[0]);
          split(pr[2], p_big[1], p_small[1]);
          split(pr[1], p_big[2], p_small[2]);
          split(pr[3], p_big[3], p_small[3]);
          const float* v0 = vs + (8 * j + 2 * t) * kStride + 4 * g;
          const float4 vv[2][2] = {{ld4(v0), ld4(v0 + 32)},
                                   {ld4(v0 + kStride), ld4(v0 + kStride + 32)}};
#pragma unroll
          for (int n = 0; n < 8; ++n)
            mma3(o[n], o[n], o[n], p_big, p_small, elem(vv[0][n >> 2], n & 3),
                 elem(vv[1][n >> 2], n & 3));
        }
      }
    }
    __syncthreads();  // stage i % 2 is consumed before tile i + 2 is copied into it
  }

  if (row0 >= T) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
    const float inv = 1.0f / l[r];
    scalar_t* out = og + row * a.ot + 8 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = 4 * hh;
      Vec<scalar_t>::store(out + 32 * hh,
                           make_float4(o[n][2 * r] * inv, o[n + 1][2 * r] * inv,
                                       o[n + 2][2 * r] * inv, o[n + 3][2 * r] * inv));
      Vec<scalar_t>::store(out + 32 * hh + 4,
                           make_float4(o[n][2 * r + 1] * inv, o[n + 1][2 * r + 1] * inv,
                                       o[n + 2][2 * r + 1] * inv, o[n + 3][2 * r + 1] * inv));
    }
  }
}

// Sizes the query tile by T and launches. Returns a cudaError_t.
template <typename scalar_t>
int launch(Args<scalar_t> a, int B, cudaStream_t st) {
  if (B == 0 || a.T == 0) return static_cast<int>(cudaSuccess);
  a.q_tiles = (a.T + kMaxRows - 1) / kMaxRows;
  const int per_tile = kWarpRows * a.q_tiles;
  a.rows = kWarpRows * ((a.T + per_tile - 1) / per_tile);
  const long long blocks = static_cast<long long>(B) * a.H * a.q_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<scalar_t>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_kernel<scalar_t><<<static_cast<unsigned>(blocks), a.rows / kWarpRows * 32, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attention_tile
