// K1: the batched-semantics disturbance, noise -> contrast -> blur -> cutout,
// with each image split over a thread-block cluster.
//
// Replaces: clip_ppo_tpu/ops/pallas_disturb.py::_disturb_kernel (entry
// disturb_pallas). Same function: Gaussian noise clamped to [0,1]; contrast
// blend toward the per-image luma mean (channel mean when C != 3) with one
// factor for the batch; separable Gaussian blur with BORDER_REFLECT_101; one
// cutout rectangle shared by the batch.
//
// Bound on Hopper: bytes. Per image the function reads H*W*C floats and writes
// as many, about 85 KB at 84x84x3, and does a few dozen flops per element, so
// the least time for the rollout's [8,84,84,3] batch is well under a
// microsecond: a launch costs more. What a design can lose is parallelism.
// One block per image, the first CUDA K1, ran 8 blocks on the card's 132
// SMs, each drawing its image's noise and running both blur passes alone.
//
// Design: one cluster of n CTAs per image (grid n x B, cluster n x 1; n = 16
// by default, past the portable 8, so 8 images fill 128 SMs). CTA r owns a
// band of ceil(H / n) rows (the last band may be ragged or empty) and holds
// it in shared memory with a halo of ksize / 2 rows on each side, in x's
// own NHWC order, from its one read of x to its one write of out:
//   1. noise and clamp for the band's rows, and their luma sum (channel sum
//      when C != 3) into one float in shared memory;
//   2. cluster barrier; every CTA reads the n partial sums through
//      distributed shared memory in rank order, so every CTA computes the
//      same mean, and copies its halo rows, after noise and clamp, from the
//      CTAs that own them (several, where a band is thinner than the halo);
//   3. the vertical pass over the band's rows, the contrast blend applied to
//      each tap as it loads (the rows it reads are its neighbours' too, so
//      nobody writes them after the barrier), reflect-101 at the image's
//      edges, into a second buffer; then the horizontal pass, the cutout and
//      the write;
//   4. a second cluster barrier before exit: a CTA's shared memory must
//      outlive its neighbours' reads (they arrive once read, and wait at the
//      end, so nobody waits in between).
// The halo is exchanged, not recomputed. A first version of this design
// drew the halo rows' noise again in each CTA (2 x 2 rows on each 6-row
// band at HARD, 1.67x the draws), its threads drawing one normal after
// another behind dependent loads: 0.0158 ms of device time at [8,84,84,3]
// on an H100 80GB HBM3 (700 W), against 0.0095 for this one. The copy
// rides on the barrier the mean needs anyway. What is left is latency (8
// and 16 CTAs an image take the same time there), so every scalar is read
// up front. Every pass walks its rows flat, thread t taking elements t,
// t + kThreads, ..., with the row, the position in the row and the channel
// carried from step to step (Walk, Chan): no division per element. The
// noise is either read from an input tensor (exact parity with a
// reference) or drawn in the kernel from a counter-based Philox4x32-10
// keyed by (seed, image) with the NHWC element index as counter. The
// contrast factor, the seed and the cutout origin are read from device
// memory, so the caller never synchronises to pass them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Threads a CTA: 256 and 1,024 were no faster on an H100 at [8,84,84,3]
constexpr int kThreads = 512;
constexpr int kMaxTaps = 31;
constexpr int kMaxHalf = kMaxTaps / 2;
constexpr int kMaxCluster = 16;  // CTAs a cluster, non-portable past 8
constexpr int kSmemLimit = 232448 - 1024;  // dynamic shared memory a CTA may take

// Luma weights of torchvision's rgb_to_grayscale.
__device__ __forceinline__ float luma(int c) {
  return c == 0 ? 0.2989f : (c == 1 ? 0.587f : 0.114f);
}

__device__ __forceinline__ void philox_round(uint32_t (&c)[4], uint32_t (&k)[2]) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  uint32_t hi0 = __umulhi(M0, c[0]), lo0 = M0 * c[0];
  uint32_t hi1 = __umulhi(M1, c[2]), lo1 = M1 * c[2];
  uint32_t n0 = hi1 ^ c[1] ^ k[0];
  uint32_t n2 = hi0 ^ c[3] ^ k[1];
  c[0] = n0; c[1] = lo1; c[2] = n2; c[3] = lo0;
  k[0] += 0x9E3779B9u;
  k[1] += 0xBB67AE85u;
}

// One standard normal for element `idx` of image `img`: Philox4x32-10 on
// counter (idx, 0, 0, 0) with key (seed, img), Box-Muller on two outputs.
__device__ __forceinline__ float philox_normal(uint32_t seed, uint32_t img, uint32_t idx) {
  uint32_t c[4] = {idx, 0u, 0u, 0u};
  uint32_t k[2] = {seed, img};
#pragma unroll
  for (int r = 0; r < 10; ++r) philox_round(c, k);
  const float inv = 1.0f / 4294967296.0f;
  float u1 = (static_cast<float>(c[0]) + 0.5f) * inv;  // (0, 1)
  float u2 = (static_cast<float>(c[1]) + 0.5f) * inv;
  u1 = fminf(u1, 1.0f - 1e-7f);
  return sqrtf(-2.0f * logf(u1)) * cospif(2.0f * u2);
}

// One reflection: valid for i in [-(n - 1), 2n - 2], which ksize / 2 < n gives.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Thread t's elements t, t + kThreads, ... of a region of rows `wc` floats
// long, as (row r, position q in the row), carried from step to step.
struct Walk {
  int r, q, dr, dq, wc;
  __device__ explicit Walk(int wc_) : wc(wc_) {
    r = static_cast<int>(threadIdx.x) / wc;
    q = static_cast<int>(threadIdx.x) - r * wc;
    dr = kThreads / wc;
    dq = kThreads - dr * wc;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    q += dq;
    if (q >= wc) {
      q -= wc;
      ++r;
    }
  }
};

// The channel c of the same elements in NHWC order (rows start at channel 0).
struct Chan {
  int c, dc, n;
  __device__ explicit Chan(int n_) : n(n_) {
    c = static_cast<int>(threadIdx.x) % n;
    dc = kThreads % n;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    if (c >= n) c -= n;
  }
};

// x, noise, out: [B, H, W, C] float32 (NHWC). seed: int32 [1], read only when
// the noise is drawn here; origin: int32 [2] = (r0, c0); factor: float32 [1];
// taps: float32 [ksize]. Grid (n, B), cluster (n, 1, 1), kThreads threads;
// band = ceil(H / n) rows a CTA; dynamic shared memory W * C * (2 band +
// 2 (ksize / 2)) floats.
__global__ void __launch_bounds__(kThreads) disturb_kernel(
    const float* __restrict__ x, const float* __restrict__ noise,
    const int32_t* __restrict__ seed_p, const int32_t* __restrict__ origin,
    const float* __restrict__ factor_p, const float* __restrict__ taps_g,
    float* __restrict__ out, int H, int W, int C, float sigma, int ksize, int ph, int pw,
    int band) {
  extern __shared__ float smem[];
  __shared__ float taps[kMaxTaps];
  __shared__ float red[kThreads / 32];
  __shared__ float partial;  // this band's luma sum, read by the whole cluster
  __shared__ float mean_s;
  __shared__ const float* halo_src[2 * kMaxHalf];  // a halo row in its owner's memory
  __shared__ int halo_dst[2 * kMaxHalf];           // and its row in `a`

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = static_cast<int>(cluster.num_blocks());
  const int img = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = ksize / 2;
  const int wc = W * C;                                        // floats a row
  const int r0 = min(rank * band, H), r1 = min(r0 + band, H);  // own rows [r0, r1)
  const int lo = r1 > r0 ? max(r0 - half, 0) : r0;             // held rows [lo, hi)
  const int hi = r1 > r0 ? min(r1 + half, H) : r0;
  float* a = smem;                             // [band + 2 half][W][C], rows from lo
  float* bv = smem + (band + 2 * half) * wc;   // [band][W][C] after the vertical pass
  const size_t img_off = static_cast<size_t>(img) * H * wc;
  const int e0 = r0 * wc;   // the band's first element in the image
  const int own = (r1 - r0) * wc;
  // Every scalar read up front, beside x: after a barrier each would be a
  // round trip of its own.
  const bool draw = noise == nullptr && sigma > 0.0f;
  const uint32_t seed = draw ? static_cast<uint32_t>(seed_p[0]) : 0u;
  const float f = factor_p[0];
  const int cr = origin[0], cc = origin[1];
  if (tid < ksize) taps[tid] = taps_g[tid];

  // -- 1. noise, clamped, over the band; its luma partial sum ----------------
  {
    const float* xb = x + img_off + e0;
    const float* nb = noise ? noise + img_off + e0 : nullptr;
    float* ab = a + (r0 - lo) * wc;
    float part = 0.0f;
    Chan ch(C);
#pragma unroll 4
    for (int i = tid; i < own; i += kThreads, ch.next()) {
      float v = xb[i];
      if (sigma > 0.0f) {
        const float z = draw ? philox_normal(seed, static_cast<uint32_t>(img),
                                             static_cast<uint32_t>(e0 + i))
                             : nb[i];
        v = fminf(fmaxf(v + sigma * z, 0.0f), 1.0f);
      }
      ab[i] = v;
      part += (C == 3) ? luma(ch.c) * v : v;
    }
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) red[warp] = part;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int i = 0; i < kThreads / 32; ++i) s += red[i];
    partial = s;
  }

  // -- 2. the image's mean and the halo rows, from the other CTAs ------------
  cluster_arrive();
  cluster_wait();
  const int ntop = r0 - lo, nh = ntop + (hi - r1);
  if (warp == 0) {
    const float v = lane < n ? *cluster.map_shared_rank(&partial, static_cast<unsigned>(lane)) : 0.0f;
    float s = 0.0f;
    for (int i = 0; i < n; ++i) s += __shfl_sync(0xffffffffu, v, i);
    if (lane == 0) mean_s = s / static_cast<float>(C == 3 ? H * W : H * wc);
  } else if (tid - 32 < nh) {
    const int t = tid - 32;
    const int row = t < ntop ? lo + t : r1 + (t - ntop);  // an image row, outside the band
    const int owner = row / band;
    const int owner_lo = max(owner * band - half, 0);
    halo_src[t] = cluster.map_shared_rank(a, static_cast<unsigned>(owner)) + (row - owner_lo) * wc;
    halo_dst[t] = t < ntop ? t : t + (r1 - r0);
  }
  __syncthreads();
  {
    Walk w(wc);
#pragma unroll 4
    for (int i = tid; i < nh * wc; i += kThreads, w.next())
      a[halo_dst[w.r] * wc + w.q] = halo_src[w.r][w.q];
  }
  cluster_arrive();  // done reading the other CTAs' shared memory
  __syncthreads();

  // -- 3a. blur along H over the band, the contrast blend applied on load ----
  const float g = (1.0f - f) * mean_s;
  {
    Walk w(wc);
#pragma unroll 2
    for (int i = tid; i < own; i += kThreads, w.next()) {
      const int r = r0 + w.r;
      float s = 0.0f;
      for (int k = 0; k < ksize; ++k) {
        const float v = a[(reflect101(r + k - half, H) - lo) * wc + w.q];
        s += taps[k] * fminf(fmaxf(f * v + g, 0.0f), 1.0f);
      }
      bv[i] = s;
    }
  }
  __syncthreads();

  // -- 3b. blur along W, reflect-101 on the column, cutout, write ------------
  {
    const int q_lo = cc * C, q_hi = (cc + pw) * C;  // the cutout's columns, as positions
    const int wrap = (2 * W - 2) * C;
    float* ob = out + img_off + e0;
    Walk w(wc);
    Chan ch(C);
#pragma unroll 2
    for (int i = tid; i < own; i += kThreads, w.next(), ch.next()) {
      const int r = r0 + w.r;
      const float* row = bv + w.r * wc;
      float s = 0.0f;
      for (int k = 0; k < ksize; ++k) {
        // column col + k - half of channel c, at position t; reflected about
        // column 0 (2c - t) or W - 1 ((2W - 2) C + 2c - t)
        const int t = w.q + (k - half) * C;
        const int src = t < 0 ? 2 * ch.c - t : (t >= wc ? wrap + 2 * ch.c - t : t);
        s += taps[k] * row[src];
      }
      const bool inside = r >= cr && r < cr + ph && w.q >= q_lo && w.q < q_hi;
      ob[i] = inside ? 0.0f : s;
    }
  }

  // -- 4. keep this CTA's shared memory until the cluster has read it --------
  cluster_wait();
}

// Nothing, on K1's grid and cluster: the floor a launch of K1 can reach.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

__global__ void normal_kernel(float* __restrict__ out, uint32_t seed, uint32_t img, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) out[e] = philox_normal(seed, img, static_cast<uint32_t>(e));
}

// Clusters past 8 CTAs and dynamic shared memory past 48 KB, allowed once
// per process rather than on every call.
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      disturb_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(disturb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t cluster_config(int B, int ctas, size_t smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// One cluster of `ctas` CTAs per image. seed may be NULL when noise is
// given or sigma is 0. Returns a cudaError_t.
int disturb_launch(const float* x, const float* noise, const int32_t* seed,
                   const int32_t* origin, const float* factor, const float* taps, float* out,
                   int B, int H, int W, int C, float sigma, int ksize, int ph, int pw, int ctas,
                   void* stream) {
  static const cudaError_t configured = configure();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int half = ksize / 2;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || ctas < 1 || ctas > kMaxCluster ||
      ksize < 1 || ksize > kMaxTaps || half >= H || half >= W ||
      (noise == nullptr && sigma > 0.0f && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int band = (H + ctas - 1) / ctas;
  const size_t smem = static_cast<size_t>(W) * C * (2 * band + 2 * half) * sizeof(float);
  if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(B, ctas, smem, static_cast<cudaStream_t>(stream), &attr);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, disturb_kernel, x, noise, seed, origin,
                                             factor, taps, out, H, W, C, sigma, ksize, ph, pw,
                                             band));
}

// The empty kernel on the grid and cluster disturb_launch uses for B images.
int disturb_empty_launch(int B, int ctas, void* stream) {
  static const cudaError_t configured = configure();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  if (B < 1 || B > 65535 || ctas < 1 || ctas > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(B, ctas, 0, static_cast<cudaStream_t>(stream), &attr);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, empty_kernel));
}

// The in-kernel noise stream for image `img`, for checking its distribution.
int philox_normal_launch(float* out, uint32_t seed, uint32_t img, int n, void* stream) {
  normal_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, seed, img, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
