// K4 and K8: multi-head softmax attention, float32 in and out, the products
// on the tensor cores in 3xTF32 (about 20 bits, see attention_tile.cuh):
//   out[b, i, h, :] = sum_j softmax_j((q[b, i, h, :] * scale) . k[b, j, h, :]) v[b, j, h, :]
// with scale = 1/sqrt(64), the row max subtracted before the exponent, and,
// when asked, the causal mask (key j > query i gets -inf, as the reference's
// additive mask gives).
//
// Replaces:
//   K4 clip_ppo_tpu/models/clip/pallas_attention.py::_fused_qkv_kernel (entry
//      fused_qkv_attention): q, k and v read straight from the packed
//      [B, T, 3D] qkv projection at column offsets 0, D and 2D of each row of
//      3D; output [B, T, D] (fused_qkv_launch).
//   K8 pallas_attention.py::_attn_kernel (entry packed_attention): q, k, v as
//      [B, T, H, 64] tensors with their own strides (views of one qkv buffer
//      on the main path, so nothing is copied), no mask; output contiguous
//      [B, T, H, 64] (packed_attention_launch).
// Both compute one function, so one kernel body serves both: the entry
// points differ only in the pointers and strides they pass.
//
// Bound on Hopper: operations at ViT-L/14, bytes at ViT-B/32. At ViT-L/14's
// vision tower, [256, 257, 3 x 1024] with 16 heads, the scores and the
// weighted sum are 2 * 2 * B * T^2 * D = 69.3 GFLOP, run on the tensor cores
// in 3xTF32 (three TF32 products per fp32 product, 208 GFLOP: 0.42 ms at 495
// TFLOP/s), against 4 * B * T * D * 4 = 1.08 GB of q, k and v read and output
// written (0.32 ms at 3.35 TB/s).
//
// What the TPU kernel keeps out of device memory, and how this one does it:
// the [B, H, T, T] scores and the head-split copies of q, k and v never exist
// in device memory. A block owns up to 96 query rows of one (batch, head),
// 16 a warp, held in registers as tensor-core fragments, and walks the keys
// in tiles of 64 rows of k and v, staged in shared memory through a
// two-stage cp.async ring, with an online softmax (a running row max m and
// row sum l; each tile rescales the partial output by exp(m_old - m_new)), so
// T is not bounded by shared memory. The TPU kernel's 128-lane head pairs,
// lane masks and row stacking are layout devices of its matrix unit and have
// no counterpart here. The body, its numerics and its layouts are described
// in attention_tile.cuh, which K2 and K6 (attn_half.cuh) include as well.

#include "attention_tile.cuh"

using attention_tile::Args;
using attention_tile::kHeadDim;
using attention_tile::launch;

extern "C" {

// K4. qkv: [B, T, 3 * H * 64] (q | k | v along the last axis), out:
// [B, T, H * 64], both contiguous and 16-byte aligned.
int fused_qkv_launch(const float* qkv, float* out, int B, int T, int H, int causal,
                     void* stream) {
  if (B < 0 || T < 0 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long D = static_cast<long long>(H) * kHeadDim;
  Args<float> a;
  a.q = qkv;
  a.k = qkv + D;
  a.v = qkv + 2 * D;
  a.o = out;
  a.qb = a.kb = a.vb = T * 3 * D;
  a.qt = a.kt = a.vt = 3 * D;
  a.qh = a.kh = a.vh = kHeadDim;
  a.ob = T * D;
  a.ot = D;
  a.oh = kHeadDim;
  a.T = T;
  a.H = H;
  a.causal = causal != 0;
  return launch(a, B, static_cast<cudaStream_t>(stream));
}

// K8. q, k, v: [B, T, H, 64] with element strides (batch, token, head) each,
// the last dimension contiguous, every row 16-byte aligned; out: contiguous
// [B, T, H, 64]. No mask.
int packed_attention_launch(const float* q, const float* k, const float* v, float* out, int B,
                            int T, int H, long long qb, long long qt, long long qh,
                            long long kb, long long kt, long long kh, long long vb,
                            long long vt, long long vh, void* stream) {
  if (B < 0 || T < 0 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args<float> a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.qb = qb;
  a.qt = qt;
  a.qh = qh;
  a.kb = kb;
  a.kt = kt;
  a.kh = kh;
  a.vb = vb;
  a.vt = vt;
  a.vh = vh;
  a.ot = static_cast<long long>(H) * kHeadDim;
  a.ob = T * a.ot;
  a.oh = kHeadDim;
  a.T = T;
  a.H = H;
  a.causal = 0;
  return launch(a, B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
