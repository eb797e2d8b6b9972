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
//
// bf16 (fused_qkv_bf16_launch, packed_attention_bf16_launch): the encoder
// benchmark's default dtype runs ViT-L/14's vision tower in bfloat16, where
// the TPU routing still sends its D = 1024 attention to K4 (K8 under
// --attention-impl pallas). The same entry points on bf16 q, k, v and out
// fill attention_tile::Args<__nv_bfloat16>, and launch() picks
// attention_bf16_kernel, the body K2's bf16 stage runs: mma.sync m16n8k16
// with fp32 accumulators, the scores and the softmax in fp32, P rounded to
// bf16 before P . V, the output rounded to bf16, as the TPU kernel rounds
// with bf16 q, k and v (pallas_attention.py:151, 162). Its rows are read as
// 16-byte vectors of 8 bf16, so every stride is a multiple of 8 elements.
// Bound: at [256, 257, 3 x 1024] the 69.3 GFLOP take 0.070 ms at the dense
// bf16 peak, 989 TFLOP/s, against 4 * B * T * D * 2 = 539 MB of q, k, v read
// and output written, 0.161 ms at 3.35 TB/s: bound by bytes.

#include <cuda_bf16.h>

#include "attention_tile.cuh"

using attention_tile::Args;
using attention_tile::kHeadDim;
using attention_tile::launch;

namespace {

// K4 on Elem (float or __nv_bfloat16): q, k and v at column offsets 0, D and
// 2D of each packed row of 3D.
template <typename Elem>
int fused_qkv(const Elem* qkv, Elem* out, int B, int T, int H, int causal, void* stream) {
  if (B < 0 || T < 0 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long D = static_cast<long long>(H) * kHeadDim;
  Args<Elem> a;
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

// K8 on Elem: q, k, v with their own (batch, token, head) strides, no mask.
template <typename Elem>
int packed_attention(const Elem* q, const Elem* k, const Elem* v, Elem* out, int B, int T, int H,
                     long long qb, long long qt, long long qh, long long kb, long long kt,
                     long long kh, long long vb, long long vt, long long vh, void* stream) {
  if (B < 0 || T < 0 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args<Elem> a;
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

}  // namespace

extern "C" {

// K4. qkv: [B, T, 3 * H * 64] (q | k | v along the last axis), out:
// [B, T, H * 64], both contiguous and 16-byte aligned.
int fused_qkv_launch(const float* qkv, float* out, int B, int T, int H, int causal,
                     void* stream) {
  return fused_qkv(qkv, out, B, T, H, causal, stream);
}

// As fused_qkv_launch, in bfloat16.
int fused_qkv_bf16_launch(const __nv_bfloat16* qkv, __nv_bfloat16* out, int B, int T, int H,
                          int causal, void* stream) {
  return fused_qkv(qkv, out, B, T, H, causal, stream);
}

// K8. q, k, v: [B, T, H, 64] with element strides (batch, token, head) each,
// the last dimension contiguous, every row 16-byte aligned; out: contiguous
// [B, T, H, 64]. No mask.
int packed_attention_launch(const float* q, const float* k, const float* v, float* out, int B,
                            int T, int H, long long qb, long long qt, long long qh,
                            long long kb, long long kt, long long kh, long long vb,
                            long long vt, long long vh, void* stream) {
  return packed_attention(q, k, v, out, B, T, H, qb, qt, qh, kb, kt, kh, vb, vt, vh, stream);
}

// As packed_attention_launch, in bfloat16; every stride a multiple of 8.
int packed_attention_bf16_launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                 const __nv_bfloat16* v, __nv_bfloat16* out, int B, int T, int H,
                                 long long qb, long long qt, long long qh, long long kb,
                                 long long kt, long long kh, long long vb, long long vt,
                                 long long vh, void* stream) {
  return packed_attention(q, k, v, out, B, T, H, qb, qt, qh, kb, kt, kh, vb, vt, vh, stream);
}

}  // extern "C"
