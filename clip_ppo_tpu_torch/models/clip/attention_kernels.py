"""K4 and K8: multi-head softmax attention as one hand-written CUDA kernel
body with two entry points, and their plain PyTorch versions.

Counterpart of ``clip_ppo_tpu/models/clip/pallas_attention.py``:

* :func:`fused_qkv_attention` — K4, replacing ``_fused_qkv_kernel`` (entry
  ``fused_qkv_attention`` :313): attention straight from the packed
  ``[B, T, 3·H·Dh]`` qkv projection in its natural layout, returning
  ``[B, T, H·Dh]`` ready for the output projection; optional causal mask.
  The plain version :func:`fused_qkv_attention_plain` mirrors
  ``_einsum_attention_from_qkv`` (:270).
* :func:`packed_attention` — K8, replacing ``_attn_kernel`` (entry
  ``packed_attention`` :413): softmax attention over ``[B, T, H, Dh]``
  q/k/v, no mask, returning ``[B, T, H, Dh]``. Strided views (the split of
  one qkv buffer, row stride 3D) go to the kernel as pointers and strides,
  never copied. Plain version :func:`packed_attention_plain`.

Both kernels are ``csrc/fused_qkv.cu`` (fp32, one block per 64 query rows
of one head, keys in tiles of 64 with an online softmax), for Dh = 64 — every
CLIP tower's head width — any T and any batch; the wrappers raise for any
other Dh on the GPU. The plain versions take any Dh.

The TPU tiling arguments have no counterpart and are not carried over:
``block_batches`` and ``group`` (batches and heads per VMEM block and per
matrix-unit pass), ``interpret`` (the wrappers run the plain versions for a
CPU tensor instead), and the ``CLIP_PPO_ATTN_PAIR_VARIANT`` switch between
equivalent 128-lane head-pair layouts. Each wrapper launches its kernel for a
CUDA tensor, runs its plain version for a CPU tensor, and raises for any other
device. Forward only: the JAX package's backward of K4 is an einsum recompute
(:303), not a kernel.
"""

from __future__ import annotations

import torch

from clip_ppo_tpu_torch import cuda_build

HEAD_DIM = 64


def causal_mask(t: int, device=None) -> torch.Tensor:
    """[T, T] additive mask: -inf above the diagonal."""
    return torch.triu(torch.full((t, t), float("-inf"), device=device), diagonal=1)


def fused_qkv_attention_plain(qkv: torch.Tensor, heads: int, causal: bool = False) -> torch.Tensor:
    b, t, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    q, k, v = (z.reshape(b, t, heads, dh) for z in qkv.split(d, dim=-1))
    logits = torch.einsum("bqhc,bkhc->bhqk", q / dh ** 0.5, k)
    if causal:
        logits = logits + causal_mask(t, qkv.device).to(logits.dtype)
    w = torch.softmax(logits.float(), dim=-1).to(qkv.dtype)
    return torch.einsum("bhqk,bkhc->bqhc", w, v).reshape(b, t, d)


def packed_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    logits = torch.einsum("bqhc,bkhc->bhqk", q / q.shape[-1] ** 0.5, k)
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhc->bqhc", w, v)


def _check_rows(t: torch.Tensor, strides: tuple[int, ...], name: str, what: str) -> None:
    """The kernel reads 16-byte vectors along each 64-wide row."""
    if t.dtype != torch.float32 or t.stride(-1) != 1:
        raise ValueError(f"{name}: {what} must be float32 with a contiguous last dimension")
    if t.data_ptr() % 16 or any(s % 4 for s in strides):
        raise ValueError(f"{name}: {what} must start on a 16-byte boundary with strides that "
                         f"are multiples of 4 elements (the kernel reads 16-byte vectors), "
                         f"got strides {tuple(t.stride())}")


def fused_qkv_attention(qkv: torch.Tensor, heads: int, causal: bool = False) -> torch.Tensor:
    """Attention from the packed qkv projection: ``[B, T, 3·H·Dh]`` →
    ``[B, T, H·Dh]``; ``causal`` masks key j > query i."""
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, heads, causal)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention: unsupported device {qkv.device}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError("fused_qkv_attention: qkv must be a contiguous [B, T, 3D] tensor")
    b, t, d3 = qkv.shape
    if d3 != 3 * heads * HEAD_DIM:
        raise ValueError(f"fused_qkv_attention: the kernel takes Dh = {HEAD_DIM} "
                         f"(3D = 3 x heads x {HEAD_DIM}), got 3D={d3}, heads={heads}")
    _check_rows(qkv, (d3,), "fused_qkv_attention", "qkv")
    out = torch.empty((b, t, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    cuda_build.launch("fused_qkv", "fused_qkv_launch", qkv.data_ptr(), out.data_ptr(),
                      b, t, heads, int(causal), cuda_build.stream_handle(qkv.device))
    cuda_build.LAUNCHES["fused_qkv"] += 1
    return out


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention over ``[B, T, H, Dh]`` q/k/v (no mask) →
    ``[B, T, H, Dh]``; q, k and v may be strided views."""
    if q.device.type == "cpu":
        return packed_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"packed_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"packed_attention: q, k and v must share one [B, T, H, Dh] shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("packed_attention: q, k and v must be on one device")
    b, t, h, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"packed_attention: the kernel takes Dh = {HEAD_DIM}, got {dh}")
    for name, z in (("q", q), ("k", k), ("v", v)):
        _check_rows(z, z.stride()[:3], "packed_attention", name)
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    cuda_build.launch("fused_qkv", "packed_attention_launch", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), b, t, h, *q.stride()[:3], *k.stride()[:3],
                      *v.stride()[:3], cuda_build.stream_handle(q.device))
    cuda_build.LAUNCHES["packed_attention"] += 1
    return out
