"""K2 and K3: the two halves of a pre-LN CLIP resblock as hand-written CUDA
kernels, and their plain PyTorch versions.

* :func:`attn_block` — ``x + out_proj(MHA(qkv_proj(LN1(x))))`` with fp32 LN
  statistics and an optional causal mask. Replaces
  ``clip_ppo_tpu/models/clip/pallas_block.py::_attn_block_kernel`` (entry
  ``fused_attn_block``); kernel in ``csrc/attn_block.cu``. The [B, T, 3D]
  qkv never reaches device memory; the [B, T, D] attention output does,
  between the kernel's two launches.
* :func:`mlp_block` — ``x + proj(QuickGELU(fc(LN2(x))))``. Replaces
  ``pallas_block.py::_mlp_block_kernel`` (entry ``fused_mlp_block``);
  kernel in ``csrc/mlp_block.cu``. The [B, T, 4D] hidden never reaches
  device memory.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version (which mirrors ``_attn_block_ref`` / ``_mlp_block_ref``) for a CPU
tensor. Forward only: the text table is built under ``torch.no_grad()``.
The primitives the plain versions are built from (``layer_norm``,
``quick_gelu``, ``attention``) are the model's own.
"""

from __future__ import annotations

import torch

from clip_ppo_tpu_torch import cuda_build

HEAD_DIM = 64


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics regardless of compute dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def causal_mask(t: int, device=None) -> torch.Tensor:
    """[T, T] additive mask: -inf above the diagonal."""
    return torch.triu(torch.full((t, t), float("-inf"), device=device), diagonal=1)


def attention(p: dict, x: torch.Tensor, heads: int, causal: bool = False) -> torch.Tensor:
    """Multi-head self-attention with a fused qkv projection (einsum MHA)."""
    b, t, d = x.shape
    dh = d // heads
    qkv = x @ p["in_proj_w"].to(x.dtype).T + p["in_proj_b"].to(x.dtype)
    q, k, v = qkv.split(d, dim=-1)
    q = q.reshape(b, t, heads, dh)
    k = k.reshape(b, t, heads, dh)
    v = v.reshape(b, t, heads, dh)
    logits = torch.einsum("bqhc,bkhc->bhqk", q / dh ** 0.5, k)
    if causal:
        logits = logits + causal_mask(t, x.device).to(logits.dtype)
    w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhc->bqhc", w, v).reshape(b, t, d)
    return out @ p["out_proj_w"].to(x.dtype).T + p["out_proj_b"].to(x.dtype)


def attn_block_plain(x: torch.Tensor, ln1: dict, attn: dict, heads: int,
                     causal: bool = False, eps: float = 1e-5) -> torch.Tensor:
    return x + attention(attn, layer_norm(ln1, x, eps), heads, causal)


def mlp_block_plain(x: torch.Tensor, ln2: dict, mlp: dict,
                    eps: float = 1e-5) -> torch.Tensor:
    h = layer_norm(ln2, x, eps)
    h = quick_gelu(h @ mlp["fc_w"].T + mlp["fc_b"])
    return x + (h @ mlp["proj_w"].T + mlp["proj_b"])


def _check(x: torch.Tensor, weights: dict, name: str) -> None:
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous float32 [B, T, D] tensor")
    for key, w in weights.items():
        if w.device != x.device or w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous float32 tensor on {x.device}")


def attn_block(x: torch.Tensor, ln1: dict, attn: dict, heads: int,
               causal: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """``x + out_proj(MHA(qkv_proj(LN1(x))))``; ``ln1``/``attn`` are the
    resblock's ``ln_1``/``attn`` dicts (in_proj_w [3D, D], out_proj_w [D, D])."""
    if x.device.type == "cpu":
        return attn_block_plain(x, ln1, attn, heads, causal, eps)
    if x.device.type != "cuda":
        raise ValueError(f"attn_block: unsupported device {x.device}")
    b, t, d = x.shape
    weights = {"ln_1.scale": ln1["scale"], "ln_1.bias": ln1["bias"], **attn}
    _check(x, weights, "attn_block")
    if d != heads * HEAD_DIM or t > 80:
        raise ValueError(f"attn_block: needs head width {HEAD_DIM} and T <= 80, got D={d}, "
                         f"heads={heads}, T={t}")
    scratch = torch.empty_like(x)  # attention output, before out_proj
    out = torch.empty_like(x)
    cuda_build.launch(
        "attn_block", "attn_block_launch",
        x.data_ptr(), ln1["scale"].data_ptr(), ln1["bias"].data_ptr(),
        attn["in_proj_w"].data_ptr(), attn["in_proj_b"].data_ptr(),
        attn["out_proj_w"].data_ptr(), attn["out_proj_b"].data_ptr(),
        scratch.data_ptr(), out.data_ptr(), b, t, d, heads, int(causal), float(eps),
        cuda_build.stream_handle(x.device),
    )
    cuda_build.LAUNCHES["attn_block"] += 1
    return out


def mlp_block(x: torch.Tensor, ln2: dict, mlp: dict, eps: float = 1e-5) -> torch.Tensor:
    """``x + proj(quick_gelu(fc(LN2(x))))``; ``ln2``/``mlp`` are the
    resblock's ``ln_2``/``mlp`` dicts (fc_w [4D, D], proj_w [D, 4D])."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, ln2, mlp, eps)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_block: unsupported device {x.device}")
    b, t, d = x.shape
    weights = {"ln_2.scale": ln2["scale"], "ln_2.bias": ln2["bias"], **mlp}
    _check(x, weights, "mlp_block")
    d4 = mlp["fc_w"].shape[0]
    if d != 512 or d4 % 64 != 0:
        raise ValueError(f"mlp_block: needs D = 512 and 4D % 64 == 0, got {d}, {d4}")
    out = torch.empty_like(x)
    cuda_build.launch(
        "mlp_block", "mlp_block_launch",
        x.data_ptr(), ln2["scale"].data_ptr(), ln2["bias"].data_ptr(),
        mlp["fc_w"].data_ptr(), mlp["fc_b"].data_ptr(),
        mlp["proj_w"].data_ptr(), mlp["proj_b"].data_ptr(),
        out.data_ptr(), b * t, d, d4, float(eps),
        cuda_build.stream_handle(x.device),
    )
    cuda_build.LAUNCHES["mlp_block"] += 1
    return out

