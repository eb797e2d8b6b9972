"""K2, K3 and K5: the two halves of a pre-LN CLIP resblock as hand-written
CUDA kernels, and their plain PyTorch versions.

* :func:`attn_block` — ``x + out_proj(MHA(qkv_proj(LN1(x))))`` with fp32 LN
  statistics and an optional causal mask. Replaces
  ``clip_ppo_tpu/models/clip/pallas_block.py::_attn_block_kernel`` (entry
  ``fused_attn_block``); kernel in ``csrc/attn_block.cu``, for any batch,
  D = heads × 64 and T ≤ 80 (the text tower's 77 tokens, ViT-B/32's 50).
  The [B, T, 3D] qkv never reaches device memory; the [B, T, D] attention
  output does, between the kernel's two launches.
* :func:`mlp_block` — ``x + proj(QuickGELU(fc(LN2(x))))``, routed as
  ``fused_mlp_block`` routes (``pallas_block.py:774``): where both weight
  matrices fit the TPU kernel's 12 MiB budget (:func:`uses_mlp_stream`
  false: the text tower's D = 512 in fp32) it runs
  :func:`mlp_block_resident`, K3, replacing ``_mlp_block_kernel``
  (``csrc/mlp_block.cu``, D = 512); otherwise (the vision tower's D = 768
  in fp32, ViT-L/14's D = 1024) :func:`mlp_stream`, K5, replacing
  ``_mlp_stream_kernel`` (``csrc/mlp_stream.cu``, D a multiple of 128 up to
  1024), which streams the weights through shared memory in tiles. Either
  way the [B, T, 4D] hidden never reaches device memory.

Each wrapper launches its kernel for a CUDA tensor, runs its plain version
(which mirrors ``_attn_block_ref`` / ``_mlp_block_ref``) for a CPU tensor,
and raises for any other device. Forward only: the towers run under
``torch.no_grad()``. The primitives the plain versions are built from
(``layer_norm``, ``quick_gelu``, ``attention``) are the model's own;
``attention`` computes its scores through K4's plain version,
:func:`attention_kernels.fused_qkv_attention_plain`.
"""

from __future__ import annotations

import torch

from clip_ppo_tpu_torch import cuda_build
from clip_ppo_tpu_torch.models.clip.attention_kernels import (  # noqa: F401  (re-exported)
    causal_mask,
    fused_qkv_attention_plain,
)

HEAD_DIM = 64
# The TPU kernels' weight budget (``pallas_block.py:774``, ``model.py:204``).
WEIGHT_BUDGET_BYTES = 12 << 20


def uses_mlp_stream(width: int, hidden: int, itemsize: int) -> bool:
    """Whether the MLP half takes K5: both weight matrices, in the
    activations' dtype, exceed the budget (``fused_mlp_block``'s rule)."""
    return 2 * width * hidden * itemsize > WEIGHT_BUDGET_BYTES


def uses_attn_block(width: int) -> bool:
    """Whether a resblock takes K2 for its attention half under "auto": the
    MLP weights in bf16 fit the budget whatever the dtype
    (``_use_fused_block``'s rule). Wider towers (ViT-L/14's vision tower)
    take K4, :func:`attention_kernels.fused_qkv_attention`."""
    return 2 * width * 4 * width * 2 <= WEIGHT_BUDGET_BYTES


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


def attention(p: dict, x: torch.Tensor, heads: int, causal: bool = False) -> torch.Tensor:
    """Multi-head self-attention with a fused qkv projection (einsum MHA)."""
    qkv = x @ p["in_proj_w"].to(x.dtype).T + p["in_proj_b"].to(x.dtype)
    out = fused_qkv_attention_plain(qkv, heads, causal)
    return out @ p["out_proj_w"].to(x.dtype).T + p["out_proj_b"].to(x.dtype)


def attn_block_plain(x: torch.Tensor, ln1: dict, attn: dict, heads: int,
                     causal: bool = False, eps: float = 1e-5) -> torch.Tensor:
    return x + attention(attn, layer_norm(ln1, x, eps), heads, causal)


def mlp_block_plain(x: torch.Tensor, ln2: dict, mlp: dict,
                    eps: float = 1e-5) -> torch.Tensor:
    h = layer_norm(ln2, x, eps)
    h = quick_gelu(h @ mlp["fc_w"].T + mlp["fc_b"])
    return x + (h @ mlp["proj_w"].T + mlp["proj_b"])


# The kernels compute K5's function exactly as K3's: one plain version.
mlp_stream_plain = mlp_block_plain


def _check(x: torch.Tensor, weights: dict, name: str) -> None:
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous float32 [B, T, D] tensor")
    for key, w in weights.items():
        if w.device != x.device or w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous float32 tensor on {x.device}")


def _check_mlp_shapes(x: torch.Tensor, ln2: dict, mlp: dict, name: str) -> tuple[int, int]:
    d = x.shape[-1]
    d4 = mlp["fc_w"].shape[0]
    want = {"ln_2.scale": (d,), "ln_2.bias": (d,), "fc_w": (d4, d), "fc_b": (d4,),
            "proj_w": (d, d4), "proj_b": (d,)}
    got = {"ln_2.scale": ln2["scale"], "ln_2.bias": ln2["bias"], **mlp}
    for key, shape in want.items():
        if tuple(got[key].shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(got[key].shape)}, expected {shape}")
    _check(x, got, name)
    return d, d4


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
    if d != heads * HEAD_DIM or not 1 <= t <= 80:
        raise ValueError(f"attn_block: the kernel takes D = heads x {HEAD_DIM} and 1 <= T <= 80 "
                         f"(any batch, causal or not), got D={d}, heads={heads}, T={t}")
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
    resblock's ``ln_2``/``mlp`` dicts (fc_w [4D, D], proj_w [D, 4D]). Takes
    K5 where :func:`uses_mlp_stream`, else K3."""
    if uses_mlp_stream(x.shape[-1], mlp["fc_w"].shape[0], x.element_size()):
        return mlp_stream(x, ln2, mlp, eps)
    return mlp_block_resident(x, ln2, mlp, eps)


def mlp_block_resident(x: torch.Tensor, ln2: dict, mlp: dict, eps: float = 1e-5) -> torch.Tensor:
    """K3: :func:`mlp_block` with the weights read whole by every block
    (D = 512)."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, ln2, mlp, eps)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_block: unsupported device {x.device}")
    b, t, _ = x.shape
    d, d4 = _check_mlp_shapes(x, ln2, mlp, "mlp_block")
    if d != 512 or d4 % 64 != 0:
        raise ValueError(f"mlp_block: the kernel takes D = 512 and 4D % 64 == 0, got {d}, {d4}")
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


def mlp_stream(x: torch.Tensor, ln2: dict, mlp: dict, eps: float = 1e-5) -> torch.Tensor:
    """K5: :func:`mlp_block` with the weights streamed through shared memory
    in tiles (D a multiple of 128 up to 1024, 4D a multiple of 64)."""
    if x.device.type == "cpu":
        return mlp_stream_plain(x, ln2, mlp, eps)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_stream: unsupported device {x.device}")
    b, t, _ = x.shape
    d, d4 = _check_mlp_shapes(x, ln2, mlp, "mlp_stream")
    if d % 128 != 0 or not 128 <= d <= 1024 or d4 % 64 != 0:
        raise ValueError(f"mlp_stream: the kernel takes D a multiple of 128 up to 1024 and "
                         f"4D % 64 == 0, got {d}, {d4}")
    if mlp["fc_w"].data_ptr() % 16 or mlp["proj_w"].data_ptr() % 16:
        raise ValueError("mlp_stream: fc_w and proj_w must start on a 16-byte boundary "
                         "(the kernel copies them in 16-byte pieces)")
    out = torch.empty_like(x)
    cuda_build.launch(
        "mlp_stream", "mlp_stream_launch",
        x.data_ptr(), ln2["scale"].data_ptr(), ln2["bias"].data_ptr(),
        mlp["fc_w"].data_ptr(), mlp["fc_b"].data_ptr(),
        mlp["proj_w"].data_ptr(), mlp["proj_b"].data_ptr(),
        out.data_ptr(), b * t, d, d4, float(eps),
        cuda_build.stream_handle(x.device),
    )
    cuda_build.LAUNCHES["mlp_stream"] += 1
    return out
