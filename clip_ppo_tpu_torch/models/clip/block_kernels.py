"""K2, K3, K5, K6 and K7: the two halves of a pre-LN CLIP resblock as
hand-written CUDA kernels, and their plain PyTorch versions.

* :func:`attn_block` — ``x + out_proj(MHA(qkv_proj(LN1(x))))`` with fp32 LN
  statistics and an optional causal mask. Replaces
  ``clip_ppo_tpu/models/clip/pallas_block.py::_attn_block_kernel`` (entry
  ``fused_attn_block``); kernel in ``csrc/attn_block.cu``, for any batch and
  T, D = heads × 64, causal or not: LN statistics, the qkv projection with
  LN1 applied as x loads, K4's attention body, the out-projection with the
  residual, every product on the tensor cores in 3xTF32. The [B, T, 3D] qkv
  and the [B, T, D] attention output are scratch in device memory between
  its launches; LN1(x) never is.
* :func:`attn_stream` — the same function, K6, replacing
  ``_attn_stream_kernel`` (entry ``fused_attn_block_stream``), which
  ``model.resblock`` takes under ``CLIP_PPO_ATTN_STREAM=1`` at widths past
  K2's route (ViT-L/14's vision tower). Kernel in ``csrc/attn_stream.cu``,
  on K2's four launches (``csrc/attn_half.cuh``) and widths: any batch and
  T, D = heads × 64, causal or not. Its [B, T, 3D] qkv and [B, T, D]
  attention output are scratch in device memory between its launches (one
  batch element's qkv, 3.2 MB at ViT-L/14, is far beyond a block's shared
  memory); LN1(x) never is.
* :func:`mlp_block` — ``x + proj(QuickGELU(fc(LN2(x))))``, routed as
  ``fused_mlp_block`` routes (``pallas_block.py:759-820``), reading the
  switches at call time: where both weight matrices fit the TPU kernel's
  12 MiB budget (:func:`uses_mlp_stream` false: the text tower's D = 512 in
  fp32) it runs :func:`mlp_block_resident`, K3, replacing
  ``_mlp_block_kernel`` (``csrc/mlp_block.cu``). Otherwise (the vision
  tower's D = 768 in fp32, ViT-L/14's D = 1024 and 768):
  ``CLIP_PPO_MLP_CHUNKED=1`` runs :func:`mlp_chunked`, K7, replacing
  ``_mlp_block_chunked_kernel`` (``csrc/mlp_chunked.cu``: the hidden
  dimension cut into :data:`MLP_CHUNKS` chunks, their products summed in
  chunk order); else ``CLIP_PPO_MLP_STREAM`` other than "1"
  runs the plain version, as ``_mlp_block_ref``; else :func:`mlp_stream`,
  K5, replacing ``_mlp_stream_kernel`` (``csrc/mlp_stream.cu``). K3, K5 and
  K7 share one sequence of launches (``csrc/mlp_half.cuh``): LN statistics,
  the fc GEMM with LN2 applied as x loads and QuickGELU, the proj GEMM with
  the residual, both products on the tensor cores in 3xTF32 on the GEMM
  they share with K2 and K6 (``csrc/gemm_tf32x3.cuh``). K3 and K5 run it
  with the whole [B, T, 4D] hidden as scratch between the two products
  (``csrc/mlp_block.cu`` says why K3 no longer keeps it on chip), K7 once
  per chunk with one chunk's [B, T, 4D / MLP_CHUNKS]. K3 and K5 take D and
  4D multiples of 32, K7 D a multiple of 32 and 4D a multiple of 32 ×
  MLP_CHUNKS (64 for 32 in bfloat16).

Each wrapper launches its kernel for a CUDA tensor, runs its plain version
(which mirrors ``_attn_block_ref`` / ``_mlp_block_ref``, in float32 or in
bfloat16 with the weights cast to x's dtype) for a CPU tensor, and raises
for any other device and for shapes its kernel does not take.

Dtypes on the GPU. Every tensor of one call has x's dtype (cast a tower
once with ``model.cast_tower``); the LayerNorm statistics the wrappers
allocate as scratch are float32 whatever x is. Every wrapper takes float32
and bfloat16: the bf16 entry points (``attn_block_bf16``, ``mlp_stream_bf16``,
..., counted apart) run every product as one bf16 pass on the tensor cores
with fp32 accumulators, rounding where the TPU kernels round (``csrc/
gemm_bf16.cuh``, ``attention_tile.cuh``'s ``attention_bf16_kernel``), and the
MLP halves then take D and 4D multiples of 64. K7 in bf16 sums its chunks'
products in an fp32 [B*T, D] scratch and rounds once, as
``_mlp_block_chunked_kernel`` sums them in its fp32 ``acc_scratch``. The TPU
kernel's chunk count depends on the dtype (``pallas_block.py:328-331``: 8 in
bf16 and 16 in fp32 at D = 1024, from its VMEM budget); the port's
:data:`MLP_CHUNKS` = 4 in either dtype computes the same fp32 sum, in
another grouping of its terms.
Forward only: the towers run under ``torch.no_grad()``. The primitives the
plain versions are built from (``layer_norm``, ``quick_gelu``,
``attention``) are the model's own; ``attention`` computes its scores
through K4's plain version,
:func:`attention_kernels.fused_qkv_attention_plain`.
"""

from __future__ import annotations

import os

import torch

from clip_ppo_tpu_torch import cuda_build
from clip_ppo_tpu_torch.models.clip.attention_kernels import (  # noqa: F401  (re-exported)
    causal_mask,
    fused_qkv_attention_plain,
)

HEAD_DIM = 64
# The TPU kernels' weight budget (``pallas_block.py:774``, ``model.py:204``).
WEIGHT_BUDGET_BYTES = 12 << 20
# K7's chunks of the hidden dimension, run in order (csrc/mlp_chunked.cu
# says why 4).
MLP_CHUNKS = 4
# The largest row count (B*T) the C entry points take: an int.
_INT_MAX = 2**31 - 1


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
    dt = x.dtype
    h = layer_norm(ln2, x, eps)
    h = quick_gelu(h @ mlp["fc_w"].to(dt).T + mlp["fc_b"].to(dt))
    return x + (h @ mlp["proj_w"].to(dt).T + mlp["proj_b"].to(dt))


# K5 and K7 compute K3's function, and K6 computes K2's: one plain version
# each.
mlp_stream_plain = mlp_block_plain
mlp_chunked_plain = mlp_block_plain
attn_stream_plain = attn_block_plain


def _check(x: torch.Tensor, weights: dict, name: str) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous float32 or bfloat16 [B, T, D] tensor")
    for key, w in weights.items():
        if w.device != x.device or w.dtype != x.dtype or not w.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous {x.dtype} tensor on "
                             f"{x.device}, as x is: every tensor of one call has x's dtype "
                             "(model.cast_tower casts a tower once)")


def _check_shapes(x: torch.Tensor, got: dict, want: dict, name: str) -> None:
    for key, shape in want.items():
        if tuple(got[key].shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(got[key].shape)}, expected {shape}")
    _check(x, got, name)


def _check_mlp_shapes(x: torch.Tensor, ln2: dict, mlp: dict, name: str) -> tuple[int, int]:
    d = x.shape[-1]
    d4 = mlp["fc_w"].shape[0]
    _check_shapes(x, {"ln_2.scale": ln2["scale"], "ln_2.bias": ln2["bias"], **mlp},
                  {"ln_2.scale": (d,), "ln_2.bias": (d,), "fc_w": (d4, d), "fc_b": (d4,),
                   "proj_w": (d, d4), "proj_b": (d,)}, name)
    return d, d4


def _check_attn_shapes(x: torch.Tensor, ln1: dict, attn: dict, name: str) -> int:
    d = x.shape[-1]
    _check_shapes(x, {"ln_1.scale": ln1["scale"], "ln_1.bias": ln1["bias"], **attn},
                  {"ln_1.scale": (d,), "ln_1.bias": (d,), "in_proj_w": (3 * d, d),
                   "in_proj_b": (3 * d,), "out_proj_w": (d, d), "out_proj_b": (d,)}, name)
    return d


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: every tensor must start on a 16-byte boundary "
                         "(the kernel reads and writes 16-byte pieces)")


def attn_block(x: torch.Tensor, ln1: dict, attn: dict, heads: int,
               causal: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """``x + out_proj(MHA(qkv_proj(LN1(x))))``; ``ln1``/``attn`` are the
    resblock's ``ln_1``/``attn`` dicts (in_proj_w [3D, D], out_proj_w [D, D])."""
    if x.device.type == "cpu":
        return attn_block_plain(x, ln1, attn, heads, causal, eps)
    return _attn_half("attn_block", x, ln1, attn, heads, causal, eps)


def _attn_half(name: str, x: torch.Tensor, ln1: dict, attn: dict, heads: int, causal: bool,
               eps: float) -> torch.Tensor:
    """K2 or K6 (``name``) on a device tensor: the four launches of
    ``csrc/attn_half.cuh`` through the kernel's own entry point, for any
    batch and T, D = heads x 64."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    b, t, _ = x.shape
    d = _check_attn_shapes(x, ln1, attn, name)
    if d != heads * HEAD_DIM or b < 1 or t < 1 or b * t > _INT_MAX:
        raise ValueError(f"{name}: the kernel takes D = heads x {HEAD_DIM} and 1 <= B*T <= "
                         f"{_INT_MAX} (any T, causal or not), got D={d}, heads={heads}, "
                         f"B={b}, T={t}")
    _check_aligned(name, x, ln1["scale"], ln1["bias"], *attn.values())
    buf = attn_scratch(x)
    entry = cuda_build.entry(name, x)
    cuda_build.launch(
        name, f"{entry}_launch",
        x.data_ptr(), ln1["scale"].data_ptr(), ln1["bias"].data_ptr(),
        attn["in_proj_w"].data_ptr(), attn["in_proj_b"].data_ptr(),
        attn["out_proj_w"].data_ptr(), attn["out_proj_b"].data_ptr(),
        buf["stats"].data_ptr(), buf["qkv"].data_ptr(), buf["attn"].data_ptr(),
        buf["out"].data_ptr(), b, t, d, heads, int(causal), float(eps),
        cuda_build.stream_handle(x.device),
    )
    cuda_build.count_launch(entry, x)
    return buf["out"]


def _stats(x: torch.Tensor, rows: int) -> torch.Tensor:
    """[rows, 2] LayerNorm (mean, 1/std), float32 whatever x's dtype: the
    TPU kernels take fp32 statistics, and a bf16 mean would round away the
    row's offset."""
    return torch.empty((rows, 2), dtype=torch.float32, device=x.device)


def attn_scratch(x: torch.Tensor) -> dict:
    """The buffers K2 and K6 launch on for [B, T, D] x: the fp32 LN1
    statistics, the [B, T, 3D] qkv and the [B, T, D] attention output
    (scratch, in x's dtype) and the output."""
    b, t, d = x.shape
    return {"stats": _stats(x, b * t),
            "qkv": torch.empty((b, t, 3 * d), dtype=x.dtype, device=x.device),
            "attn": torch.empty_like(x),  # before out_proj
            "out": torch.empty_like(x)}


def mlp_scratch(x: torch.Tensor, d4: int, chunks: int = 1) -> dict:
    """The buffers K3, K5 and K7 launch on for [B, T, D] x: the fp32 LN2
    statistics, one chunk's [B*T, 4D / chunks] hidden in x's dtype, and the
    output; in bfloat16 with several chunks also the fp32 [B*T, D] sum of
    the chunks' projections (``acc``)."""
    m, d = x.shape[0] * x.shape[1], x.shape[2]
    buf = {"stats": _stats(x, m),
           "hidden": torch.empty((m, d4 // chunks), dtype=x.dtype, device=x.device),
           "out": torch.empty_like(x)}
    if x.dtype == torch.bfloat16 and chunks > 1:
        buf["acc"] = torch.empty((m, d), dtype=torch.float32, device=x.device)
    return buf


def mlp_block(x: torch.Tensor, ln2: dict, mlp: dict, eps: float = 1e-5) -> torch.Tensor:
    """``x + proj(quick_gelu(fc(LN2(x))))``; ``ln2``/``mlp`` are the
    resblock's ``ln_2``/``mlp`` dicts (fc_w [4D, D], proj_w [D, 4D]). Where
    :func:`uses_mlp_stream`: K7 under ``CLIP_PPO_MLP_CHUNKED=1``, else the
    plain version when ``CLIP_PPO_MLP_STREAM`` is set to anything but "1",
    else K5. Otherwise K3."""
    if uses_mlp_stream(x.shape[-1], mlp["fc_w"].shape[0], x.element_size()):
        if os.environ.get("CLIP_PPO_MLP_CHUNKED", "0") == "1":
            return mlp_chunked(x, ln2, mlp, eps)
        if os.environ.get("CLIP_PPO_MLP_STREAM", "1") != "1":
            return mlp_block_plain(x, ln2, mlp, eps)
        return mlp_stream(x, ln2, mlp, eps)
    return mlp_block_resident(x, ln2, mlp, eps)


def mlp_block_resident(x: torch.Tensor, ln2: dict, mlp: dict, eps: float = 1e-5) -> torch.Tensor:
    """K3: :func:`mlp_block` where the weights fit the TPU kernel's budget,
    as two tensor-core GEMMs with the [B, T, 4D] hidden as scratch between
    them (D and 4D multiples of 32; of 64 in bfloat16)."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, ln2, mlp, eps)
    return _mlp_half("mlp_block", x, ln2, mlp, eps)


def mlp_stream(x: torch.Tensor, ln2: dict, mlp: dict, eps: float = 1e-5) -> torch.Tensor:
    """K5: :func:`mlp_block` as two tensor-core GEMMs with the [B, T, 4D]
    hidden as scratch between them (D and 4D multiples of 32; of 64 in
    bfloat16)."""
    if x.device.type == "cpu":
        return mlp_stream_plain(x, ln2, mlp, eps)
    return _mlp_half("mlp_stream", x, ln2, mlp, eps)


def _mlp_half(name: str, x: torch.Tensor, ln2: dict, mlp: dict, eps: float,
              chunks: int = 1) -> torch.Tensor:
    """K3, K5 or K7 (``name``) on a device tensor: the launches of
    ``csrc/mlp_half.cuh`` through the kernel's own entry point, the hidden
    dimension in ``chunks`` chunks, one chunk's [B*T, 4D / chunks] hidden as
    scratch (D a multiple of 32, 4D a multiple of 32 x chunks; 64 for 32 in
    bfloat16), and in bfloat16 with several chunks the fp32 sum of their
    projections."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    b, t, _ = x.shape
    d, d4 = _check_mlp_shapes(x, ln2, mlp, name)
    m = b * t
    slice_ = 64 if x.dtype == torch.bfloat16 else 32  # the GEMM's reduction slice
    if (d < slice_ or d % slice_ != 0 or d4 < slice_ * chunks or d4 % (slice_ * chunks) != 0
            or not 1 <= m <= _INT_MAX):
        raise ValueError(f"{name}: the kernel takes D a multiple of {slice_}, 4D a multiple of "
                         f"{slice_ * chunks} and 1 <= B*T <= {_INT_MAX} in {x.dtype}, got "
                         f"D={d}, 4D={d4}, B*T={m}")
    _check_aligned(name, x, ln2["scale"], ln2["bias"], *mlp.values())
    buf = mlp_scratch(x, d4, chunks)
    entry = cuda_build.entry(name, x)
    cuda_build.launch(
        name, f"{entry}_launch",
        x.data_ptr(), ln2["scale"].data_ptr(), ln2["bias"].data_ptr(),
        mlp["fc_w"].data_ptr(), mlp["fc_b"].data_ptr(),
        mlp["proj_w"].data_ptr(), mlp["proj_b"].data_ptr(),
        buf["stats"].data_ptr(), buf["hidden"].data_ptr(),
        *([buf["acc"].data_ptr()] if "acc" in buf else []), buf["out"].data_ptr(), m, d, d4,
        *([chunks] if name == "mlp_chunked" else []), float(eps),
        cuda_build.stream_handle(x.device),
    )
    cuda_build.count_launch(entry, x)
    return buf["out"]


def attn_stream(x: torch.Tensor, ln1: dict, attn: dict, heads: int,
                causal: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """K6: :func:`attn_block`'s function, at its widths (D = heads x 64,
    any batch and T, causal or not), the residual included."""
    if x.device.type == "cpu":
        return attn_stream_plain(x, ln1, attn, heads, causal, eps)
    return _attn_half("attn_stream", x, ln1, attn, heads, causal, eps)


def mlp_chunked(x: torch.Tensor, ln2: dict, mlp: dict, eps: float = 1e-5) -> torch.Tensor:
    """K7: :func:`mlp_block` as a sum over :data:`MLP_CHUNKS` chunks of the
    hidden dimension, taken in chunk order, with one chunk's [B, T, 4D /
    MLP_CHUNKS] hidden as scratch (D a multiple of 32, 4D a multiple of 32 x
    MLP_CHUNKS; 64 for 32 in bfloat16, where the sum is kept in an fp32
    [B*T, D] scratch and rounded once)."""
    if x.device.type == "cpu":
        return mlp_chunked_plain(x, ln2, mlp, eps)
    return _mlp_half("mlp_chunked", x, ln2, mlp, eps, MLP_CHUNKS)
