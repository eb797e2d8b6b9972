"""CLIP's two towers in PyTorch — the causal text transformer and the
vision transformer — and random initialization of both.

Parameters are nested dicts of tensors with the JAX package's key layout
(OpenAI's module names; see loader.py), so weights carry across whole
between the packages (``clip_ppo_tpu_torch.convert``). Linear weights keep
the ``[out, in]`` orientation, applied as ``x @ W.T``.

Routing by ``attention_impl``, as ``clip_ppo_tpu/models/clip/model.py:136-285``
routes on the TPU (the text tower passes the causal mask, the vision tower
none):

* ``"auto"`` (the default): a resblock whose MLP weights fit the TPU
  kernels' budget in bf16 (:func:`block_kernels.uses_attn_block`: widths up
  to 768, both ViT-B towers and every text tower) runs its attention half
  through K2 (:func:`block_kernels.attn_block`). A wider one (ViT-L/14's
  vision tower, D = 1024) projects qkv with ``torch.matmul``, runs K4
  (:func:`attention_kernels.fused_qkv_attention`), then the out-projection
  and the residual; under ``CLIP_PPO_ATTN_STREAM=1`` (read at call time, as
  ``_use_stream_attn`` reads it) it runs K6
  (:func:`block_kernels.attn_stream`) instead, residual included. Every
  route sends the MLP half through :func:`block_kernels.mlp_block`, which
  picks K3, K5, K7 or the plain version by the weights' size in the
  activations' dtype and the ``CLIP_PPO_MLP_CHUNKED`` and
  ``CLIP_PPO_MLP_STREAM`` switches; past K2's widths
  ``CLIP_PPO_MLP_STREAM`` other than "1" takes the plain MLP whatever
  ``CLIP_PPO_MLP_CHUNKED`` says, as ``_use_stream_mlp`` does.
* ``"fused"``: K4 for attention at any width, causal for the text tower;
  the plain MLP.
* ``"block"``: K2 and :func:`block_kernels.mlp_block` at any width.
* ``"xla"``: the plain einsum attention and the plain MLP, no kernel.
* ``"packedN"``: the plain batch-packed attention (:func:`packed_sdpa`,
  N sequences per block-masked sequence) where there is no mask; the plain
  MLP.
* ``"pallas"``: K8 (:func:`attention_kernels.packed_attention`) where there
  is no mask (the vision tower; the text tower keeps the einsum path); the
  plain MLP.

On a CPU tensor every kernel wrapper runs its plain version. The JAX
package also routes by batch size and backend to save TPU compile time,
which has no counterpart here.
"""

from __future__ import annotations

import os

import torch

from clip_ppo_tpu_torch.models.clip.attention_kernels import (
    fused_qkv_attention,
    fused_qkv_attention_plain,
    packed_attention,
)
from clip_ppo_tpu_torch.models.clip.block_kernels import (  # noqa: F401  (re-exported)
    attn_block,
    attn_stream,
    causal_mask,
    layer_norm,
    mlp_block,
    mlp_block_plain,
    quick_gelu,
    uses_attn_block,
)
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig


def _pack_factor(impl: str) -> int:
    """N of ``impl="packedN"`` (2 for a bare "packed"), else 1."""
    return int(impl[len("packed"):] or 2) if impl.startswith("packed") else 1


def packed_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: int) -> torch.Tensor:
    """Softmax attention over ``[B, T, H, Dh]`` with ``g`` batch elements
    packed per block-masked sequence of length g·T (``model.py:105``).
    Exact: each sequence attends only to itself."""
    b, s, h, c = q.shape
    pad = (-b) % g
    if pad:
        zeros = q.new_zeros((pad, s, h, c))
        q, k, v = (torch.cat([z, zeros]) for z in (q, k, v))
    bb = q.shape[0] // g
    qp, kp, vp = (z.reshape(bb, g * s, h, c) for z in (q, k, v))
    logits = torch.einsum("bqhc,bkhc->bhqk", qp * (1.0 / c ** 0.5), kp)
    block = torch.arange(g * s, device=q.device) // s
    block_mask = torch.zeros((g * s, g * s), device=q.device)
    block_mask.masked_fill_(block[:, None] != block[None, :], float("-inf"))
    weights = torch.softmax(logits.float() + block_mask, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhc->bqhc", weights, vp).reshape(bb * g, s, h, c)
    return out[:b]


def attention(p: dict, x: torch.Tensor, heads: int, causal: bool = False,
              impl: str = "auto") -> torch.Tensor:
    """Multi-head self-attention with a fused qkv projection and the
    out-projection (no residual), its scores routed by ``impl``."""
    b, t, d = x.shape
    qkv = x @ p["in_proj_w"].to(x.dtype).T + p["in_proj_b"].to(x.dtype)
    if impl in ("auto", "fused"):
        out = fused_qkv_attention(qkv, heads, causal)
    elif not causal and (impl == "pallas" or (_pack_factor(impl) > 1 and b > 1)):
        q, k, v = (z.view(b, t, heads, d // heads) for z in qkv.split(d, dim=-1))
        if impl == "pallas":
            out = packed_attention(q, k, v)
        else:
            out = packed_sdpa(q, k, v, _pack_factor(impl))
        out = out.reshape(b, t, d)
    else:
        out = fused_qkv_attention_plain(qkv, heads, causal)
    return out @ p["out_proj_w"].to(x.dtype).T + p["out_proj_b"].to(x.dtype)


def resblock(p: dict, x: torch.Tensor, heads: int, causal: bool = False,
             impl: str = "auto") -> torch.Tensor:
    """Pre-LN transformer block with QuickGELU MLP (width → 4·width)."""
    if impl == "block" or (impl == "auto" and uses_attn_block(x.shape[-1])):
        x = attn_block(x, p["ln_1"], p["attn"], heads, causal)  # plain version on the CPU
        return mlp_block(x, p["ln_2"], p["mlp"])
    if impl == "auto" and os.environ.get("CLIP_PPO_ATTN_STREAM", "0") == "1":
        x = attn_stream(x, p["ln_1"], p["attn"], heads, causal)
    else:
        x = x + attention(p["attn"], layer_norm(p["ln_1"], x), heads, causal, impl)
    # Past K2's widths "auto" streams the MLP only while CLIP_PPO_MLP_STREAM
    # is "1", before any other switch (``_use_stream_mlp``).
    if impl == "auto" and os.environ.get("CLIP_PPO_MLP_STREAM", "1") == "1":
        return mlp_block(x, p["ln_2"], p["mlp"])
    return mlp_block_plain(x, p["ln_2"], p["mlp"])


def transformer(p: dict, x: torch.Tensor, heads: int, causal: bool = False,
                impl: str = "auto") -> torch.Tensor:
    for block in p["resblocks"]:
        x = resblock(block, x, heads, causal, impl)
    return x


def encode_text(params: dict, cfg: CLIPConfig, tokens: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32,
                attention_impl: str = "auto") -> torch.Tensor:
    """[B, 77] integer token ids → [B, embed_dim] float32 features, pooled at
    each sequence's argmax token id (the EOT token) as OpenAI CLIP does. The
    tower runs in ``compute_dtype`` (its resblocks' weights must already be
    of that dtype on the GPU: :func:`cast_tower`); LayerNorm statistics stay
    float32."""
    t = params["text"]
    tokens = tokens.long()
    x = t["token_embedding"][tokens].to(compute_dtype)
    x = (x + t["positional_embedding"][: tokens.shape[1]].to(compute_dtype)).contiguous()
    x = transformer(t["transformer"], x, cfg.text_heads, causal=True, impl=attention_impl)
    x = layer_norm(t["ln_final"], x)
    eot = tokens.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return (pooled @ t["text_projection"].to(compute_dtype)).float()


def encode_image(params: dict, cfg: CLIPConfig, images: torch.Tensor,
                 compute_dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto") -> torch.Tensor:
    """[B, image_size, image_size, 3] normalized float32 images (NHWC) →
    [B, embed_dim] float32 features; feed with
    ``ops.resize.preprocess_for_clip``. The tower runs in ``compute_dtype``
    step for step as the JAX package's ``encode_image`` does: the patch
    embed and the class and positional embeddings in that dtype, LayerNorm
    with float32 statistics, the projection in that dtype, cast to float32
    at the end. On the GPU its resblocks' weights must already be of that
    dtype (:func:`cast_tower`)."""
    v = params["visual"]
    b = images.shape[0]
    ps, g = cfg.patch_size, cfg.grid_size
    # Patch embed as one product: [B, g, ps, g, ps, 3] → [B, g·g, ps·ps·3].
    x = images.to(compute_dtype).reshape(b, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, g * g, ps * ps * 3) @ v["patch_embed_w"].to(compute_dtype)  # no bias
    cls = v["class_embedding"].to(compute_dtype).expand(b, 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1) + v["positional_embedding"].to(compute_dtype)
    x = layer_norm(v["ln_pre"], x).contiguous()
    x = transformer(v["transformer"], x, cfg.vision_heads, impl=attention_impl)
    x = layer_norm(v["ln_post"], x[:, 0, :])
    return (x @ v["proj"].to(compute_dtype)).float()


# The towers' outer LayerNorms: the JAX package reads their parameters in
# float32 whatever the compute dtype (``layer_norm``), so cast_tower leaves
# them as they are.
_F32_KEYS = ("ln_pre", "ln_post", "ln_final")


def cast_tower(params: dict, dtype: torch.dtype) -> dict:
    """The CLIP parameters (both towers, or one tower's subtree) with every
    floating tensor in ``dtype``, once: the JAX package casts each weight
    inside the jitted encode (``.astype(compute_dtype)``), which eager
    PyTorch would repeat at every call. The outer LayerNorms stay float32;
    tensors already of ``dtype`` are shared, not copied."""
    def cast(tree):
        if isinstance(tree, dict):
            return {k: tree[k] if k in _F32_KEYS else cast(tree[k]) for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cast(item) for item in tree)
        return tree.to(dtype) if tree.is_floating_point() else tree

    return cast(params)


# ---------------------------------------------------------------------------
# Random initialization (OpenAI's init scheme; real weights come from
# loader.py)
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    return std * torch.randn(shape, generator=gen, device=device)


def init_block(gen: torch.Generator, width: int, device) -> dict:
    attn_std = width ** -0.5
    fc_std = (2 * width) ** -0.5
    proj_std = attn_std
    ones = lambda n: torch.ones(n, device=device)  # noqa: E731
    zeros = lambda n: torch.zeros(n, device=device)  # noqa: E731
    return {
        "ln_1": {"scale": ones(width), "bias": zeros(width)},
        "ln_2": {"scale": ones(width), "bias": zeros(width)},
        "attn": {
            "in_proj_w": _normal(gen, (3 * width, width), attn_std, device),
            "in_proj_b": zeros(3 * width),
            "out_proj_w": _normal(gen, (width, width), proj_std, device),
            "out_proj_b": zeros(width),
        },
        "mlp": {
            "fc_w": _normal(gen, (4 * width, width), fc_std, device),
            "fc_b": zeros(4 * width),
            "proj_w": _normal(gen, (width, 4 * width), proj_std, device),
            "proj_b": zeros(width),
        },
    }


def init_clip_params(gen: torch.Generator, cfg: CLIPConfig, device) -> dict:
    """Both towers, with the JAX package's shapes and init scales."""
    vw, tw = cfg.vision_width, cfg.text_width
    ones = lambda n: torch.ones(n, device=device)  # noqa: E731
    zeros = lambda n: torch.zeros(n, device=device)  # noqa: E731
    visual = {
        "patch_embed_w": _normal(gen, (cfg.patch_size * cfg.patch_size * 3, vw), vw ** -0.5, device),
        "class_embedding": _normal(gen, (vw,), vw ** -0.5, device),
        "positional_embedding": _normal(gen, (cfg.num_patches + 1, vw), vw ** -0.5, device),
        "ln_pre": {"scale": ones(vw), "bias": zeros(vw)},
        "transformer": {"resblocks": [init_block(gen, vw, device) for _ in range(cfg.vision_layers)]},
        "ln_post": {"scale": ones(vw), "bias": zeros(vw)},
        "proj": _normal(gen, (vw, cfg.embed_dim), vw ** -0.5, device),
    }
    text = {
        "token_embedding": _normal(gen, (cfg.vocab_size, tw), 0.02, device),
        "positional_embedding": _normal(gen, (cfg.context_length, tw), 0.01, device),
        "transformer": {"resblocks": [init_block(gen, tw, device) for _ in range(cfg.text_layers)]},
        "ln_final": {"scale": ones(tw), "bias": zeros(tw)},
        "text_projection": _normal(gen, (tw, cfg.embed_dim), tw ** -0.5, device),
    }
    return {"visual": visual, "text": text}
