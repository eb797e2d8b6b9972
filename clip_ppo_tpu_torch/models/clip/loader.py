"""CLIP checkpoint loading: OpenAI ``.pt`` → params dict.

Port of ``clip_ppo_tpu/models/clip/loader.py`` (reference ``clip.load``,
`shared/clip_ppo_utils.py:79-97`). An OpenAI TorchScript archive or a raw
OpenAI-layout state dict loads natively in torch and converts to the params
dict :mod:`clip_ppo_tpu_torch.models.clip.model` consumes; a Hugging Face
``CLIPModel`` state dict converts through :func:`convert_hf_state_dict`.
Checkpoints are
looked up in ``$CLIP_PPO_CHECKPOINT_DIR``; with ``pretrained="auto"`` and
none there, the towers are randomly initialized from a seed (the
reference's RANDOM_ENCODER semantics applied to both towers).
"""

from __future__ import annotations

import os
import warnings

import torch

from clip_ppo_tpu_torch.device import resolve_device
from clip_ppo_tpu_torch.models.clip.config import CLIP_CONFIGS, CLIPConfig

_CKPT_FILENAMES = {
    "ViT-B/32": "ViT-B-32.pt",
    "ViT-B/16": "ViT-B-16.pt",
    "ViT-L/14": "ViT-L-14.pt",
}


def detect_config(sd: dict) -> CLIPConfig:
    """Infer the architecture from an OpenAI-layout state dict."""
    vision_width = sd["visual.conv1.weight"].shape[0]
    patch_size = sd["visual.conv1.weight"].shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    vision_layers = 1 + max(int(k.split(".")[3]) for k in sd
                            if k.startswith("visual.transformer.resblocks."))
    text_width = sd["ln_final.weight"].shape[0]
    text_layers = 1 + max(int(k.split(".")[2]) for k in sd
                          if k.startswith("transformer.resblocks."))
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_size=grid * patch_size,
        patch_size=patch_size,
        vision_width=vision_width,
        vision_layers=vision_layers,
        vision_heads=vision_width // 64,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        text_width=text_width,
        text_heads=text_width // 64,
        text_layers=text_layers,
    )


def convert_openai_state_dict(sd: dict, device=None) -> tuple[dict, CLIPConfig]:
    """OpenAI CLIP state dict → (params, CLIPConfig), float32 on ``device``
    (default: the GPU, raising without one; pass "cpu" for the CPU).
    The patch-embed conv ``[width, 3, ps, ps]`` becomes the
    ``[ps·ps·3, width]`` matmul weight with (py, px, c) row layout."""
    device = resolve_device() if device is None else device
    cfg = detect_config(sd)
    g = lambda k: sd[k].detach().to(device=device, dtype=torch.float32).contiguous()  # noqa: E731

    def block(prefix: str) -> dict:
        return {
            "ln_1": {"scale": g(prefix + "ln_1.weight"), "bias": g(prefix + "ln_1.bias")},
            "ln_2": {"scale": g(prefix + "ln_2.weight"), "bias": g(prefix + "ln_2.bias")},
            "attn": {
                "in_proj_w": g(prefix + "attn.in_proj_weight"),
                "in_proj_b": g(prefix + "attn.in_proj_bias"),
                "out_proj_w": g(prefix + "attn.out_proj.weight"),
                "out_proj_b": g(prefix + "attn.out_proj.bias"),
            },
            "mlp": {
                "fc_w": g(prefix + "mlp.c_fc.weight"),
                "fc_b": g(prefix + "mlp.c_fc.bias"),
                "proj_w": g(prefix + "mlp.c_proj.weight"),
                "proj_b": g(prefix + "mlp.c_proj.bias"),
            },
        }

    conv_w = g("visual.conv1.weight")  # [width, 3, ps, ps]
    patch_w = conv_w.permute(2, 3, 1, 0).reshape(cfg.patch_size * cfg.patch_size * 3,
                                                 cfg.vision_width).contiguous()
    visual = {
        "patch_embed_w": patch_w,
        "class_embedding": g("visual.class_embedding"),
        "positional_embedding": g("visual.positional_embedding"),
        "ln_pre": {"scale": g("visual.ln_pre.weight"), "bias": g("visual.ln_pre.bias")},
        "transformer": {"resblocks": [block(f"visual.transformer.resblocks.{i}.")
                                      for i in range(cfg.vision_layers)]},
        "ln_post": {"scale": g("visual.ln_post.weight"), "bias": g("visual.ln_post.bias")},
        "proj": g("visual.proj"),
    }
    text = {
        "token_embedding": g("token_embedding.weight"),
        "positional_embedding": g("positional_embedding"),
        "transformer": {"resblocks": [block(f"transformer.resblocks.{i}.")
                                      for i in range(cfg.text_layers)]},
        "ln_final": {"scale": g("ln_final.weight"), "bias": g("ln_final.bias")},
        "text_projection": g("text_projection"),
    }
    params = {"visual": visual, "text": text}
    if "logit_scale" in sd:
        params["logit_scale"] = g("logit_scale")
    return params, cfg


def _block_from_hf(sd: dict, prefix: str, g) -> dict:
    """One Hugging Face encoder layer as the params of a resblock: q, k and v
    concatenated into the fused in-projection."""
    def cat(kind: str) -> torch.Tensor:
        return torch.cat([g(f"{prefix}self_attn.{p}_proj.{kind}") for p in "qkv"]).contiguous()

    return {
        "ln_1": {"scale": g(prefix + "layer_norm1.weight"), "bias": g(prefix + "layer_norm1.bias")},
        "ln_2": {"scale": g(prefix + "layer_norm2.weight"), "bias": g(prefix + "layer_norm2.bias")},
        "attn": {
            "in_proj_w": cat("weight"),
            "in_proj_b": cat("bias"),
            "out_proj_w": g(prefix + "self_attn.out_proj.weight"),
            "out_proj_b": g(prefix + "self_attn.out_proj.bias"),
        },
        "mlp": {
            "fc_w": g(prefix + "mlp.fc1.weight"),
            "fc_b": g(prefix + "mlp.fc1.bias"),
            "proj_w": g(prefix + "mlp.fc2.weight"),
            "proj_b": g(prefix + "mlp.fc2.bias"),
        },
    }


def convert_hf_state_dict(sd: dict, cfg: CLIPConfig, device=None) -> dict:
    """Hugging Face ``CLIPModel.state_dict()`` → params, float32 on
    ``device`` (default: the GPU, raising without one; pass "cpu" for the
    CPU). HF splits q/k/v and stores the projections as ``Linear`` weights
    ([out, in], applied as x @ W.T), the convention of the model code, so
    apart from the qkv concatenation and the two projections' transposes
    the mapping is mechanical."""
    device = resolve_device() if device is None else device
    g = lambda k: torch.as_tensor(sd[k]).detach().to(  # noqa: E731
        device=device, dtype=torch.float32).contiguous()
    conv_w = g("vision_model.embeddings.patch_embedding.weight")  # [width, 3, ps, ps]
    patch_w = conv_w.permute(2, 3, 1, 0).reshape(cfg.patch_size * cfg.patch_size * 3,
                                                 cfg.vision_width).contiguous()
    visual = {
        "patch_embed_w": patch_w,
        "class_embedding": g("vision_model.embeddings.class_embedding"),
        "positional_embedding": g("vision_model.embeddings.position_embedding.weight"),
        "ln_pre": {"scale": g("vision_model.pre_layrnorm.weight"),
                   "bias": g("vision_model.pre_layrnorm.bias")},
        "transformer": {"resblocks": [
            _block_from_hf(sd, f"vision_model.encoder.layers.{i}.", g)
            for i in range(cfg.vision_layers)]},
        "ln_post": {"scale": g("vision_model.post_layernorm.weight"),
                    "bias": g("vision_model.post_layernorm.bias")},
        "proj": g("visual_projection.weight").T.contiguous(),
    }
    text = {
        "token_embedding": g("text_model.embeddings.token_embedding.weight"),
        "positional_embedding": g("text_model.embeddings.position_embedding.weight"),
        "transformer": {"resblocks": [
            _block_from_hf(sd, f"text_model.encoder.layers.{i}.", g)
            for i in range(cfg.text_layers)]},
        "ln_final": {"scale": g("text_model.final_layer_norm.weight"),
                     "bias": g("text_model.final_layer_norm.bias")},
        "text_projection": g("text_projection.weight").T.contiguous(),
    }
    params = {"visual": visual, "text": text}
    if "logit_scale" in sd:
        params["logit_scale"] = g("logit_scale")
    return params


def find_checkpoint(name: str) -> str | None:
    """The OpenAI ``.pt`` for ``name`` in ``$CLIP_PPO_CHECKPOINT_DIR``, then
    ``~/.cache/clip``, then ``~/.cache/clip_ppo_tpu`` (the JAX package's
    order); None when none of them holds it."""
    fname = _CKPT_FILENAMES.get(name, name.replace("/", "-") + ".pt")
    for root in (os.environ.get("CLIP_PPO_CHECKPOINT_DIR", ""),
                 os.path.expanduser("~/.cache/clip"),
                 os.path.expanduser("~/.cache/clip_ppo_tpu")):
        path = os.path.join(root, fname)
        if root and os.path.exists(path):
            return path
    return None


def load_openai_checkpoint(path: str, device=None) -> tuple[dict, CLIPConfig]:
    """Load an OpenAI ``.pt`` (TorchScript archive or raw state dict) onto
    ``device`` (default: the GPU, raising without one)."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return convert_openai_state_dict(sd, device)


def load_clip_model(name: str = "ViT-B/32", device=None, path: str | None = None,
                    pretrained: str | bool = "auto", seed: int = 0) -> tuple[dict, CLIPConfig]:
    """(params, cfg) of a frozen CLIP ("frozen" by never reaching the
    optimizer), on ``device`` (default: the GPU, raising without one; pass
    "cpu" for the CPU). ``pretrained``: True requires a checkpoint; "auto"
    uses one when found, else warns and random-initializes; False always
    random-initializes (deterministic in ``seed``)."""
    from clip_ppo_tpu_torch.models.clip.model import init_clip_params

    device = resolve_device() if device is None else device
    ckpt = path or (find_checkpoint(name) if pretrained else None)
    if ckpt is not None:
        return load_openai_checkpoint(ckpt, device)
    if pretrained is True:
        raise FileNotFoundError(
            f"no CLIP checkpoint for {name!r}; set $CLIP_PPO_CHECKPOINT_DIR "
            "or place the OpenAI .pt under ~/.cache/clip"
        )
    if pretrained == "auto":
        warnings.warn(
            f"no pretrained CLIP checkpoint found for {name!r}; using "
            "deterministic random initialization (RANDOM_ENCODER semantics)"
        )
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_clip_params(gen, CLIP_CONFIGS[name], device), CLIP_CONFIGS[name]
