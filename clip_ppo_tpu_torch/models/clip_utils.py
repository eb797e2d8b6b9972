"""CLIP-PPO shared utilities: λ warmup, the alignment loss, the MiniGrid
description-embedding table and the per-iteration image embeddings.

Port of the parts of ``clip_ppo_tpu/models/clip_utils.py`` the text and
image modalities and the FROZEN_CLIP and RANDOM_ENCODER ablations run on
MiniGrid and Atari (reference `shared/clip_ppo_utils.py:13-240`), the
Atari multi-frame features (`clip_ppo_atari.py:211-299`) included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from clip_ppo_tpu_torch.models import nature_cnn as cnn
from clip_ppo_tpu_torch.models.agent import AblationMode
from clip_ppo_tpu_torch.models.clip import model as clip_model_mod
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig
from clip_ppo_tpu_torch.models.clip.loader import load_clip_model  # noqa: F401  (re-export)
from clip_ppo_tpu_torch.models.clip.tokenizer import tokenize
from clip_ppo_tpu_torch.ops.resize import preprocess_for_clip

CLIP_LOSS_FREQUENCY = 4  # every 4th minibatch (`clip_ppo_utils.py:24`)


def get_clip_lambda_with_warmup(target_lambda: float, current_iteration: int,
                                total_iterations: int, warmup_fraction: float = 0.2) -> float:
    """Linear λ warmup over the first ``warmup_fraction`` of training
    (`clip_ppo_utils.py:26-46`); ``current_iteration`` is 0-indexed. Float32
    arithmetic, as the JAX package computes it."""
    warmup_iterations = int(total_iterations * warmup_fraction)
    f32 = np.float32
    if warmup_iterations <= 0 or current_iteration >= warmup_iterations:
        return float(f32(target_lambda))
    return float(f32(target_lambda) * (f32(current_iteration) / f32(warmup_iterations)))


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)


def check_embedding_width(latent_dim: int, embed_dim: int) -> None:
    """The reference's ValueError where the PPO latent and the CLIP
    embedding differ in width (ViT-L/14's 768 against the agent's 512)."""
    if latent_dim != embed_dim:
        raise ValueError(
            f"Dimension mismatch: PPO latents ({latent_dim}) vs CLIP "
            f"embeddings ({embed_dim}). Both should be 512-dim for "
            "ViT-B/32. Check agent architecture."
        )


def compute_cosine_embedding_loss(z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """L_CLIP = mean(1 - cos(z/||z||, c/||c||)) (`clip_ppo_utils.py:48-76`)."""
    check_embedding_width(z.shape[-1], c.shape[-1])
    return (1.0 - (l2_normalize(z) * l2_normalize(c)).sum(-1)).mean()


def should_compute_clip_loss(ablation_mode: AblationMode, clip_lambda: float) -> bool:
    """λ > 0 and not FROZEN_CLIP (`clip_ppo_utils.py:170-182`)."""
    return clip_lambda > 0.0 and ablation_mode != AblationMode.FROZEN_CLIP


def build_minigrid_text_table(clip_params: dict, cfg: CLIPConfig, width: int, height: int,
                              suffix: str, encode_batch: int = 1024) -> torch.Tensor:
    """Text embeddings of every possible MiniGrid description.

    Descriptions are ``"agent at (x,y) facing D" + suffix`` with a suffix
    that is constant for the run (the static border walls,
    `clip_ppo_minigrid.py:164-211`), so the description space is exactly
    W·H·4 strings, encoded once here; the rollout then gathers rows at index
    (x·H + y)·4 + dir. Returns [W·H·4, embed_dim] L2-normalized float32 on
    the weights' device.
    """
    from clip_ppo_tpu_torch.envs.minigrid.core import DIR_NAMES

    descriptions = [
        f"agent at ({x},{y}) facing {DIR_NAMES[d]}" + suffix
        for x in range(width) for y in range(height) for d in range(4)
    ]
    device = clip_params["text"]["token_embedding"].device
    chunks = []
    with torch.no_grad():
        for i in range(0, len(descriptions), encode_batch):
            toks = torch.as_tensor(tokenize(descriptions[i:i + encode_batch]), device=device)
            chunks.append(l2_normalize(clip_model_mod.encode_text(clip_params, cfg, toks)))
    return torch.cat(chunks)


def make_text_table_embed_fn(height: int):
    """``(desc, frozen) -> [T·N, embed_dim]``: the rows of the table in
    ``frozen["text_table"]`` for the rollout's per-step state snapshots
    ({"agent_pos": [T,N,2], "agent_dir": [T,N]}), flattened t-major."""

    def embed(desc: dict, frozen: dict) -> torch.Tensor:
        pos = desc["agent_pos"].reshape(-1, 2).long()
        dirs = desc["agent_dir"].reshape(-1).long()
        idx = (pos[:, 0] * height + pos[:, 1]) * 4 + dirs
        return frozen["text_table"][idx]

    return embed


def encode_texts(clip_params: dict, cfg: CLIPConfig, descriptions: Sequence[str],
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Host tokenization, the text tower (K2 and K3 on the GPU) and L2 norm
    (`clip_ppo_utils.py:132-139`): [B, embed_dim] float32 on the weights'
    device. Forward only."""
    device = clip_params["text"]["token_embedding"].device
    tokens = torch.as_tensor(tokenize(list(descriptions)), device=device)
    with torch.no_grad():
        feats = clip_model_mod.encode_text(clip_params, cfg, tokens, compute_dtype)
        return l2_normalize(feats.float())


def encode_images(clip_params: dict, cfg: CLIPConfig, images_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] → L2-normalized [B, embed_dim] float32 CLIP
    features: /255, antialiased bilinear resize to ``cfg.image_size``, CLIP
    normalization, the vision tower (K2 and K5 on the GPU), L2 norm
    (`clip_ppo_utils.py:141-164`). Forward only."""
    with torch.no_grad():
        x = preprocess_for_clip(images_uint8.float() / 255.0, cfg.image_size)
        return l2_normalize(clip_model_mod.encode_image(clip_params, cfg, x))


def make_encode_images_fn(cfg: CLIPConfig):
    """Per-iteration image-embedding fn of the MiniGrid image modality:
    ``(obs_uint8, frozen) -> [B, embed_dim]`` L2-normalized, with the CLIP
    weights in ``frozen["clip"]``."""

    def embed(obs: torch.Tensor, frozen: dict) -> torch.Tensor:
        return encode_images(frozen["clip"], cfg, obs)

    return embed


def generate_clip_embeddings(ablation_mode: AblationMode, clip_params: Optional[dict],
                             cfg: Optional[CLIPConfig], modality: str, batch_size: int,
                             gen: Optional[torch.Generator] = None,
                             descriptions: Optional[Sequence[str]] = None,
                             images: Optional[torch.Tensor] = None, embed_dim: int = 512,
                             compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dispatch on ablation mode and modality (`clip_ppo_utils.py:100-167`):
    RANDOM_ENCODER → normalized Gaussian embeddings drawn from ``gen``;
    text → tokenize + encode; image → preprocess + encode. Always
    L2-normalized float32."""
    if ablation_mode == AblationMode.RANDOM_ENCODER:
        if gen is None:
            raise ValueError("RANDOM_ENCODER needs a generator")
        return make_random_embed_fn(batch_size, embed_dim)(gen)
    if modality == "text":
        if descriptions is None:
            raise ValueError("descriptions required for text modality")
        return encode_texts(clip_params, cfg, descriptions, compute_dtype)
    if modality == "image":
        if images is None:
            raise ValueError("images required for image modality")
        return encode_images(clip_params, cfg, images)
    raise ValueError(f"Invalid modality: {modality}. Must be 'image' or 'text'")


def get_frozen_clip_features(clip_params: dict, cfg: CLIPConfig, x: torch.Tensor,
                             compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Frozen-CLIP visual features (`clip_ppo_utils.py:185-217`): [B, H, W, 3]
    float in [0, 1] → resize to ``cfg.image_size`` + CLIP normalization →
    the vision tower in ``compute_dtype`` (bfloat16 by default: K2 and K3 in
    bf16 on the GPU at ViT-B/32) → float32 features, not normalized. Under
    ``torch.no_grad()``, the counterpart of the JAX package's
    ``stop_gradient``: no gradient reaches the tower."""
    with torch.no_grad():
        x = preprocess_for_clip(x, cfg.image_size)
        return clip_model_mod.encode_image(clip_params, cfg, x, compute_dtype)


def make_frozen_clip_features_fn(cfg: CLIPConfig, compute_dtype: torch.dtype = torch.bfloat16):
    """FeatureFn of the FROZEN_CLIP ablation on RGB observations: the
    agent's trunk becomes the frozen vision tower
    (`clip_ppo_minigrid.py:219-227`), whose weights arrive in
    ``frozen["clip"]`` (cast once with ``model.cast_tower``); the agent's own
    conv trunk goes unused and keeps its initial values."""

    def features(params: dict, obs: torch.Tensor, frozen: dict) -> torch.Tensor:
        del params  # the trunk is the frozen CLIP tower
        return get_frozen_clip_features(frozen["clip"], cfg, obs.float() / 255.0, compute_dtype)

    return features


def stack_to_rgb_frames(obs: torch.Tensor) -> torch.Tensor:
    """[B, H, W, S] grayscale frame stacks → [B·S, H, W, 3] RGB frames
    (`convert_atari_frames_for_clip`, `clip_ppo_atari.py:249-269`): each
    frame's gray channel replicated to RGB, frames interleaved per stack
    (b0f0..b0f3, b1f0..)."""
    b, h, w, s = obs.shape
    frames = obs.permute(0, 3, 1, 2).reshape(b * s, h, w, 1)
    return frames.expand(b * s, h, w, 3)


def multiframe_clip_embeddings(clip_params: dict, cfg: CLIPConfig, obs: torch.Tensor,
                               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[B, H, W, S] uint8 stacks → [B, S·embed_dim] concatenated per-frame
    CLIP features, not normalized, in ONE pass of the vision tower over the
    B·S frames (`process_multiframe_clip_embeddings`,
    `clip_ppo_atari.py:272-299`). In ``compute_dtype`` (bf16 by default: K2
    and K3 in bf16 on the GPU at ViT-B/32), under ``torch.no_grad()``."""
    b = obs.shape[0]
    frames = stack_to_rgb_frames(obs).float() / 255.0
    return get_frozen_clip_features(clip_params, cfg, frames, compute_dtype).reshape(b, -1)


def make_frozen_clip_stack_features_fn(cfg: CLIPConfig,
                                       compute_dtype: torch.dtype = torch.bfloat16):
    """FeatureFn of the Atari FROZEN_CLIP ablation: per-frame frozen CLIP
    features, concatenated and put through the trainable
    ``temporal_projection`` (`clip_ppo_atari.py:211-228`), the only
    parameters its gradient reaches. The tower's weights arrive in
    ``frozen["clip"]`` (cast once with ``model.cast_tower``)."""

    def features(params: dict, obs: torch.Tensor, frozen: dict) -> torch.Tensor:
        concat = multiframe_clip_embeddings(frozen["clip"], cfg, obs, compute_dtype)
        return cnn.dense(params["temporal_projection"], concat)

    return features


def make_multiframe_embed_fn(cfg: CLIPConfig, compute_dtype: torch.dtype = torch.bfloat16):
    """Per-iteration embedding fn of the Atari image modality:
    ``(obs_stack_uint8 [B, H, W, S], frozen) -> [B, S·embed_dim]``, each
    frame's features L2-normalized before the concatenation
    (`clip_ppo_atari.py:272-299`); the B·S frames go through the tower in
    one call. The CLIP weights arrive in ``frozen["clip"]``."""

    def embed(obs: torch.Tensor, frozen: dict) -> torch.Tensor:
        b, s = obs.shape[0], obs.shape[-1]
        emb = multiframe_clip_embeddings(frozen["clip"], cfg, obs, compute_dtype)
        return l2_normalize(emb.reshape(b, s, -1)).reshape(b, -1)

    return embed


def make_random_embed_fn(batch_size: int, embed_dim: int = 512, frames: int = 1):
    """RANDOM_ENCODER embeddings (`clip_ppo_utils.py:126-129`):
    ``(gen, normals=None) -> [batch_size, frames·embed_dim]`` standard
    normals, each frame's L2-normalized, then concatenated (the Atari
    multi-frame layout). ``normals`` ([batch_size·frames, embed_dim]) are
    drawn from ``gen`` unless given."""

    def embed(gen: torch.Generator, normals: torch.Tensor | None = None) -> torch.Tensor:
        if normals is None:
            normals = torch.randn((batch_size * frames, embed_dim), generator=gen,
                                  device=gen.device)
        return l2_normalize(normals).reshape(batch_size, frames * embed_dim)

    return embed


def verbose_debug_print(iteration: int, clip_lambda: float, ent_coef: float, vf_coef: float,
                        scalars: dict) -> None:
    """The reference's per-iteration verbose loss block for the first
    minibatch of the first epoch, with the un-warmed λ
    (`clip_ppo_minigrid.py:546-552`)."""
    pg = float(scalars["first_pg_loss"])
    v = float(scalars["first_v_loss"])
    ent = float(scalars["first_entropy"])
    cl = float(scalars["first_clip_loss"])
    print(f"Iter {iteration}")
    print(f"Weighted CLIP loss: {clip_lambda * cl:>15.10f}")
    print(f"PPO loss:           {pg:>15.10f}")
    print(f"Combined loss: {pg - ent_coef * ent + v * vf_coef + clip_lambda * cl:.6f}")
    print("---")


@dataclasses.dataclass
class ClipPPOConfig:
    """Shared CLIP-PPO flags (`clip_ppo_utils.py:220-240`)."""

    clip_lambda: float = 0.00001
    """coefficient for CLIP alignment loss"""
    clip_model: str = "ViT-B/32"
    """CLIP model variant to use"""
    clip_modality: str = "text"
    """CLIP modality to use for alignment: 'image' or 'text'"""
    ablation_mode: AblationMode = AblationMode.NONE
    """ablation mode for controlled experiments"""
    apply_disturbances: bool = False
    """whether to apply visual disturbances during training"""
    disturbance_severity: str = "MODERATE"
    """disturbance severity level: MILD, MODERATE, HARD, SEVERE"""
