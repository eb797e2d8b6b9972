"""CLIP-PPO shared utilities: λ warmup, the alignment loss, the MiniGrid
description-embedding table and the per-iteration image embeddings.

Port of the parts of ``clip_ppo_tpu/models/clip_utils.py`` the text and
image modalities run (reference `shared/clip_ppo_utils.py:13-240`).
FROZEN_CLIP trunks and the RANDOM_ENCODER embeddings come with later
slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
