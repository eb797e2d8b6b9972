"""CLIP model configurations (ViT-B/32, ViT-L/14).

Architecture hyperparameters of OpenAI CLIP's released checkpoints, which
the reference loads through `clip.load(name)` (`clip_ppo_utils.py:90`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    # shared
    embed_dim: int
    # vision tower
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text tower
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


CLIP_CONFIGS = {
    "ViT-B/32": CLIPConfig(
        embed_dim=512, patch_size=32, vision_width=768, vision_layers=12,
        vision_heads=12, text_width=512, text_heads=8, text_layers=12,
    ),
    "ViT-B/16": CLIPConfig(
        embed_dim=512, patch_size=16, vision_width=768, vision_layers=12,
        vision_heads=12, text_width=512, text_heads=8, text_layers=12,
    ),
    "ViT-L/14": CLIPConfig(
        embed_dim=768, patch_size=14, vision_width=1024, vision_layers=24,
        vision_heads=16, text_width=768, text_heads=12, text_layers=12,
    ),
}
