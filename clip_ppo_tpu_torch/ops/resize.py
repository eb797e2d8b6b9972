"""Image resize and normalization ops.

Port of ``clip_ppo_tpu/ops/resize.py``:

* :func:`upscale_nearest` — the integer-factor nearest upscale MiniGrid
  observations use (the 7×7 symbolic view → 84×84, gymnasium
  ``ResizeObservation`` INTER_AREA at exact integer zoom,
  `ppo_minigrid.py:114`).
* :func:`resize_bilinear_antialias` — the antialiased bilinear resize that
  feeds CLIP at 224×224 (`shared/clip_ppo_utils.py:151-157,206`). The JAX
  package computes it with ``jax.image.resize(method="linear",
  antialias=True)``; here it is ``F.interpolate(mode="bilinear",
  align_corners=False, antialias=True)``, the reference's own call.
* :func:`clip_normalize` / :func:`preprocess_for_clip` — CLIP's ImageNet
  normalization constants (`shared/clip_ppo_utils.py:21-22`).

Public functions keep the JAX package's ``[..., H, W, C]`` layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_bilinear_antialias(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of ``[..., H, W, C]`` to ``size=(H', W')``."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    nchw = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    out = F.interpolate(nchw, size=tuple(size), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.permute(0, 2, 3, 1).reshape(*lead, size[0], size[1], c)


def upscale_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbor integer upscale of ``[..., H, W, C]`` by ``factor``."""
    x = torch.repeat_interleave(x, factor, dim=-3)
    return torch.repeat_interleave(x, factor, dim=-2)


def clip_normalize(x: torch.Tensor) -> torch.Tensor:
    """Apply CLIP's channel normalization to ``[..., H, W, 3]`` in [0, 1]."""
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def preprocess_for_clip(x: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] float [0, 1] → resized to ``size`` and CLIP-normalized
    (`clip_ppo_utils.py:149-160`)."""
    return clip_normalize(resize_bilinear_antialias(x, (size, size)))
