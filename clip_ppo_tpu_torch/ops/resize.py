"""Image resize ops: the integer-factor nearest upscale MiniGrid observations
use (the 7×7 symbolic view → 84×84, gymnasium ``ResizeObservation``
INTER_AREA at exact integer zoom, `ppo_minigrid.py:114`). The antialiased
224 resize and CLIP normalization come with the image-modality slice."""

from __future__ import annotations

import torch


def upscale_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbor integer upscale of ``[..., H, W, C]`` by ``factor``."""
    x = torch.repeat_interleave(x, factor, dim=-3)
    return torch.repeat_interleave(x, factor, dim=-2)
