"""Visual disturbances with the batched semantics the CLIP-PPO scripts train
with (`shared/disturbances_gpu.py:66-73`): Gaussian noise clamped to [0,1],
contrast jitter blending toward the per-image gray mean with one factor per
call, separable Gaussian blur with BORDER_REFLECT_101 padding, and one
cutout rectangle shared by the batch.

Images are ``[B, H, W, C]`` float tensors in [0, 1] (NHWC, the JAX
package's layout). Every random quantity is an explicit input of the stage
functions; :func:`disturb_auto` draws them from a ``torch.Generator`` unless
the caller hands them over (:class:`DisturbanceDraws`), so a test can feed
two implementations the same draws. The whole chain runs as one kernel on a
CUDA tensor (:mod:`clip_ppo_tpu_torch.ops.disturb_kernel`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from clip_ppo_tpu_torch.ops.severity import DisturbanceParams

# Luma weights used by torchvision's rgb_to_grayscale, which ColorJitter's
# contrast adjustment blends toward (`disturbances_gpu.py:63` behavior).
_LUMA = np.array([0.2989, 0.587, 0.114], dtype=np.float32)


def gaussian_kernel_1d(sigma: float, ksize: int) -> np.ndarray:
    """Normalized 1-D Gaussian taps; matches torchvision/cv2 construction."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _cutout_patch_hw(h: int, w: int, ratio: float) -> tuple[int, int]:
    """Patch height/width from an area ratio (`shared/disturbances.py:130-133`)."""
    patch_area = int(h * w * ratio)
    if patch_area == 0:
        return 0, 0  # degenerate ratio → no cutout
    patch_h = int(np.sqrt(patch_area))
    patch_w = patch_area // patch_h
    return patch_h, patch_w


class DisturbanceDraws(NamedTuple):
    """The random inputs of one batched disturbance call.

    ``noise``: [B, H, W, C] standard normals (None: the CUDA kernel draws
    them itself from ``seed``); ``factor``: 0-d contrast factor;
    ``origin``: int32 [2] cutout (row, col); ``seed``: int32 [1] seed of the
    in-kernel noise. All live on the images' device."""

    noise: Optional[torch.Tensor]
    factor: torch.Tensor
    origin: torch.Tensor
    seed: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Stages — batched [B, H, W, C] float [0, 1]
# ---------------------------------------------------------------------------


def apply_gaussian_noise(x: torch.Tensor, noise: torch.Tensor, sigma: float) -> torch.Tensor:
    """Additive Gaussian noise, clamped to [0,1] (torchvision GaussianNoise)."""
    return torch.clamp(x + sigma * noise, 0.0, 1.0)


def apply_contrast_blend(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Contrast jitter toward the per-image gray mean, ONE factor per call
    (torchvision ColorJitter on the whole batch, `disturbances_gpu.py:110`)."""
    if x.shape[-1] == 3:
        luma = torch.as_tensor(_LUMA, device=x.device)
        mean = (x * luma).sum(-1).mean(dim=(1, 2)).reshape(-1, 1, 1, 1)
    else:
        mean = x.mean(dim=(1, 2, 3)).reshape(-1, 1, 1, 1)
    return torch.clamp(factor * x + (1.0 - factor) * mean, 0.0, 1.0)


def _reflect101_index(n: int, ksize: int, device) -> torch.Tensor:
    """[n, ksize] source indices of each tap under BORDER_REFLECT_101."""
    half = ksize // 2
    idx = torch.arange(n, device=device)[:, None] + torch.arange(ksize, device=device)[None, :] - half
    idx = torch.where(idx < 0, -idx, idx)
    return torch.where(idx >= n, 2 * n - 2 - idx, idx)


def apply_gaussian_blur(x: torch.Tensor, sigma: float, ksize: int) -> torch.Tensor:
    """Separable Gaussian blur with BORDER_REFLECT_101 padding: each output
    sums ``ksize`` taps over reflected neighbours, along H and then W."""
    taps = torch.as_tensor(gaussian_kernel_1d(sigma, ksize), device=x.device)
    _, h, w, _ = x.shape
    rows = _reflect101_index(h, ksize, x.device)             # [H, K]
    x = (x[:, rows] * taps[None, None, :, None, None]).sum(2)  # [B,H,K,W,C] → [B,H,W,C]
    cols = _reflect101_index(w, ksize, x.device)             # [W, K]
    return (x[:, :, cols] * taps[None, None, None, :, None]).sum(3)


def apply_cutout_shared(x: torch.Tensor, origin: torch.Tensor, ratio: float) -> torch.Tensor:
    """Zero one rectangle at ``origin`` = (row, col), shared by the batch
    (`shared/disturbances_gpu.py:157-172`)."""
    _, h, w, _ = x.shape
    ph, pw = _cutout_patch_hw(h, w, ratio)
    r0, c0 = origin[0], origin[1]
    rows = torch.arange(h, device=x.device).reshape(1, h, 1, 1)
    cols = torch.arange(w, device=x.device).reshape(1, 1, w, 1)
    inside = (rows >= r0) & (rows < r0 + ph) & (cols >= c0) & (cols < c0 + pw)
    return torch.where(inside, torch.zeros_like(x), x)


# ---------------------------------------------------------------------------
# Draws and the full pipeline
# ---------------------------------------------------------------------------


def draw(x: torch.Tensor, params: DisturbanceParams,
         generator: torch.Generator) -> DisturbanceDraws:
    """Draw one call's random inputs on ``x``'s device: the noise itself on
    the CPU, a seed for the kernel's own generator on CUDA."""
    _, h, w, _ = x.shape
    lo, hi = params.contrast_range
    dev = x.device
    factor = torch.rand((), generator=generator, device=dev) * (hi - lo) + lo
    ph, pw = _cutout_patch_hw(h, w, params.cutout_ratio)
    origin = torch.stack([
        torch.randint(0, max(1, h - ph + 1), (), generator=generator, device=dev),
        torch.randint(0, max(1, w - pw + 1), (), generator=generator, device=dev),
    ]).to(torch.int32)
    if dev.type == "cuda":
        seed = torch.randint(0, 2**31 - 1, (1,), generator=generator, device=dev,
                             dtype=torch.int32)
        return DisturbanceDraws(None, factor, origin, seed)
    noise = torch.randn(x.shape, generator=generator, device=dev)
    return DisturbanceDraws(noise, factor, origin)


def disturb_auto(
    x: torch.Tensor,
    params: DisturbanceParams,
    generator: Optional[torch.Generator] = None,
    draws: Optional[DisturbanceDraws] = None,
) -> torch.Tensor:
    """Batched-semantics noise → contrast → blur → cutout on ``[B,H,W,C]``
    floats in [0,1]. ``draws`` (else drawn from ``generator``) supplies
    every random input. On a CUDA tensor this is one launch of the K1
    kernel; on a CPU tensor its plain version."""
    from clip_ppo_tpu_torch.ops.disturb_kernel import disturb_batched

    if draws is None:
        draws = draw(x, params, generator)
    return disturb_batched(x, params, draws)
