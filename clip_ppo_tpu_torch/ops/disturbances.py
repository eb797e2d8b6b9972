"""Visual disturbances (noise → contrast → blur → cutout), port of
``clip_ppo_tpu/ops/disturbances.py``, in the reference's two semantics:

* **batched** — the path the CLIP-PPO scripts train with
  (`shared/disturbances_gpu.py:66-73`): Gaussian noise clamped to [0,1],
  contrast jitter blending toward the per-image gray mean with one factor
  per call, separable Gaussian blur with BORDER_REFLECT_101 padding, and
  one cutout rectangle shared by the batch. On a CUDA tensor the whole
  chain is one launch of the K1 kernel
  (:mod:`clip_ppo_tpu_torch.ops.disturb_kernel`).
* **per_image** — the path the vanilla MiniGrid script uses
  (`shared/disturbances.py:45-67`): a multiplicative contrast factor and a
  cutout origin per image, with uint8 quantization between stages. Plain
  PyTorch on any device; it never reaches K1, which computes the batched
  function.
* **stack_frames** — the Atari script's, on ``[B, H, W, S]`` grayscale
  frame stacks (`clip_ppo_atari.py:568-584`): the batched pipeline applied
  to each of the S frames on its own, each with its own draws (noise,
  contrast factor, cutout origin, shared by the batch within a frame). On a
  CUDA tensor each frame is one launch of K1 on a contiguous [B, H, W, 1]
  copy, with its own seed for the in-kernel noise.

Images are ``[B, H, W, C]`` float tensors in [0, 1] (NHWC, the JAX
package's layout). Every random quantity is an explicit input of the stage
functions; :func:`disturb_auto` draws them from a ``torch.Generator`` unless
the caller hands them over (:class:`DisturbanceDraws`), so a test can feed
two implementations the same draws.
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


SEMANTICS = ("batched", "per_image", "stack_frames")


class DisturbanceDraws(NamedTuple):
    """The random inputs of one disturbance call, on the images' device
    (``stack_frames`` takes a sequence of them, one a frame).

    ``noise``: [B, H, W, C] standard normals (batched only: None lets the
    CUDA kernel draw them itself from ``seed``); ``factor``: the contrast
    factor, 0-d (batched) or [B] (per_image); ``origin``: int32 cutout
    (row, col), [2] (batched) or [B, 2] (per_image); ``seed``: int32 [1]
    seed of the in-kernel noise."""

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


def apply_contrast_scale(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Plain multiplicative contrast with one factor per image ([B]) — the
    per-image path's math (`shared/disturbances.py:94-96`)."""
    return torch.clamp(factor.reshape(-1, 1, 1, 1) * x, 0.0, 1.0)


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


def apply_cutout_per_image(x: torch.Tensor, origin: torch.Tensor, ratio: float) -> torch.Tensor:
    """Zero one rectangle per image at ``origin[b]`` = (row, col)
    (`shared/disturbances.py:135-145`)."""
    b, h, w, _ = x.shape
    ph, pw = _cutout_patch_hw(h, w, ratio)
    r0 = origin[:, 0].reshape(b, 1, 1, 1)
    c0 = origin[:, 1].reshape(b, 1, 1, 1)
    rows = torch.arange(h, device=x.device).reshape(1, h, 1, 1)
    cols = torch.arange(w, device=x.device).reshape(1, 1, w, 1)
    inside = (rows >= r0) & (rows < r0 + ph) & (cols >= c0) & (cols < c0 + pw)
    return torch.where(inside, torch.zeros_like(x), x)


def cutout_origin_high(h: int, w: int, ratio: float, semantics: str) -> tuple[int, int]:
    """Exclusive upper bounds of the cutout origin's (row, col): the batched
    path draws from ``[0, h - ph]``, the per-image path keeps the
    reference's ``randint(0, max(1, h - ph))`` and never reaches the last
    row or column a patch fits at."""
    ph, pw = _cutout_patch_hw(h, w, ratio)
    extra = 1 if semantics == "batched" else 0
    return max(1, h - ph + extra), max(1, w - pw + extra)


def _quantize_floor(x: torch.Tensor) -> torch.Tensor:
    """uint8 quantization by truncation (``ndarray.astype``), back on [0,1]."""
    return torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0


def disturb_per_image(x: torch.Tensor, params: DisturbanceParams,
                      draws: DisturbanceDraws) -> torch.Tensor:
    """The per-image pipeline in plain PyTorch: noise, floor-quantize,
    per-image contrast, floor-quantize, blur, round-quantize (cv2 rounds its
    blurred uint8 results), per-image cutout."""
    x = _quantize_floor(apply_gaussian_noise(x, draws.noise, params.gaussian_noise_sigma))
    x = _quantize_floor(apply_contrast_scale(x, draws.factor))
    x = apply_gaussian_blur(x, params.gaussian_blur_sigma, params.blur_kernel_size)
    x = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0
    return apply_cutout_per_image(x, draws.origin, params.cutout_ratio)


# ---------------------------------------------------------------------------
# Draws and the full pipeline
# ---------------------------------------------------------------------------


def check_semantics(semantics: str) -> None:
    """Raise unless ``semantics`` is one of :data:`SEMANTICS`."""
    if semantics not in SEMANTICS:
        raise ValueError(f"unknown semantics: {semantics!r}")


def draw(x: torch.Tensor, params: DisturbanceParams, generator: torch.Generator,
         semantics: str = "batched"):
    """Draw one call's random inputs on ``x``'s device. Batched: the noise
    itself on the CPU, a seed for the kernel's own generator on CUDA.
    Per-image: the noise, a factor and an origin per image. Stack-frames: a
    tuple of the batched draws of each [B, H, W, 1] frame, in frame order."""
    check_semantics(semantics)
    if semantics == "stack_frames":
        frame = x[..., :1]
        return tuple(draw(frame, params, generator) for _ in range(x.shape[-1]))
    b, h, w, _ = x.shape
    lo, hi = params.contrast_range
    dev = x.device
    per_image = semantics == "per_image"
    shape = (b,) if per_image else ()
    factor = torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo
    high_r, high_c = cutout_origin_high(h, w, params.cutout_ratio, semantics)
    origin = torch.stack([
        torch.randint(0, high_r, shape, generator=generator, device=dev),
        torch.randint(0, high_c, shape, generator=generator, device=dev),
    ], dim=-1).to(torch.int32)
    if dev.type == "cuda" and not per_image:
        seed = torch.randint(0, 2**31 - 1, (1,), generator=generator, device=dev,
                             dtype=torch.int32)
        return DisturbanceDraws(None, factor, origin, seed)
    noise = torch.randn(x.shape, generator=generator, device=dev)
    return DisturbanceDraws(noise, factor, origin)


def disturb(x: torch.Tensor, params: DisturbanceParams, draws,
            semantics: str = "batched") -> torch.Tensor:
    """The full pipeline on ``[B,H,W,C]`` floats in [0,1] with the given
    draws. ``"batched"`` is one launch of K1 on a CUDA tensor and its plain
    version on a CPU tensor; ``"per_image"`` is plain PyTorch everywhere;
    ``"stack_frames"`` runs the batched pipeline once a frame, each frame
    (a contiguous [B, H, W, 1] copy) with its own entry of ``draws``."""
    check_semantics(semantics)
    if semantics == "per_image":
        return disturb_per_image(x, params, draws)
    from clip_ppo_tpu_torch.ops.disturb_kernel import disturb_batched

    if semantics == "stack_frames":
        if len(draws) != x.shape[-1]:
            raise ValueError(f"stack_frames: {len(draws)} draws for {x.shape[-1]} frames")
        return torch.cat([disturb_batched(x[..., s:s + 1].contiguous(), params, d)
                          for s, d in enumerate(draws)], dim=-1)
    return disturb_batched(x, params, draws)


def disturb_auto(
    x: torch.Tensor,
    params: DisturbanceParams,
    generator: Optional[torch.Generator] = None,
    draws: Optional[DisturbanceDraws] = None,
    semantics: str = "batched",
) -> torch.Tensor:
    """:func:`disturb` with ``draws`` (else drawn from ``generator``)
    supplying every random input."""
    if draws is None:
        draws = draw(x, params, generator, semantics)
    return disturb(x, params, draws, semantics)


def disturb_uint8(
    x: torch.Tensor,
    params: DisturbanceParams,
    generator: Optional[torch.Generator] = None,
    draws: Optional[DisturbanceDraws] = None,
    semantics: str = "batched",
) -> torch.Tensor:
    """Convenience wrapper: uint8 ``[B, H, W, C]`` in, uint8 out."""
    y = disturb_auto(x.float() / 255.0, params, generator, draws, semantics)
    return (torch.clamp(y, 0.0, 1.0) * 255.0).to(torch.uint8)
