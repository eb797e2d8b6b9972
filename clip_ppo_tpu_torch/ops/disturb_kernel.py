"""K1: the batched disturbance as one hand-written CUDA kernel.

Replaces ``clip_ppo_tpu/ops/pallas_disturb.py::_disturb_kernel`` (entry
``disturb_pallas``). The kernel (``csrc/disturb.cu``) keeps each image in
shared memory from its one read to its one write; see the note at the top
of that file for what bounds it on Hopper and why it is laid out so.

:func:`disturb_batched` launches the kernel for a CUDA tensor and runs
:func:`disturb_batched_plain` for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import functools

import torch

from clip_ppo_tpu_torch import cuda_build
from clip_ppo_tpu_torch.ops.disturbances import (
    DisturbanceDraws,
    _cutout_patch_hw,
    apply_contrast_blend,
    apply_cutout_shared,
    apply_gaussian_blur,
    apply_gaussian_noise,
    gaussian_kernel_1d,
)
from clip_ppo_tpu_torch.ops.severity import DisturbanceParams

# Shared memory one block can use on Hopper (bytes); the kernel holds two
# planar copies of an image.
_SMEM_LIMIT = 232_448


def disturb_batched_plain(x: torch.Tensor, params: DisturbanceParams,
                          draws: DisturbanceDraws) -> torch.Tensor:
    """The four batched stages in plain PyTorch (the kernel's reference)."""
    if params.gaussian_noise_sigma > 0.0:
        if draws.noise is None:
            raise ValueError("the plain disturbance needs the noise as an input")
        x = apply_gaussian_noise(x, draws.noise, params.gaussian_noise_sigma)
    x = apply_contrast_blend(x, draws.factor)
    x = apply_gaussian_blur(x, params.gaussian_blur_sigma, params.blur_kernel_size)
    return apply_cutout_shared(x, draws.origin, params.cutout_ratio)


@functools.lru_cache(maxsize=16)
def _taps(sigma: float, ksize: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(gaussian_kernel_1d(sigma, ksize), device=device)


def disturb_batched(x: torch.Tensor, params: DisturbanceParams,
                    draws: DisturbanceDraws) -> torch.Tensor:
    """Noise → contrast → blur → cutout on ``[B, H, W, C]`` float32 in [0,1].

    With ``draws.noise`` given, the kernel reads it (exact parity with the
    plain version); without it, the kernel draws the noise itself from a
    Philox stream keyed by ``draws.seed`` and the image index.
    """
    if x.device.type == "cpu":
        return disturb_batched_plain(x, params, draws)
    if x.device.type != "cuda":
        raise ValueError(f"disturb_batched: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("disturb_batched: x must be a contiguous float32 [B,H,W,C] tensor")
    b, h, w, c = x.shape
    if 2 * h * w * c * 4 > _SMEM_LIMIT - 1024:
        raise ValueError(f"disturb_batched: a {h}x{w}x{c} image does not fit in shared memory")
    noise = draws.noise
    if noise is not None and (noise.shape != x.shape or noise.dtype != torch.float32
                              or noise.device != x.device or not noise.is_contiguous()):
        raise ValueError("disturb_batched: noise must match x (contiguous float32, same device)")
    if noise is None and draws.seed is None and params.gaussian_noise_sigma > 0.0:
        raise ValueError("disturb_batched: give either the noise or a seed")
    seed = draws.seed if draws.seed is not None else torch.zeros(1, dtype=torch.int32, device=x.device)
    iscalars = torch.cat([seed.reshape(1), draws.origin.reshape(2)]).to(torch.int32).contiguous()
    factor = draws.factor.reshape(1).to(torch.float32).contiguous()
    ph, pw = _cutout_patch_hw(h, w, params.cutout_ratio)
    ksize = params.blur_kernel_size
    taps = _taps(params.gaussian_blur_sigma, ksize, x.device)
    out = torch.empty_like(x)
    cuda_build.launch(
        "disturb", "disturb_launch",
        x.data_ptr(), cuda_build.ptr(noise), iscalars.data_ptr(), factor.data_ptr(),
        taps.data_ptr(), out.data_ptr(), b, h, w, c,
        float(params.gaussian_noise_sigma), ksize, ph, pw,
        cuda_build.stream_handle(x.device),
    )
    cuda_build.LAUNCHES["disturb"] += 1
    return out


def kernel_normals(n: int, seed: int, image: int, device: torch.device) -> torch.Tensor:
    """The first ``n`` standard normals of the kernel's noise stream for
    ``image`` under ``seed`` (for checking their distribution on the card)."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    cuda_build.launch("disturb", "philox_normal_launch", out.data_ptr(), seed, image, n,
                      cuda_build.stream_handle(device))
    return out
