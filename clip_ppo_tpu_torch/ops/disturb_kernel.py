"""K1: the batched disturbance as one hand-written CUDA kernel.

Replaces ``clip_ppo_tpu/ops/pallas_disturb.py::_disturb_kernel`` (entry
``disturb_pallas``). The kernel (``csrc/disturb.cu``) splits each image over
a thread-block cluster of :data:`CLUSTER_CTAS` CTAs, each holding a band of
rows and its blur halo in shared memory from its one read to its one write;
see the note at the top of that file for what bounds it on Hopper and why it
is laid out so.

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

# CTAs of the cluster that takes one image: 16, past the portable 8, so the
# rollout's 8 images fill 128 of the H100's 132 SMs (csrc/disturb.cu).
CLUSTER_CTAS = 16
# Dynamic shared memory one CTA can use on Hopper (bytes), less the kernel's
# static shared memory.
_SMEM_LIMIT = 232_448 - 1024


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
                    draws: DisturbanceDraws, ctas: int = CLUSTER_CTAS) -> torch.Tensor:
    """Noise → contrast → blur → cutout on ``[B, H, W, C]`` float32 in [0,1].

    With ``draws.noise`` given, the kernel reads it (exact parity with the
    plain version); without it, the kernel draws the noise itself from a
    Philox stream keyed by ``draws.seed`` and the image index. On the GPU
    each image takes a cluster of ``ctas`` CTAs (1 to 16), each a band of
    ``ceil(H / ctas)`` rows.
    """
    if x.device.type == "cpu":
        return disturb_batched_plain(x, params, draws)
    if x.device.type != "cuda":
        raise ValueError(f"disturb_batched: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("disturb_batched: x must be a contiguous float32 [B,H,W,C] tensor")
    b, h, w, c = x.shape
    ksize = params.blur_kernel_size
    half = ksize // 2
    if not 1 <= ctas <= 16 or not 1 <= b <= 65_535:
        raise ValueError(f"disturb_batched: the kernel takes 1 to 16 CTAs an image and 1 to "
                         f"65,535 images, got {ctas} and {b}")
    if not half < min(h, w):
        raise ValueError(f"disturb_batched: a {ksize}-tap reflect-101 blur needs H and W above "
                         f"{half}, got {h}x{w}")
    band = -(-h // ctas)
    if c * w * (2 * band + 2 * half) * 4 > _SMEM_LIMIT:
        raise ValueError(f"disturb_batched: a band of {band} rows of a {h}x{w}x{c} image with "
                         f"its {half}-row halo on each side does not fit in shared memory")
    noise = draws.noise
    if noise is not None and (noise.shape != x.shape or noise.dtype != torch.float32
                              or noise.device != x.device or not noise.is_contiguous()):
        raise ValueError("disturb_batched: noise must match x (contiguous float32, same device)")
    if noise is None and draws.seed is None and params.gaussian_noise_sigma > 0.0:
        raise ValueError("disturb_batched: give either the noise or a seed")
    for name, t, dtype, n in (("seed", draws.seed, torch.int32, 1),
                              ("origin", draws.origin, torch.int32, 2),
                              ("factor", draws.factor, torch.float32, 1)):
        if t is not None and (t.dtype != dtype or t.numel() != n or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"disturb_batched: {name} must be {n} contiguous {dtype} on "
                             f"{x.device}")
    ph, pw = _cutout_patch_hw(h, w, params.cutout_ratio)
    taps = _taps(params.gaussian_blur_sigma, ksize, x.device)
    out = torch.empty_like(x)
    cuda_build.launch(
        "disturb", "disturb_launch",
        x.data_ptr(), cuda_build.ptr(noise), cuda_build.ptr(draws.seed),
        draws.origin.data_ptr(), draws.factor.data_ptr(), taps.data_ptr(), out.data_ptr(),
        b, h, w, c, float(params.gaussian_noise_sigma), ksize, ph, pw, ctas,
        cuda_build.stream_handle(x.device),
    )
    cuda_build.LAUNCHES["disturb"] += 1
    return out


def empty_launch(b: int, device: torch.device, ctas: int = CLUSTER_CTAS) -> None:
    """An empty kernel on :func:`disturb_batched`'s grid and clusters for
    ``b`` images: the floor a launch of K1 can reach (not counted)."""
    cuda_build.launch("disturb", "disturb_empty_launch", b, ctas, cuda_build.stream_handle(device))


def kernel_normals(n: int, seed: int, image: int, device: torch.device) -> torch.Tensor:
    """The first ``n`` standard normals of the kernel's noise stream for
    ``image`` under ``seed`` (for checking their distribution on the card)."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    cuda_build.launch("disturb", "philox_normal_launch", out.data_ptr(), seed, image, n,
                      cuda_build.stream_handle(device))
    return out
