"""Stateful wrapper API over the disturbance pipeline (reference surface).

Port of ``clip_ppo_tpu/ops/wrapper.py``. The reference exposes disturbances
through two wrapper classes and a factory (`shared/disturbances.py:11-67`,
`shared/disturbances_gpu.py:14-214`):

* ``DisturbanceWrapper(seed, severity).apply_disturbances(uint8 HWC)`` —
  per-image semantics, numpy in and out (computed on the CPU);
* ``DisturbanceWrapperGPU(device, seed, severity).apply_disturbances(float
  [B,C,H,W] in [0,1])`` — batched semantics on the tensor's device (one K1
  launch on a CUDA tensor), NHWC with ``channel_last=True``, plus the
  ``apply_*_numpy`` helpers its test script uses;
* ``create_disturbance_wrapper(use_gpu=...)`` factory
  (`disturbances_gpu.py:198-214`).

Both classes drive :mod:`clip_ppo_tpu_torch.ops.disturbances`; they hold a
``torch.Generator`` seeded with ``seed`` (one per device they have run on)
in place of the JAX package's key chain, and adapt layout and dtype. The
training CLIs call the pipeline directly inside the rollout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from clip_ppo_tpu_torch.ops import disturbances as D
from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity, resolve_params


class _Base:
    _semantics: str

    def __init__(
        self,
        seed: int = 0,
        severity: Optional[DisturbanceSeverity | str] = DisturbanceSeverity.MODERATE,
        **custom,
    ):
        self.params = resolve_params(severity, **custom)
        self.seed = seed
        self._generators: dict[torch.device, torch.Generator] = {}

    def _generator(self, device: torch.device) -> torch.Generator:
        if device not in self._generators:
            gen = torch.Generator(device=device)
            gen.manual_seed(self.seed)
            self._generators[device] = gen
        return self._generators[device]

    def _disturb(self, x: torch.Tensor) -> torch.Tensor:
        return D.disturb_auto(x, self.params, self._generator(x.device),
                              semantics=self._semantics)


def _to_uint8(y: torch.Tensor) -> np.ndarray:
    return (torch.clamp(y, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


class DisturbanceWrapper(_Base):
    """Per-image-semantics wrapper (`shared/disturbances.py:11-67`):
    uint8 HWC (or batched NHWC) in, uint8 out."""

    _semantics = "per_image"

    def apply_disturbances(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs)
        single = obs.ndim == 3
        x = torch.as_tensor(obs[None] if single else obs).float() / 255.0
        out = _to_uint8(self._disturb(x))
        return out[0] if single else out


class DisturbanceWrapperGPU(_Base):
    """Batched-semantics wrapper (`shared/disturbances_gpu.py:14-73`):
    float [B, C, H, W] in [0,1] in (torch layout), same out, on the input's
    device. Also accepts NHWC when ``channel_last=True``. ``device`` places
    the numpy helpers' work (the CPU when None)."""

    _semantics = "batched"

    def __init__(self, device=None, seed: int = 0,
                 severity=DisturbanceSeverity.MODERATE, **custom):
        super().__init__(seed=seed, severity=severity, **custom)
        self.device = torch.device(device if device is not None else "cpu")

    def apply_disturbances(self, obs: torch.Tensor, channel_last: bool = False) -> torch.Tensor:
        x = torch.as_tensor(obs, dtype=torch.float32)
        if not channel_last:
            x = x.permute(0, 2, 3, 1)  # BCHW → BHWC
        y = self._disturb(x.contiguous())
        return y if channel_last else y.permute(0, 3, 1, 2)

    # -- numpy helpers mirroring `disturbances_gpu.py:75-194` ----------------

    def _image(self, img: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img), device=self.device).float()[None] / 255.0

    def _single(self, img: np.ndarray, stage: str) -> np.ndarray:
        x = self._image(img)
        p = self.params
        gen = self._generator(x.device)
        if stage == "noise":
            noise = torch.randn(x.shape, generator=gen, device=x.device)
            y = D.apply_gaussian_noise(x, noise, p.gaussian_noise_sigma)
        elif stage == "contrast":
            y = D.apply_contrast_blend(x, D.draw(x, p, gen).factor)
        elif stage == "blur":
            y = D.apply_gaussian_blur(x, p.gaussian_blur_sigma, p.blur_kernel_size)
        elif stage == "cutout":
            y = D.apply_cutout_shared(x, D.draw(x, p, gen).origin, p.cutout_ratio)
        else:
            raise ValueError(stage)
        return _to_uint8(y[0])

    def apply_gaussian_noise_numpy(self, img: np.ndarray) -> np.ndarray:
        return self._single(img, "noise")

    def apply_contrast_jitter_numpy(self, img: np.ndarray) -> np.ndarray:
        return self._single(img, "contrast")

    def apply_gaussian_blur_numpy(self, img: np.ndarray) -> np.ndarray:
        return self._single(img, "blur")

    def apply_cutout_numpy(self, img: np.ndarray) -> np.ndarray:
        return self._single(img, "cutout")

    def apply_disturbances_numpy(self, img: np.ndarray) -> np.ndarray:
        return _to_uint8(self._disturb(self._image(img))[0])


def create_disturbance_wrapper(
    use_gpu: bool = True,
    device=None,
    seed: int = 0,
    severity=DisturbanceSeverity.MODERATE,
    **custom,
):
    """Factory mirroring `disturbances_gpu.py:198-214`: ``use_gpu`` picks
    the batched-semantics wrapper (the reference's GPU path)."""
    if use_gpu:
        return DisturbanceWrapperGPU(device=device, seed=seed, severity=severity, **custom)
    return DisturbanceWrapper(seed=seed, severity=severity, **custom)
