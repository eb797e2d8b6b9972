"""Disturbance severity levels and parameter presets.

Mirrors the reference's severity schema (`shared/disturbance_types.py:8-43`):
five levels and, per level, the Gaussian-noise sigma, Gaussian-blur sigma,
contrast-jitter range and cutout area ratio. The numeric presets must stay
identical so that robustness results are comparable across frameworks.
"""

from __future__ import annotations

import dataclasses
from enum import Enum


class DisturbanceSeverity(Enum):
    """Disturbance severity levels."""

    NONE = "NONE"
    MILD = "MILD"
    MODERATE = "MODERATE"
    HARD = "HARD"
    SEVERE = "SEVERE"


@dataclasses.dataclass(frozen=True)
class DisturbanceParams:
    """Static (trace-time) parameters of the visual-disturbance pipeline.

    Frozen (hashable) so a preset can key caches; the blur kernel size
    derives from ``gaussian_blur_sigma``.
    """

    gaussian_noise_sigma: float
    gaussian_blur_sigma: float
    contrast_range: tuple[float, float]
    cutout_ratio: float

    @property
    def blur_kernel_size(self) -> int:
        """Odd kernel size, ``max(3, int(2*sigma)+1)`` rounded up to odd.

        Matches the reference's kernel-size rule used by both its CPU and
        GPU paths (`shared/disturbances.py:104-106`,
        `shared/disturbances_gpu.py:58-61`).
        """
        k = max(3, int(2 * self.gaussian_blur_sigma) + 1)
        if k % 2 == 0:
            k += 1
        return k


SEVERITY_CONFIGS: dict[DisturbanceSeverity, DisturbanceParams] = {
    DisturbanceSeverity.MILD: DisturbanceParams(
        gaussian_noise_sigma=0.08,
        gaussian_blur_sigma=1.0,
        contrast_range=(0.75, 1.25),
        cutout_ratio=0.10,
    ),
    DisturbanceSeverity.MODERATE: DisturbanceParams(
        gaussian_noise_sigma=0.12,
        gaussian_blur_sigma=2.0,
        contrast_range=(0.7, 1.3),
        cutout_ratio=0.17,
    ),
    DisturbanceSeverity.HARD: DisturbanceParams(
        gaussian_noise_sigma=0.13,
        gaussian_blur_sigma=2.1,
        contrast_range=(0.69, 1.31),
        cutout_ratio=0.18,
    ),
    DisturbanceSeverity.SEVERE: DisturbanceParams(
        gaussian_noise_sigma=0.26,
        gaussian_blur_sigma=3.0,
        contrast_range=(0.6, 1.4),
        cutout_ratio=0.25,
    ),
}


def resolve_params(
    severity: DisturbanceSeverity | str | None,
    *,
    gaussian_noise_sigma: float | None = None,
    gaussian_blur_sigma: float | None = None,
    contrast_range: tuple[float, float] | None = None,
    cutout_ratio: float | None = None,
) -> DisturbanceParams:
    """Resolve a severity level or a full set of custom overrides.

    Same contract as the reference wrappers' constructors
    (`shared/disturbances.py:31-43`): either a severity preset is given, or
    *all four* custom parameters must be provided.
    """
    if isinstance(severity, str):
        severity = DisturbanceSeverity[severity]
    if severity is not None and severity != DisturbanceSeverity.NONE:
        return SEVERITY_CONFIGS[severity]
    custom = (gaussian_noise_sigma, gaussian_blur_sigma, contrast_range, cutout_ratio)
    if None in custom:
        raise ValueError(
            "All custom parameters must not be None if not setting a severity."
        )
    return DisturbanceParams(
        gaussian_noise_sigma=gaussian_noise_sigma,
        gaussian_blur_sigma=gaussian_blur_sigma,
        contrast_range=tuple(contrast_range),
        cutout_ratio=cutout_ratio,
    )
