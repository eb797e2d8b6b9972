"""Visual disturbance check: per-stage and combined panels saved to disk.

Port of ``clip_ppo_tpu/cli/disturbances_test.py`` (the reference's
`shared/disturbances_test.py:16-209`): the input defaults to a generated
synthetic test card (checker + gradient + circles, which make noise, blur,
contrast and cutout each visibly obvious); every enabled disturbance is
applied on its own and then all of them combined, with the per-disturbance
toggles, the parameter overrides and the fixed default seed (42) of the JAX
tool. Two steps: :func:`compute_panels` runs the stages of
``ops/disturbances.py`` on the device (the GPU unless ``--no-cuda``) with
draws from a ``torch.Generator`` there, or with the draws it is handed;
:func:`save_panels` writes the side-by-side PNG and is the only step that
needs PIL.

Usage:
    python -m clip_ppo_tpu_torch.cli.disturbances_test --severity HARD
    python -m clip_ppo_tpu_torch.cli.disturbances_test --image path.png --no-blur
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from clip_ppo_tpu_torch.device import resolve_device
from clip_ppo_tpu_torch.ops.disturbances import (
    apply_contrast_blend,
    apply_cutout_shared,
    apply_gaussian_blur,
    apply_gaussian_noise,
    cutout_origin_high,
)
from clip_ppo_tpu_torch.ops.severity import DisturbanceParams, DisturbanceSeverity, resolve_params
from clip_ppo_tpu_torch.utils import flags


@dataclass
class DisturbanceTestArgs:
    """Configuration for the visual disturbance test."""

    image: Optional[str] = None
    """input image path (default: generated synthetic test card)"""
    output: str = "disturbance_test.png"
    """output panel path"""
    severity: str = "HARD"
    """severity preset: MILD, MODERATE, HARD, SEVERE"""
    # Per-disturbance toggles (reference `disturbances_test.py:28-39`).
    noise: bool = True
    """apply Gaussian noise"""
    contrast: bool = True
    """apply contrast jitter"""
    blur: bool = True
    """apply Gaussian blur"""
    cutout: bool = True
    """apply cutout"""
    # Parameter overrides (None → severity preset values).
    noise_sigma: Optional[float] = None
    """override Gaussian noise sigma"""
    blur_sigma: Optional[float] = None
    """override Gaussian blur sigma"""
    contrast_min: Optional[float] = None
    """override contrast range lower bound"""
    contrast_max: Optional[float] = None
    """override contrast range upper bound"""
    cutout_ratio: Optional[float] = None
    """override cutout area ratio"""
    seed: int = 42
    """PRNG seed"""
    size: int = 256
    """synthetic test-card size"""
    cuda: bool = True
    """compute the panels on the GPU (raises without one); --no-cuda on the CPU"""


def test_card(size: int) -> np.ndarray:
    """Synthetic RGB test image in [0,1]: gradient + checker + circles."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    r = 0.5 + 0.5 * np.sin(10 * np.pi * x) * np.sin(10 * np.pi * y)  # checker-ish
    img = np.stack([r, x, y], axis=-1)  # red checker, green and blue gradients
    rows, cols = np.mgrid[0:size, 0:size]
    cy, cx = size / 2, size / 2
    for rad, val in ((size * 0.3, 1.0), (size * 0.18, 0.0), (size * 0.08, 1.0)):
        img[(rows - cy) ** 2 + (cols - cx) ** 2 < rad**2] = val
    return np.clip(img, 0.0, 1.0)


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0


def resolve_test_params(args: DisturbanceTestArgs) -> DisturbanceParams:
    """The severity preset with the command line's overrides."""
    params = resolve_params(DisturbanceSeverity[args.severity])
    overrides = {}
    if args.noise_sigma is not None:
        overrides["gaussian_noise_sigma"] = args.noise_sigma
    if args.blur_sigma is not None:
        overrides["gaussian_blur_sigma"] = args.blur_sigma
    if args.contrast_min is not None or args.contrast_max is not None:
        lo, hi = params.contrast_range
        overrides["contrast_range"] = (
            args.contrast_min if args.contrast_min is not None else lo,
            args.contrast_max if args.contrast_max is not None else hi,
        )
    if args.cutout_ratio is not None:
        overrides["cutout_ratio"] = args.cutout_ratio
    return dataclasses.replace(params, **overrides)


def _stage_draws(x: torch.Tensor, params: DisturbanceParams, gen: torch.Generator) -> dict:
    lo, hi = params.contrast_range
    high_r, high_c = cutout_origin_high(x.shape[1], x.shape[2], params.cutout_ratio, "batched")
    dev = x.device
    return {
        "noise": torch.randn(x.shape, generator=gen, device=dev),
        "factor": torch.rand((), generator=gen, device=dev) * (hi - lo) + lo,
        "origin": torch.stack([torch.randint(0, high_r, (), generator=gen, device=dev),
                               torch.randint(0, high_c, (), generator=gen, device=dev)]),
    }


def draw_panel_inputs(x: torch.Tensor, params: DisturbanceParams,
                      gen: torch.Generator) -> dict:
    """The random inputs of every panel, on ``x``'s device: the noise, the
    contrast factor and the cutout origin of the single-stage panels
    (``stages``) and, drawn apart, of the combined panel (``combined``)."""
    return {"stages": _stage_draws(x, params, gen), "combined": _stage_draws(x, params, gen)}


def compute_panels(img: torch.Tensor, params: DisturbanceParams, args: DisturbanceTestArgs,
                   draws: dict) -> list[tuple[str, torch.Tensor]]:
    """(name, [H, W, 3] tensor) of the original, each enabled stage on its
    own, and the enabled stages combined in pipeline order (noise →
    contrast → blur → cutout), on ``img``'s device."""
    x = img[None]
    one, comb = draws["stages"], draws["combined"]
    sigma, ksize = params.gaussian_blur_sigma, params.blur_kernel_size
    stages = [
        ("noise", args.noise,
         lambda y, d: apply_gaussian_noise(y, d["noise"], params.gaussian_noise_sigma)),
        ("contrast", args.contrast, lambda y, d: apply_contrast_blend(y, d["factor"])),
        ("blur", args.blur, lambda y, d: apply_gaussian_blur(y, sigma, ksize)),
        ("cutout", args.cutout, lambda y, d: apply_cutout_shared(y, d["origin"],
                                                                 params.cutout_ratio)),
    ]
    panels = [("original", img)]
    panels += [(name, fn(x, one)[0]) for name, on, fn in stages if on]
    if any(on for _, on, _ in stages):
        y = x
        for _name, on, fn in stages:
            if on:
                y = fn(y, comb)
        panels.append(("combined", y[0]))
    return panels


def save_panels(panels: list[tuple[str, np.ndarray]], path: str) -> str:
    """Write the panels side by side, each captioned, as one PNG."""
    from PIL import Image, ImageDraw

    h, w = panels[0][1].shape[:2]
    pad, caption = 4, 14
    canvas = Image.new("RGB", (len(panels) * (w + pad) - pad, h + caption), "black")
    draw = ImageDraw.Draw(canvas)
    for i, (name, p) in enumerate(panels):
        tile = Image.fromarray((np.clip(p, 0, 1) * 255).astype(np.uint8))
        canvas.paste(tile, (i * (w + pad), caption))
        draw.text((i * (w + pad) + 2, 1), f"{name}", fill="white")
    out_dir = os.path.dirname(path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    canvas.save(path)
    return path


def run(args: DisturbanceTestArgs) -> str:
    device = resolve_device(args.cuda)
    params = resolve_test_params(args)
    img = load_image(args.image) if args.image else test_card(args.size)
    x = torch.as_tensor(img, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    panels = compute_panels(x, params, args, draw_panel_inputs(x[None], params, gen))
    save_panels([(name, p.cpu().numpy()) for name, p in panels], args.output)
    print(f"severity={args.severity} panels={[n for n, _ in panels]}")
    print(f"saved {args.output}")
    return args.output


def main(argv=None) -> str:
    return run(flags.parse(DisturbanceTestArgs, argv))


if __name__ == "__main__":
    main()
