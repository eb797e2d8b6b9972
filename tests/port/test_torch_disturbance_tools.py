"""The disturbance tools against the JAX package, on the CPU:
``benchmark_disturbances`` (per-image against batched, its rows and its
chained calls) and ``disturbances_test`` (the panels, each stage's and the
combined one, with the draws rebuilt from the JAX tool's key splits; the
test card; the PNG).

Tolerance: the panels agree to 1e-5 (the JAX blur is two convolutions, the
port's a sum over gathered taps: the same products summed in another
order; values in [0, 1]), and the uint8 tiles the JAX tool saves to within
one level (a value that close to a level's edge may truncate either way).
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.cli import disturbances_test as jtool
from clip_ppo_tpu.ops.disturbances import _cutout_patch_hw
from clip_ppo_tpu_torch.cli import benchmark_disturbances as tbench
from clip_ppo_tpu_torch.cli import disturbances_test as ttool


def test_benchmark_rows_on_the_cpu(capsys):
    rows = tbench.main(["--no-cuda", "--batch-sizes", "1", "3", "--iterations", "2",
                        "--height", "20", "--width", "24"])
    out = capsys.readouterr().out
    assert [r["batch"] for r in rows] == [1, 3]
    for r in rows:
        assert r["per_image_ms"] > 0 and r["batched_ms"] > 0 and np.isfinite(r["speedup"])
        assert r["launches"] == 0  # the plain versions on the CPU
    assert "on cpu" in out and out.count("x\n") == 2


def test_benchmark_chains_each_output_into_the_next_call(monkeypatch):
    """Each timed call takes the previous call's output, as the JAX scan's
    carry does, and draws afresh from the generator."""
    seen = []
    real = tbench.disturb_auto

    def spy(x, params, gen, semantics="batched"):
        seen.append((semantics, x.clone()))
        return real(x, params, gen, semantics=semantics)

    monkeypatch.setattr(tbench, "disturb_auto", spy)
    tbench.main(["--no-cuda", "--batch-sizes", "2", "--iterations", "3", "--height", "16",
                 "--width", "16"])
    per_image = [x for s, x in seen if s == "per_image"]
    batched = [x for s, x in seen if s == "batched"]
    assert len(per_image) == len(batched) == 6  # a warm-up chain and a timed one
    assert torch.equal(per_image[0], per_image[3]) and torch.equal(batched[0], per_image[0])
    assert not torch.equal(per_image[0], per_image[1])  # chained


def test_benchmark_refuses_cuda_without_a_gpu():
    with pytest.raises(RuntimeError):
        tbench.main(["--batch-sizes", "1", "--iterations", "1"])


def test_card_equals_jax():
    np.testing.assert_array_equal(ttool.test_card(64), jtool.test_card(64))


def _jax_draws(seed: int, shape, params) -> dict:
    """The draws the JAX tool takes inside its stage functions, rebuilt from
    its key splits (`disturbances_test.py`: noise, contrast, cutout,
    combined; the combined key split in three)."""
    k_noise, k_contrast, k_cutout, k_combined = jax.random.split(jax.random.PRNGKey(seed), 4)
    lo, hi = params.contrast_range
    _, h, w, _ = shape
    ph, pw = _cutout_patch_hw(h, w, params.cutout_ratio)

    def stage(kn, kc, ko):
        kh, kw = jax.random.split(ko)
        return {
            "noise": torch.as_tensor(np.array(jax.random.normal(kn, shape, jnp.float32))),
            "factor": torch.as_tensor(np.asarray(
                jax.random.uniform(kc, (), jnp.float32, minval=lo, maxval=hi))),
            "origin": torch.as_tensor(np.stack([
                np.asarray(jax.random.randint(kh, (), 0, max(1, h - ph + 1))),
                np.asarray(jax.random.randint(kw, (), 0, max(1, w - pw + 1)))])),
        }

    kc = jax.random.split(k_combined, 3)
    return {"stages": stage(k_noise, k_contrast, k_cutout), "combined": stage(*kc)}


class _CapturePanels:
    """Stands in for PIL in the JAX tool: the panels it would paste."""

    def __init__(self):
        self.tiles = []
        outer = self

        class Image:
            @staticmethod
            def new(*a, **k):
                return Canvas()

            @staticmethod
            def fromarray(a):
                return a

        class Canvas:
            def paste(self, tile, at):
                outer.tiles.append(tile)

            def save(self, path):
                pass

        class ImageDraw:
            @staticmethod
            def Draw(canvas):  # noqa: N802
                class D:
                    def text(self, *a, **k):
                        pass
                return D()

        self.module = type(sys)("PIL")
        self.module.Image, self.module.ImageDraw = Image, ImageDraw


@pytest.mark.parametrize("argv", [
    [],
    ["--no-blur", "--severity", "SEVERE"],
    ["--no-noise", "--no-contrast", "--cutout-ratio", "0.2", "--blur-sigma", "1.5"],
])
def test_panels_match_jax(monkeypatch, argv):
    """The port's panels, fed the JAX tool's draws, against the JAX tool's
    own run (read where it hands its uint8 tiles to PIL): within one level,
    since a value within 1e-5 of a level's edge may truncate either way."""
    from clip_ppo_tpu.utils import flags as jflags
    from clip_ppo_tpu_torch.utils import flags as tflags

    size = 48
    jargs = jflags.parse(jtool.DisturbanceTestArgs, [*argv, "--size", str(size)])
    targs = tflags.parse(ttool.DisturbanceTestArgs, [*argv, "--size", str(size), "--no-cuda"])
    params = ttool.resolve_test_params(targs)
    img = ttool.test_card(size)
    draws = _jax_draws(targs.seed, (1, size, size, 3), params)
    got = ttool.compute_panels(torch.as_tensor(img), params, targs, draws)

    capture = _CapturePanels()
    monkeypatch.setitem(sys.modules, "PIL", capture.module)
    jtool.run(jargs)
    want = capture.tiles
    assert len(got) == len(want)
    for (name, panel), tile in zip(got, want):
        assert panel.shape == (size, size, 3), name
        ours = (np.clip(panel.numpy(), 0, 1) * 255).astype(np.uint8).astype(int)
        assert np.abs(ours - tile.astype(int)).max() <= 1, name


def test_panel_values_match_jax_stage_functions():
    from clip_ppo_tpu.ops import disturbances as jd

    size = 40
    targs = ttool.DisturbanceTestArgs(size=size, cuda=False)
    params = ttool.resolve_test_params(targs)
    img = ttool.test_card(size)
    draws = _jax_draws(targs.seed, (1, size, size, 3), params)
    got = dict(ttool.compute_panels(torch.as_tensor(img), params, targs, draws))
    x = jnp.asarray(img)[None]
    k_noise, k_contrast, k_cutout, k_combined = jax.random.split(jax.random.PRNGKey(42), 4)
    kc = jax.random.split(k_combined, 3)
    y = jd.apply_gaussian_noise(x, kc[0], params.gaussian_noise_sigma)
    y = jd.apply_contrast_blend(y, kc[1], params.contrast_range)
    y = jd.apply_gaussian_blur(y, params.gaussian_blur_sigma, params.blur_kernel_size)
    y = jd.apply_cutout_shared(y, kc[2], params.cutout_ratio)
    want = {
        "noise": jd.apply_gaussian_noise(x, k_noise, params.gaussian_noise_sigma),
        "contrast": jd.apply_contrast_blend(x, k_contrast, params.contrast_range),
        "blur": jd.apply_gaussian_blur(x, params.gaussian_blur_sigma, params.blur_kernel_size),
        "cutout": jd.apply_cutout_shared(x, k_cutout, params.cutout_ratio),
        "combined": y,
    }
    assert list(got) == ["original", *want]
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w)[0], rtol=0, atol=1e-5,
                                   err_msg=name)


def test_run_writes_the_panel_png(tmp_path, capsys):
    out = tmp_path / "sub" / "panel.png"
    path = ttool.main(["--no-cuda", "--size", "32", "--output", str(out), "--no-contrast"])
    assert path == str(out) and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    from PIL import Image

    assert Image.open(out).size == (5 * (32 + 4) - 4, 32 + 14)  # original, 3 stages, combined
    assert "panels=['original', 'noise', 'blur', 'cutout', 'combined']" in capsys.readouterr().out


def test_panels_need_pil_only_to_save(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "PIL", None)
    targs = ttool.DisturbanceTestArgs(size=16, cuda=False)
    params = ttool.resolve_test_params(targs)
    x = torch.as_tensor(ttool.test_card(16))
    gen = torch.Generator()
    gen.manual_seed(targs.seed)
    panels = ttool.compute_panels(x, params, targs, ttool.draw_panel_inputs(x[None], params, gen))
    assert [n for n, _ in panels] == ["original", "noise", "contrast", "blur", "cutout",
                                      "combined"]
    with pytest.raises(ImportError):
        ttool.save_panels([(n, p.numpy()) for n, p in panels], str(tmp_path / "x.png"))
