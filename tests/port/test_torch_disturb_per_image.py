"""The per-image disturbance of the vanilla MiniGrid script, against the JAX
package's ``disturb(..., "per_image")`` on the same draws.

The draws are recomputed with the JAX pipeline's own key splits
(``k_noise, k_contrast, k_cutout = split(key, 3)``,
``clip_ppo_tpu/ops/disturbances.py:222``; ``kh, kw = split(k_cutout)``,
:159). Every stage but the blur is elementwise and equal in the two
packages. The blur sums its taps in another order than XLA's convolution,
and its result is rounded to a uint8 level, so a pixel whose blurred value
lies within round-off of a half level may round the other way. Tolerance:
no element further apart than one level (1/255, plus 1e-6 of float
round-off), and at most 2 in 10,000 elements a level apart (measured: at
most 3 of 84,672 at [4, 84, 84, 3] over 3 seeds a severity).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.ops import disturbances as jd
from clip_ppo_tpu.ops.severity import DisturbanceSeverity, SEVERITY_CONFIGS
from clip_ppo_tpu_torch.ops import disturb_kernel
from clip_ppo_tpu_torch.ops import disturbances as td
from clip_ppo_tpu_torch.ops import wrapper as twrapper
from clip_ppo_tpu_torch.ops.severity import SEVERITY_CONFIGS as TSEVERITY
from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity as TSev

SEVERITIES = ("MILD", "MODERATE", "HARD", "SEVERE")
LEVEL_TOL = 1 / 255 + 1e-6
MAX_SHARE_OFF = 2e-4


def jax_per_image_draws(key, shape, params) -> td.DisturbanceDraws:
    """The draws of `disturb(x, key, params, "per_image")`."""
    b, h, w, _ = shape
    k_noise, k_contrast, k_cutout = jax.random.split(key, 3)
    lo, hi = params.contrast_range
    factor = jax.random.uniform(k_contrast, (b, 1, 1, 1), jnp.float32, minval=lo, maxval=hi)
    ph, pw = jd._cutout_patch_hw(h, w, params.cutout_ratio)
    kh, kw = jax.random.split(k_cutout)
    sh = jax.random.randint(kh, (b, 1, 1, 1), 0, max(1, h - ph))
    sw = jax.random.randint(kw, (b, 1, 1, 1), 0, max(1, w - pw))
    origin = np.stack([np.asarray(sh).reshape(b), np.asarray(sw).reshape(b)], -1)
    return td.DisturbanceDraws(torch.as_tensor(np.array(jax.random.normal(k_noise, shape))),
                               torch.as_tensor(np.array(factor).reshape(b)),
                               torch.as_tensor(origin.astype(np.int32)))


def assert_levels_close(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got - want)
    assert diff.max() <= LEVEL_TOL, diff.max() * 255
    assert (diff > 1e-6).mean() <= MAX_SHARE_OFF, (diff > 1e-6).sum()


@pytest.mark.parametrize("severity", SEVERITIES)
def test_per_image_matches_jax(severity):
    params = SEVERITY_CONFIGS[DisturbanceSeverity[severity]]
    rs = np.random.RandomState(len(severity))
    x = (rs.randint(0, 256, (4, 84, 84, 3)) / 255.0).astype(np.float32)
    key = jax.random.PRNGKey(len(severity))
    # Op by op: the severities share every compiled op but the blur's.
    want = np.asarray(jd.disturb.__wrapped__(jnp.asarray(x), key, params, "per_image"))
    draws = jax_per_image_draws(key, x.shape, params)
    got = td.disturb(torch.as_tensor(x), TSEVERITY[TSev[severity]], draws, "per_image")
    assert got.shape == x.shape and got.dtype == torch.float32
    assert_levels_close(got.numpy(), want)
    # Every value is a uint8 level: the pipeline ends on a rounding.
    levels = got.numpy() * 255.0
    np.testing.assert_allclose(levels, np.round(levels), atol=1e-3)


def test_per_image_cutout_matches_jax_and_keeps_the_exclusive_bound():
    """Per-image origins as the reference draws them, randint(0, max(1,
    h - ph)): the last row and column a patch fits at are never drawn,
    where the batched path's bound h - ph + 1 reaches them."""
    h = w = 12
    ratio = 0.25  # a 6x6 patch: origins 0..5 per-image, 0..6 batched
    ph, pw = jd._cutout_patch_hw(h, w, ratio)
    assert td.cutout_origin_high(h, w, ratio, "per_image") == (h - ph, w - pw)
    assert td.cutout_origin_high(h, w, ratio, "batched") == (h - ph + 1, w - pw + 1)
    params = td.DisturbanceParams(0.0, 1.0, (1.0, 1.0), ratio)
    gen = torch.Generator()
    gen.manual_seed(0)
    x = torch.rand(2048, h, w, 1, generator=gen)
    origins = td.draw(x, params, gen, "per_image").origin
    assert origins.shape == (2048, 2) and origins.dtype == torch.int32
    assert set(origins[:, 0].tolist()) == set(range(h - ph))
    assert set(origins[:, 1].tolist()) == set(range(w - pw))
    batched = {tuple(td.draw(x[:1], params, gen).origin.tolist()) for _ in range(400)}
    assert max(r for r, _ in batched) == h - ph  # the batched bound reaches it
    # The stage itself against the JAX package's, on the JAX draws.
    key = jax.random.PRNGKey(4)
    want = np.asarray(jd.apply_cutout_per_image(jnp.asarray(x[:8].numpy()), key, ratio))
    kh, kw = jax.random.split(key)
    sh = np.asarray(jax.random.randint(kh, (8, 1, 1, 1), 0, max(1, h - ph))).reshape(8)
    sw = np.asarray(jax.random.randint(kw, (8, 1, 1, 1), 0, max(1, w - pw))).reshape(8)
    origin = torch.as_tensor(np.stack([sh, sw], -1).astype(np.int32))
    np.testing.assert_array_equal(td.apply_cutout_per_image(x[:8], origin, ratio).numpy(), want)


def test_per_image_never_reaches_k1(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the per-image semantics reached K1's wrapper")

    monkeypatch.setattr(disturb_kernel, "disturb_batched", refuse)
    gen = torch.Generator()
    gen.manual_seed(1)
    x = torch.rand(2, 84, 84, 3, generator=gen)
    y = td.disturb_auto(x, TSEVERITY[TSev.HARD], gen, semantics="per_image")
    assert y.shape == x.shape
    with pytest.raises(AssertionError, match="K1"):
        td.disturb_auto(x, TSEVERITY[TSev.HARD], gen)


def test_stack_frames_is_refused_by_name():
    """The Atari slice lifted the refusal of ``stack_frames`` (its parity
    with the JAX package: ``test_torch_atari_clip.py``): it disturbs each
    frame of the stack; a semantics of no slice is refused by name."""
    x = torch.rand(1, 84, 84, 4)
    y = td.disturb_auto(x, TSEVERITY[TSev.MILD], torch.Generator(), semantics="stack_frames")
    assert y.shape == x.shape and not torch.equal(y, x)
    with pytest.raises(ValueError, match="unknown semantics"):
        td.disturb_auto(x, TSEVERITY[TSev.MILD], torch.Generator(), semantics="per_frame")


def test_disturb_uint8_and_the_wrappers():
    """``disturb_uint8`` is the float pipeline quantized back to uint8; the
    per-image wrapper takes HWC or NHWC uint8 and the batched wrapper BCHW
    or NHWC floats, each reproducible from its seed."""
    rs = np.random.RandomState(3)
    frames = rs.randint(0, 256, (2, 84, 84, 3)).astype(np.uint8)
    params = TSEVERITY[TSev.MODERATE]
    gen = torch.Generator()
    gen.manual_seed(5)
    draws = td.draw(torch.zeros(2, 84, 84, 3), params, gen, "per_image")
    y8 = td.disturb_uint8(torch.as_tensor(frames), params, draws=draws, semantics="per_image")
    yf = td.disturb(torch.as_tensor(frames).float() / 255.0, params, draws, "per_image")
    np.testing.assert_array_equal(y8.numpy(), (yf * 255.0).to(torch.uint8).numpy())

    per_image = twrapper.create_disturbance_wrapper(use_gpu=False, seed=7, severity="MODERATE")
    assert isinstance(per_image, twrapper.DisturbanceWrapper)
    one = per_image.apply_disturbances(frames[0])
    assert one.shape == (84, 84, 3) and one.dtype == np.uint8
    again = twrapper.DisturbanceWrapper(seed=7, severity="MODERATE").apply_disturbances(frames[0])
    np.testing.assert_array_equal(one, again)
    assert per_image.apply_disturbances(frames).shape == (2, 84, 84, 3)

    batched = twrapper.create_disturbance_wrapper(seed=7, severity="HARD")
    bchw = torch.as_tensor(frames).permute(0, 3, 1, 2).float() / 255.0
    out = batched.apply_disturbances(bchw)
    assert out.shape == bchw.shape
    nhwc = twrapper.DisturbanceWrapperGPU(seed=7, severity="HARD").apply_disturbances(
        bchw.permute(0, 2, 3, 1), channel_last=True)
    torch.testing.assert_close(out.permute(0, 2, 3, 1), nhwc, rtol=0, atol=0)
    for helper in ("apply_gaussian_noise_numpy", "apply_contrast_jitter_numpy",
                   "apply_gaussian_blur_numpy", "apply_cutout_numpy", "apply_disturbances_numpy"):
        img = getattr(batched, helper)(frames[0])
        assert img.shape == (84, 84, 3) and img.dtype == np.uint8, helper
