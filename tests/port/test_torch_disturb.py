"""K1's plain version against the JAX package's disturbance.

``disturb_pallas(..., interpret=True)`` feeds its kernel host noise drawn
from ``k_seed``; the test recomputes that noise and the contrast factor and
cutout origin with the same ``jax.random`` splits as
``pallas_disturb.py:164-171`` and hands all of them to the port. The XLA
pipeline ``disturb(..., "batched")`` is matched the same way through its
own splits. Tolerance 2e-6 absolute on [0, 1] values: the blur sums the
same taps as a banded matmul (Pallas) or a convolution (XLA) in the JAX
package and as gathered taps here, so the sums round differently.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.ops.disturbances import _cutout_patch_hw, disturb
from clip_ppo_tpu.ops.pallas_disturb import disturb_pallas
from clip_ppo_tpu.ops.severity import DisturbanceSeverity, SEVERITY_CONFIGS
from clip_ppo_tpu_torch.ops import disturb_kernel
from clip_ppo_tpu_torch.ops.disturbances import DisturbanceDraws, disturb_auto

SEVERITIES = ("MILD", "MODERATE", "HARD", "SEVERE")


def _images(b, h, w, c, seed):
    return np.random.RandomState(seed).rand(b, h, w, c).astype(np.float32)


def _pallas_draws(key, x_shape, params):
    """The draws disturb_pallas makes (`pallas_disturb.py:164-171`, and
    the host noise of its interpret path), in the port's NHWC form."""
    b, h, w, c = x_shape
    k_seed, k_factor, k_cut = jax.random.split(key, 3)
    lo, hi = params.contrast_range
    factor = jax.random.uniform(k_factor, (), jnp.float32, lo, hi)
    ph, pw = _cutout_patch_hw(h, w, params.cutout_ratio)
    kh, kw = jax.random.split(k_cut)
    r0 = jax.random.randint(kh, (), 0, max(1, h - ph + 1), jnp.int32)
    c0 = jax.random.randint(kw, (), 0, max(1, w - pw + 1), jnp.int32)
    noise = jax.random.normal(k_seed, (b, c * h, w), jnp.float32)
    noise = np.moveaxis(np.asarray(noise).reshape(b, c, h, w), 1, -1).copy()
    return DisturbanceDraws(torch.as_tensor(noise), torch.tensor(float(factor)),
                            torch.tensor([int(r0), int(c0)], dtype=torch.int32))


def _xla_draws(key, x_shape, params):
    """The draws of `disturb(..., "batched")` (`disturbances.py:222-228`)."""
    _, h, w, _ = x_shape
    k_noise, k_contrast, k_cutout = jax.random.split(key, 3)
    lo, hi = params.contrast_range
    factor = jax.random.uniform(k_contrast, (), jnp.float32, minval=lo, maxval=hi)
    ph, pw = _cutout_patch_hw(h, w, params.cutout_ratio)
    kh, kw = jax.random.split(k_cutout)
    sh = jax.random.randint(kh, (), 0, max(1, h - ph + 1))
    sw = jax.random.randint(kw, (), 0, max(1, w - pw + 1))
    noise = np.array(jax.random.normal(k_noise, x_shape, jnp.float32))
    return DisturbanceDraws(torch.as_tensor(noise), torch.tensor(float(factor)),
                            torch.tensor([int(sh), int(sw)], dtype=torch.int32))


@pytest.mark.parametrize("channels", [1, 3, 4])  # 1 and 4: the channel mean
@pytest.mark.parametrize("severity", SEVERITIES)
def test_plain_matches_pallas_interpret(severity, channels):
    params = SEVERITY_CONFIGS[DisturbanceSeverity[severity]]
    x = _images(2, 28, 36, channels, seed=len(severity) + channels)
    key = jax.random.PRNGKey(11 + channels)
    want = np.asarray(disturb_pallas(jnp.asarray(x), key, params, interpret=True))
    draws = _pallas_draws(key, x.shape, params)
    got = disturb_kernel.disturb_batched(torch.as_tensor(x), params, draws)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("severity", ["MILD", "SEVERE"])
def test_plain_matches_xla_batched(severity):
    params = SEVERITY_CONFIGS[DisturbanceSeverity[severity]]
    x = _images(3, 84, 84, 3, seed=5)
    key = jax.random.PRNGKey(7)
    want = np.asarray(disturb(jnp.asarray(x), key, params, "batched"))
    got = disturb_auto(torch.as_tensor(x), params, draws=_xla_draws(key, x.shape, params))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


def test_cpu_draws_from_generator_and_stays_in_range():
    params = SEVERITY_CONFIGS[DisturbanceSeverity.HARD]
    x = torch.as_tensor(_images(2, 84, 84, 3, seed=1))
    gen = torch.Generator()
    gen.manual_seed(3)
    y1 = disturb_auto(x, params, gen)
    gen.manual_seed(3)
    y2 = disturb_auto(x, params, gen)
    assert torch.equal(y1, y2) and y1.shape == x.shape
    assert float(y1.min()) >= 0.0 and float(y1.max()) <= 1.0


def test_plain_needs_noise():
    params = SEVERITY_CONFIGS[DisturbanceSeverity.MILD]
    x = torch.zeros(1, 8, 8, 3)
    draws = DisturbanceDraws(None, torch.tensor(1.0), torch.tensor([0, 0], dtype=torch.int32))
    with pytest.raises(ValueError, match="noise"):
        disturb_kernel.disturb_batched(x, params, draws)
