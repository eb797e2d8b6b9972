"""K5's plain version, K2 at the vision tower's width, and the routing
rules of the port's resblock against the JAX package.

The JAX side runs ``fused_mlp_block`` and ``fused_attn_block`` in interpret
mode. ``[2, 5, 768]`` in float32 puts 2·768·3072·4 = 18.9 MB of MLP weights
over the 12 MiB budget, so ``fused_mlp_block`` takes ``_mlp_stream_p``, the
weight-streaming kernel (a spy on it proves the route). LayerNorm scales
and biases and every projection bias are drawn at random, so a dropped or
misread one shows. Weights carry across with ``convert.clip_params``.
Tolerance 1e-4 absolute and relative: float32 sums of 768 and 3,072
products taken in another order, on outputs of magnitude ~1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.models.clip import model as jmodel
from clip_ppo_tpu.models.clip import pallas_block
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.models.clip import block_kernels as bk
from clip_ppo_tpu_torch.models.clip import model as tmodel

WIDTH, HEADS = 768, 12


@pytest.fixture(scope="module")
def vision_block():
    """One ViT-B/32 resblock (D = 768) in the JAX package's layout, at
    OpenAI's init scales, with random LN affines and biases."""
    rng = np.random.RandomState(4)
    n = lambda *shape, std=1.0: (std * rng.randn(*shape)).astype(np.float32)  # noqa: E731
    d = WIDTH
    jp = {
        "ln_1": {"scale": 1.0 + n(d, std=0.1), "bias": n(d, std=0.1)},
        "ln_2": {"scale": 1.0 + n(d, std=0.1), "bias": n(d, std=0.1)},
        "attn": {"in_proj_w": n(3 * d, d, std=d ** -0.5), "in_proj_b": n(3 * d, std=0.1),
                 "out_proj_w": n(d, d, std=d ** -0.5), "out_proj_b": n(d, std=0.1)},
        "mlp": {"fc_w": n(4 * d, d, std=(2 * d) ** -0.5), "fc_b": n(4 * d, std=0.1),
                "proj_w": n(d, 4 * d, std=d ** -0.5), "proj_b": n(d, std=0.1)},
    }
    return jp, convert.clip_params(jp)


def test_mlp_stream_plain_matches_jax_stream_kernel(vision_block, monkeypatch):
    jp, tp = vision_block
    monkeypatch.delenv("CLIP_PPO_MLP_STREAM", raising=False)
    monkeypatch.delenv("CLIP_PPO_MLP_CHUNKED", raising=False)
    calls = []
    real = pallas_block._mlp_stream_p

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(pallas_block, "_mlp_stream_p", spy)
    x = np.random.RandomState(1).randn(2, 5, WIDTH).astype(np.float32)
    want = np.asarray(pallas_block.fused_mlp_block(jnp.asarray(x), jp["ln_2"], jp["mlp"],
                                                   interpret=True))
    assert calls == [(2, 5, WIDTH)]  # the JAX package took K5 at this width
    xt = torch.as_tensor(x)
    got = bk.mlp_stream(xt, tp["ln_2"], tp["mlp"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    routed = bk.mlp_block(xt, tp["ln_2"], tp["mlp"]).numpy()
    np.testing.assert_array_equal(routed, got)
    assert np.abs(got - x).max() > 0.1  # the MLP moved the residual stream


def test_attn_block_plain_matches_jax_at_vision_width(vision_block):
    jp, tp = vision_block
    x = np.random.RandomState(2).randn(2, 50, WIDTH).astype(np.float32)
    want = pallas_block.fused_attn_block(jnp.asarray(x), jp["ln_1"], jp["attn"], HEADS,
                                         causal=False, interpret=True)
    got = bk.attn_block(torch.as_tensor(x), tp["ln_1"], tp["attn"], HEADS, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("width,stream", [(512, False), (768, True), (1024, True)])
def test_mlp_route_matches_jax_rule(width, stream, monkeypatch):
    # The kernel fused_mlp_block picks for float32 at this width, traced
    # only: spies stand in for both kernels.
    monkeypatch.delenv("CLIP_PPO_MLP_STREAM", raising=False)
    monkeypatch.delenv("CLIP_PPO_MLP_CHUNKED", raising=False)
    taken = []
    for name in ("_mlp_stream_p", "_mlp_block_p"):
        monkeypatch.setattr(pallas_block, name, lambda x, *a, name=name: taken.append(name) or x)
    d4 = 4 * width
    spec = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)  # noqa: E731
    jax.eval_shape(
        lambda x, ln, mlp: pallas_block.fused_mlp_block(x, ln, mlp, interpret=True),
        spec(1, 2, width), {"scale": spec(width), "bias": spec(width)},
        {"fc_w": spec(d4, width), "fc_b": spec(d4), "proj_w": spec(width, d4),
         "proj_b": spec(width)})
    assert taken == ["_mlp_stream_p" if stream else "_mlp_block_p"]
    assert bk.uses_mlp_stream(width, d4, 4) is stream


@pytest.mark.parametrize("width,block", [(512, True), (768, True), (1024, False)])
def test_attention_route_matches_jax_rule(width, block, monkeypatch):
    monkeypatch.setattr(jmodel.jax, "default_backend", lambda: "tpu")
    assert jmodel._use_fused_block("auto", None, 64, width) is block
    assert bk.uses_attn_block(width) is block


def test_mlp_stream_refuses_other_devices(vision_block):
    _, tp = vision_block
    x = torch.zeros(1, 2, WIDTH, device="meta")
    with pytest.raises(ValueError, match="mlp_stream: unsupported device"):
        bk.mlp_stream(x, tp["ln_2"], tp["mlp"])
    with pytest.raises(ValueError, match="mlp_stream: unsupported device"):
        bk.mlp_block(x, tp["ln_2"], tp["mlp"])


def test_resblock_wider_than_k2_raises_off_the_cpu():
    """D = 1024 takes K4 for attention (``attention_kernels.fused_qkv_attention``),
    whose wrapper, like every kernel wrapper, raises on a device that is
    neither the CPU nor CUDA."""
    z = lambda *shape: torch.zeros(*shape, device="meta")  # noqa: E731
    d = 1024
    p = {"ln_1": {"scale": z(d), "bias": z(d)}, "ln_2": {},
         "attn": {"in_proj_w": z(3 * d, d), "in_proj_b": z(3 * d),
                  "out_proj_w": z(d, d), "out_proj_b": z(d)}, "mlp": {}}
    with pytest.raises(ValueError, match="fused_qkv_attention: unsupported device meta"):
        tmodel.resblock(p, z(1, 3, d), 16)
