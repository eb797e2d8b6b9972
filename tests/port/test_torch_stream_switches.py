"""K6 and K7's plain versions and the weight-streaming switches against the
JAX package.

One resblock of a tower of width 1024 (ViT-L/14's vision tower) or 768 (its
text tower), made by the JAX package's ``init_clip_params`` with its
LayerNorm affines and biases drawn from a numpy seed (so a dropped one
shows), carried across by ``convert.clip_params``. The JAX side runs
``fused_attn_block_stream`` and ``fused_mlp_block`` under
``CLIP_PPO_MLP_CHUNKED=1`` in interpret mode, and ``_mlp_block_ref`` for
``CLIP_PPO_MLP_STREAM=0``. Tolerance 2e-5 absolute and relative, as
``tests/test_pallas_block.py`` holds those kernels against their references
(float32 sums of up to 4,096 products in another order).

Routing: for every switch setting, ``model.resblock`` of each package is
run with its kernel wrappers replaced by recorders, and the port must call
the wrapper that the JAX rule names. The JAX rule takes these routes only
on a TPU at batch >= 64, so its side runs at batch 64 with
``jax.default_backend`` reporting "tpu"; the port routes "auto" by width
alone (ROADMAP.md, known differences).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.models.clip import CLIPConfig
from clip_ppo_tpu.models.clip import model as jmodel
from clip_ppo_tpu.models.clip import pallas_attention as jpa
from clip_ppo_tpu.models.clip import pallas_block as jpb
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.models.clip import block_kernels as bk
from clip_ppo_tpu_torch.models.clip import model as tmodel

SWITCH_VARS = ("CLIP_PPO_ATTN_STREAM", "CLIP_PPO_MLP_CHUNKED", "CLIP_PPO_MLP_STREAM")
BOTH = {"CLIP_PPO_ATTN_STREAM": "1", "CLIP_PPO_MLP_CHUNKED": "1"}


def _block(width: int, seed: int):
    cfg = CLIPConfig(embed_dim=32, image_size=32, patch_size=16, vision_width=width,
                     vision_layers=1, vision_heads=width // 64, text_width=64, text_heads=1,
                     text_layers=1, vocab_size=64)
    jp = jmodel.init_clip_params(jax.random.PRNGKey(seed), cfg)["visual"]["transformer"]
    jp = jax.tree_util.tree_map(np.asarray, jp["resblocks"][0])
    rng = np.random.RandomState(seed)
    for ln in ("ln_1", "ln_2"):
        jp[ln]["scale"] = (1 + 0.1 * rng.randn(width)).astype(np.float32)
        jp[ln]["bias"] = (0.1 * rng.randn(width)).astype(np.float32)
    for part, key in (("attn", "in_proj_b"), ("attn", "out_proj_b"), ("mlp", "fc_b"),
                      ("mlp", "proj_b")):
        jp[part][key] = (0.1 * rng.randn(*jp[part][key].shape)).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, jp), convert.clip_params(jp)


@pytest.fixture(scope="module")
def blocks():
    return {1024: _block(1024, 12), 768: _block(768, 14)}


@pytest.fixture
def no_switches(monkeypatch):
    for var in SWITCH_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_attn_stream_plain_matches_jax(blocks, causal):
    jp, tp = blocks[1024]
    x = _x((3, 7, 1024), 3)
    got = bk.attn_stream(torch.as_tensor(x), tp["ln_1"], tp["attn"], 16, causal).numpy()
    want = jpb.fused_attn_block_stream(jnp.asarray(x), jp["ln_1"], jp["attn"], 16,
                                       causal=causal, block_batches=2, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("width, shape", [(1024, (3, 5, 1024)), (768, (2, 9, 768))])
def test_mlp_chunked_plain_matches_jax(blocks, no_switches, width, shape):
    no_switches.setenv("CLIP_PPO_MLP_CHUNKED", "1")
    jp, tp = blocks[width]
    x = _x(shape, 4)
    got = bk.mlp_block(torch.as_tensor(x), tp["ln_2"], tp["mlp"]).numpy()
    want = jpb.fused_mlp_block(jnp.asarray(x), jp["ln_2"], jp["mlp"], interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_mlp_stream_off_gives_the_reference(blocks, no_switches):
    no_switches.setenv("CLIP_PPO_MLP_STREAM", "0")
    jp, tp = blocks[1024]
    x = _x((3, 5, 1024), 5)
    got = bk.mlp_block(torch.as_tensor(x), tp["ln_2"], tp["mlp"]).numpy()
    m, ln, f32 = jp["mlp"], jp["ln_2"], jnp.float32
    want = jpb._mlp_block_ref(jnp.asarray(x), m["fc_w"].T, jpb._row(m["fc_b"], f32),
                              m["proj_w"].T, jpb._row(m["proj_b"], f32),
                              jpb._row(ln["scale"], f32), jpb._row(ln["bias"], f32), 1e-5)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    routed = jpb.fused_mlp_block(jnp.asarray(x), jp["ln_2"], jp["mlp"], interpret=True)
    np.testing.assert_array_equal(np.asarray(routed), np.asarray(want))


def _jax_route(mp, jp, x, heads, mask) -> set:
    calls = []

    def rec(name, out=lambda a: a[0]):
        def fn(*a, **k):
            calls.append(name)
            return out(a)
        return fn

    mp.setattr(jax, "default_backend", lambda: "tpu")
    mp.setattr(jpb, "fused_attn_block", rec("attn_block"))
    mp.setattr(jpb, "fused_attn_block_stream", rec("attn_stream"))
    mp.setattr(jpa, "fused_qkv_attention",
               rec("fused_qkv", lambda a: a[0][..., : a[0].shape[-1] // 3]))
    for name, key in (("_mlp_chunked_p", "mlp_chunked"), ("_mlp_stream_p", "mlp_stream"),
                      ("_mlp_block_p", "mlp_block"), ("_mlp_block_ref", "mlp_plain")):
        mp.setattr(jpb, name, rec(key))
    jmodel.resblock(jp, jnp.asarray(x), heads, mask, "auto")
    mlps = {"mlp_chunked", "mlp_stream", "mlp_block", "mlp_plain"}
    # Where no MLP entry point is called, resblock ran its inline plain MLP.
    return set(calls) | (set() if mlps & set(calls) else {"mlp_plain"})


def _port_route(mp, tp, x, heads, causal) -> set:
    calls = []

    def rec(name):
        return lambda x, *a, **k: calls.append(name) or x

    mp.setattr(tmodel, "attn_block", rec("attn_block"))
    mp.setattr(tmodel, "attn_stream", rec("attn_stream"))
    mp.setattr(tmodel, "fused_qkv_attention",
               lambda qkv, *a: calls.append("fused_qkv") or qkv[..., : qkv.shape[-1] // 3])
    for name, key in (("mlp_chunked", "mlp_chunked"), ("mlp_stream", "mlp_stream"),
                      ("mlp_block_resident", "mlp_block"), ("mlp_block_plain", "mlp_plain")):
        mp.setattr(bk, name, rec(key))
    tmodel.resblock(tp, torch.as_tensor(x), heads, causal, "auto")
    return set(calls)


# switches -> the wrappers a resblock calls: vision tower (D = 1024, no
# mask), text tower (D = 768, causal)
ROUTES = [
    ({}, {"fused_qkv", "mlp_stream"}, {"attn_block", "mlp_stream"}),
    ({"CLIP_PPO_ATTN_STREAM": "1"}, {"attn_stream", "mlp_stream"}, {"attn_block", "mlp_stream"}),
    ({"CLIP_PPO_MLP_CHUNKED": "1"}, {"fused_qkv", "mlp_chunked"}, {"attn_block", "mlp_chunked"}),
    (BOTH, {"attn_stream", "mlp_chunked"}, {"attn_block", "mlp_chunked"}),
    ({"CLIP_PPO_MLP_STREAM": "0"}, {"fused_qkv", "mlp_plain"}, {"attn_block", "mlp_plain"}),
    ({"CLIP_PPO_ATTN_STREAM": "1", "CLIP_PPO_MLP_STREAM": "0"}, {"attn_stream", "mlp_plain"},
     {"attn_block", "mlp_plain"}),
]


@pytest.mark.parametrize("tower", ["vision", "text"])
@pytest.mark.parametrize("switches, vision, text", ROUTES,
                         ids=[" ".join(f"{k}={v}" for k, v in r[0].items()) or "none"
                              for r in ROUTES])
def test_routes_follow_the_jax_rules(blocks, no_switches, switches, vision, text, tower):
    for var, value in switches.items():
        no_switches.setenv(var, value)
    width, want = (1024, vision) if tower == "vision" else (768, text)
    heads, causal = width // 64, tower == "text"
    jp, tp = blocks[width]
    x = _x((64, 2, width), 6)
    assert _jax_route(no_switches, jp, x, heads, "causal" if causal else None) == want
    assert _port_route(no_switches, tp, x, heads, causal) == want


def test_wrappers_refuse_other_devices(blocks):
    _, tp = blocks[1024]
    meta = torch.empty((2, 3, 1024), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bk.attn_stream(meta, tp["ln_1"], tp["attn"], 16)
    with pytest.raises(ValueError, match="unsupported device"):
        bk.mlp_chunked(meta, tp["ln_2"], tp["mlp"])
