"""K4/K8, K5, K6 and K7 in bfloat16: their plain versions against the JAX
package, the routes of ViT-L/14's towers in bf16 under every switch, the
towers' bf16 features, and the wrappers' bf16 contract.

The JAX side runs ``fused_qkv_attention``, ``packed_attention``,
``fused_mlp_block`` (taking ``_mlp_stream_p``, or ``_mlp_chunked_p`` under
``CLIP_PPO_MLP_CHUNKED=1``) and ``fused_attn_block_stream`` in interpret mode
on bf16 inputs; they cast the weights to bf16 themselves. The port's plain
versions take the same bf16 values (the weights cast once with
``model.cast_tower``). In bf16 the MLP weights of width 768 fit the TPU
kernels' 12 MiB budget (K3), so K5 and K7 are held at ViT-L/14's vision
width, 1024, at a few rows. LayerNorm affines and biases are drawn from a
numpy seed, so a dropped one shows.

Tolerance: (1/64) x max(1, max |ref|), compared in float32, as
``test_torch_bf16_blocks.py`` holds K2 and K3: about three bf16 ulps of the
largest value, since the two packages round in other places (the plain
versions round the scores and each product to bf16 where the TPU kernels
keep fp32 accumulators). The towers' L2-normalized features: 2e-2
absolute, the bound ``tests/test_clip.py`` puts on bf16 against float32.
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
from clip_ppo_tpu_torch import convert, cuda_build
from clip_ppo_tpu_torch.models.clip import attention_kernels as ak
from clip_ppo_tpu_torch.models.clip import block_kernels as bk
from clip_ppo_tpu_torch.models.clip import model as tmodel
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from test_torch_stream_switches import BOTH, SWITCH_VARS, _block, _jax_route, _port_route

BF16 = jnp.bfloat16


def _tol(ref: np.ndarray) -> float:
    return max(1.0, float(np.abs(ref).max())) / 64


def _f32(a) -> np.ndarray:
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, dtype=np.float32)


def _bf16(shape, seed: int):
    """The same bf16 values as a JAX array and a torch tensor."""
    x = jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32)).astype(BF16)
    return x, torch.as_tensor(np.asarray(x, dtype=np.float32)).to(torch.bfloat16)


@pytest.fixture(scope="module")
def blocks():
    """ViT-L/14's two widths, one resblock each: the JAX tree (float32;
    the JAX entry points cast to x's dtype) and the port's, cast to bf16."""
    out = {}
    for width, seed in ((1024, 12), (768, 14)):
        jp, tp = _block(width, seed)
        out[width] = (jp, tmodel.cast_tower(tp, torch.bfloat16))
    return out


@pytest.fixture
def no_switches(monkeypatch):
    for var in SWITCH_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("b,t,heads,causal", [
    (2, 37, 2, False),
    (2, 37, 2, True),
    (1, 77, 4, True),  # the text tower's length, more heads
])
def test_fused_qkv_plain_bf16_matches_jax(b, t, heads, causal):
    jq, tq = _bf16((b, t, 3 * heads * 64), t + heads)
    want = _f32(jpa.fused_qkv_attention(jq, heads, interpret=True, causal=causal))
    got = ak.fused_qkv_attention(tq, heads, causal)  # CPU: the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, t, heads * 64)
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=_tol(want))


@pytest.mark.parametrize("b,t,heads", [(2, 9, 2), (3, 50, 4)])
def test_packed_attention_plain_bf16_matches_jax_on_strided_views(b, t, heads):
    """q, k and v as views of one packed qkv buffer (row stride 3D), as the
    vision tower hands them to K8 under ``--attention-impl pallas``."""
    d = heads * 64
    jqkv, tqkv = _bf16((b, t, 3 * d), b * t)
    q, k, v = (z.view(b, t, heads, 64) for z in tqkv.split(d, dim=-1))
    assert q.stride() == (t * 3 * d, 3 * d, 64, 1)
    jq, jk, jv = (z.reshape(b, t, heads, 64) for z in jnp.split(jqkv, 3, axis=-1))
    want = _f32(jpa.packed_attention(jq, jk, jv, interpret=True))
    got = ak.packed_attention(q, k, v)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, t, heads, 64)
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=_tol(want))


def test_mlp_stream_plain_bf16_matches_jax_stream_kernel(blocks, no_switches):
    jp, tp = blocks[1024]
    calls = []
    real = jpb._mlp_stream_p
    no_switches.setattr(jpb, "_mlp_stream_p", lambda *a: calls.append(a[0].dtype) or real(*a))
    jx, tx = _bf16((2, 3, 1024), 1)
    want = _f32(jpb.fused_mlp_block(jx, jp["ln_2"], jp["mlp"], interpret=True))
    assert calls == [BF16]  # 2 x 1024 x 4096 x 2 bytes exceed the budget in bf16 too
    got = bk.mlp_stream(tx, tp["ln_2"], tp["mlp"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=_tol(want))
    routed = bk.mlp_block(tx, tp["ln_2"], tp["mlp"])
    assert torch.equal(routed, got)


def test_mlp_chunked_plain_bf16_matches_jax_chunked_kernel(blocks, no_switches):
    no_switches.setenv("CLIP_PPO_MLP_CHUNKED", "1")
    jp, tp = blocks[1024]
    calls = []
    real = jpb._mlp_chunked_p
    no_switches.setattr(jpb, "_mlp_chunked_p", lambda *a: calls.append(a[0].dtype) or real(*a))
    jx, tx = _bf16((2, 3, 1024), 2)
    want = _f32(jpb.fused_mlp_block(jx, jp["ln_2"], jp["mlp"], interpret=True))
    assert calls == [BF16]
    got = bk.mlp_block(tx, tp["ln_2"], tp["mlp"])  # the switch routes to K7
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=_tol(want))
    assert torch.equal(bk.mlp_chunked(tx, tp["ln_2"], tp["mlp"]), got)


@pytest.mark.parametrize("causal", [False, True])
def test_attn_stream_plain_bf16_matches_jax(blocks, causal):
    jp, tp = blocks[1024]
    jx, tx = _bf16((2, 5, 1024), 3 + causal)
    want = _f32(jpb.fused_attn_block_stream(jx, jp["ln_1"], jp["attn"], 16, causal=causal,
                                            block_batches=2, interpret=True))
    got = bk.attn_stream(tx, tp["ln_1"], tp["attn"], 16, causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=_tol(want))


# switches -> the wrappers a resblock calls in bf16: ViT-L/14's vision tower
# (D = 1024, no mask) and its text tower (D = 768, causal), whose MLP
# weights fit the budget in bf16 and take K3 whatever the switches.
BF16_ROUTES = [
    ({}, {"fused_qkv", "mlp_stream"}),
    ({"CLIP_PPO_ATTN_STREAM": "1"}, {"attn_stream", "mlp_stream"}),
    ({"CLIP_PPO_MLP_CHUNKED": "1"}, {"fused_qkv", "mlp_chunked"}),
    (BOTH, {"attn_stream", "mlp_chunked"}),
    ({"CLIP_PPO_MLP_STREAM": "0"}, {"fused_qkv", "mlp_plain"}),
    ({"CLIP_PPO_MLP_CHUNKED": "1", "CLIP_PPO_MLP_STREAM": "0"}, {"fused_qkv", "mlp_plain"}),
]


@pytest.mark.parametrize("tower", ["vision", "text"])
@pytest.mark.parametrize("switches, vision", BF16_ROUTES,
                         ids=[" ".join(f"{k}={v}" for k, v in r[0].items()) or "none"
                              for r in BF16_ROUTES])
def test_bf16_routes_follow_the_jax_rules(blocks, no_switches, switches, vision, tower):
    for var, value in switches.items():
        no_switches.setenv(var, value)
    width = 1024 if tower == "vision" else 768
    want = vision if tower == "vision" else {"attn_block", "mlp_block"}
    heads, causal = width // 64, tower == "text"
    jp, tp = blocks[width]
    jx, tx = _bf16((64, 2, width), 6)
    assert _jax_route(no_switches, jp, jx, heads, "causal" if causal else None) == want
    assert _port_route(no_switches, tp, tx, heads, causal) == want


# ViT-L/14's widths and heads in both towers, one layer each, 2 x 2 patches
# of 14 (T = 5) and a small vocabulary.
L14_TINY = dict(embed_dim=64, image_size=28, patch_size=14, vision_width=1024, vision_layers=1,
                vision_heads=16, text_width=768, text_heads=12, text_layers=1, vocab_size=512)


@pytest.fixture(scope="module")
def l14_features():
    """The JAX towers' bf16 features of 3 images and 2 token rows, and the
    port's towers cast once to bf16 (the same weights)."""
    cfg = CLIPConfig(**L14_TINY)
    jp = jax.tree_util.tree_map(np.asarray, jmodel.init_clip_params(jax.random.PRNGKey(5), cfg))
    rng = np.random.RandomState(8)
    images = rng.randn(3, 28, 28, 3).astype(np.float32)
    tokens = rng.randint(1, 510, size=(2, 77)).astype(np.int32)
    tokens[:, 0], tokens[:, 40] = 510, 511  # start, and the end token where the rows pool
    want_img = np.asarray(jax.jit(lambda p, x: jmodel.encode_image(p, cfg, x, BF16))(jp, images))
    want_txt = np.asarray(jax.jit(lambda p, t: jmodel.encode_text(p, cfg, t, BF16))(jp, tokens))
    cast = tmodel.cast_tower(convert.clip_params(jp), torch.bfloat16)
    return cast, images, tokens, want_img, want_txt


def _unit(a: np.ndarray) -> np.ndarray:
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


@pytest.mark.parametrize("switches", [{}, {"CLIP_PPO_ATTN_STREAM": "1"},
                                      {"CLIP_PPO_MLP_CHUNKED": "1"}, BOTH],
                         ids=["none", "attn_stream", "mlp_chunked", "both"])
def test_l14_width_towers_bf16_match_jax(l14_features, no_switches, switches):
    for var, value in switches.items():
        no_switches.setenv(var, value)
    cast, images, tokens, want_img, want_txt = l14_features
    cfg = TCLIPConfig(**L14_TINY)
    img = tmodel.encode_image(cast, cfg, torch.as_tensor(images), torch.bfloat16)
    txt = tmodel.encode_text(cast, cfg, torch.as_tensor(tokens), torch.bfloat16)
    assert img.dtype == txt.dtype == torch.float32 and img.shape == (3, 64) and txt.shape == (2, 64)
    np.testing.assert_allclose(_unit(img.numpy()), _unit(want_img), rtol=0, atol=2e-2)
    np.testing.assert_allclose(_unit(txt.numpy()), _unit(want_txt), rtol=0, atol=2e-2)


# -- the wrappers' bf16 contract ---------------------------------------------


def test_every_gpu_kernel_but_k1_counts_bf16_launches_apart():
    fp32 = {*cuda_build.SOURCES, "packed_attention"}
    assert set(cuda_build.BF16_KERNELS) == fp32 - {"disturb"}
    assert set(cuda_build.LAUNCHES) == fp32 | {f"{k}_bf16" for k in cuda_build.BF16_KERNELS}
    x = torch.zeros((2, 3, 64), dtype=torch.bfloat16)
    assert cuda_build.entry("fused_qkv", x) == "fused_qkv_bf16"
    assert cuda_build.entry("packed_attention", x.float()) == "packed_attention"
    assert cuda_build.entry("mlp_chunked", x) == "mlp_chunked_bf16"


@pytest.mark.parametrize("dtype,stride,ok", [
    (torch.bfloat16, 3 * 128, True),  # a strided view of one packed qkv buffer
    (torch.bfloat16, 68, False),  # a multiple of 4 elements, not of 8: 136 bytes
    (torch.float32, 68, True),  # 4 floats are 16 bytes
])
def test_attention_rows_take_16_byte_vectors_of_the_dtype(dtype, stride, ok):
    buf = torch.zeros((2, 5, stride), dtype=dtype)
    view = buf[..., :64]
    if ok:
        ak._check_rows(view, view.stride()[:2], "packed_attention", "q")
    else:
        with pytest.raises(ValueError, match="multiples of 8 elements in torch.bfloat16"):
            ak._check_rows(view, view.stride()[:2], "packed_attention", "q")


def test_attention_rows_refuse_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ak._check_rows(torch.zeros((2, 64), dtype=torch.float16), (64,), "fused_qkv_attention",
                       "qkv")


@pytest.mark.parametrize("dtype,chunks,acc", [
    (torch.bfloat16, bk.MLP_CHUNKS, True),  # K7 in bf16: the fp32 sum of the chunks
    (torch.bfloat16, 1, False),  # K3 and K5: one product, one rounding, no sum to keep
    (torch.float32, bk.MLP_CHUNKS, False),  # K7 in fp32 sums into its output in place
])
def test_k7_bf16_keeps_its_sum_in_float32(dtype, chunks, acc):
    x = torch.zeros((3, 5, 128), dtype=dtype)
    buf = bk.mlp_scratch(x, 512, chunks)
    assert buf["hidden"].dtype == dtype and tuple(buf["hidden"].shape) == (15, 512 // chunks)
    assert ("acc" in buf) is acc
    if acc:
        assert buf["acc"].dtype == torch.float32 and tuple(buf["acc"].shape) == (15, 128)


@pytest.mark.parametrize("call", [
    lambda x, p: ak.fused_qkv_attention(torch.zeros((2, 3, 3 * 1024), dtype=x.dtype,
                                                    device=x.device), 16),
    lambda x, p: bk.mlp_stream(x, p["ln_2"], p["mlp"]),
    lambda x, p: bk.mlp_chunked(x, p["ln_2"], p["mlp"]),
    lambda x, p: bk.attn_stream(x, p["ln_1"], p["attn"], 16),
], ids=["fused_qkv", "mlp_stream", "mlp_chunked", "attn_stream"])
def test_bf16_wrappers_refuse_other_devices(blocks, call):
    _, tp = blocks[1024]
    with pytest.raises(ValueError, match="unsupported device"):
        call(torch.empty((2, 3, 1024), dtype=torch.bfloat16, device="meta"), tp)
