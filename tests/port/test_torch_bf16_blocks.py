"""K2 and K3 in bfloat16: their plain versions against the JAX package, the
wrappers' bf16 contract (every resblock half's), and the bf16 image tower.

The JAX side runs ``fused_attn_block``/``fused_mlp_block`` in interpret
mode on bf16 x (they cast the weights to bf16 themselves, ``_row(..., dt)``)
and their XLA references ``_attn_block_ref``/``_mlp_block_ref`` on bf16
weights. The port's plain versions take the same bf16 values (x, and the
weights cast once with ``model.cast_tower``). Width 128 = 2 heads × 64, at
[4, 50, 128] (not causal) and [4, 77, 128] (causal); LayerNorm affines and
biases drawn at random, so none of them sits at its neutral value.

Tolerance: (1/64) × max(1, max |ref|), compared in float32. JAX's own bf16
interpret kernel differs from its reference by about one bf16 ulp of the
largest value (0.0078 at max |ref| 4.4 on the attention half, 0.031 at 5.8
on the MLP half, measured on the CPU), since the two round in other places;
the tolerance allows about three such ulps. The tower's L2-normalized
features: 2e-2 absolute, the bound ``tests/test_clip.py`` puts on bf16
against float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.models.clip import CLIPConfig
from clip_ppo_tpu.models.clip import model as jmodel
from clip_ppo_tpu.models.clip.pallas_block import (
    _attn_block_ref,
    _mlp_block_ref,
    _row,
    fused_attn_block,
    fused_mlp_block,
)
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.models.clip import block_kernels as bk
from clip_ppo_tpu_torch.models.clip import model as tmodel
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from clip_ppo_tpu_torch.utils.tree import tree_map

BF16 = jnp.bfloat16
CASES = [((4, 50, 128), False), ((4, 77, 128), True)]
TINY = dict(embed_dim=512, image_size=32, patch_size=16, vision_width=128, vision_layers=2,
            vision_heads=2, text_width=128, text_heads=2, text_layers=1, vocab_size=49408)


def _tol(ref: np.ndarray) -> float:
    return max(1.0, float(np.abs(ref).max())) / 64


def _bf16_torch(a) -> torch.Tensor:
    """A bf16 JAX/numpy array as the same bf16 values in torch."""
    return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(torch.bfloat16)


def _f32(a) -> np.ndarray:
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, dtype=np.float32)


@pytest.fixture(scope="module")
def block():
    """One width-128 resblock with random LayerNorm affines and biases: the
    JAX package's numpy tree, and the port's, cast once to bf16."""
    gen = torch.Generator()
    gen.manual_seed(7)
    p = tmodel.init_block(gen, 128, "cpu")
    for ln in (p["ln_1"], p["ln_2"]):
        ln["scale"] = 1.0 + 0.1 * torch.randn(128, generator=gen)
        ln["bias"] = 0.1 * torch.randn(128, generator=gen)
    for part, key in (("attn", "in_proj_b"), ("attn", "out_proj_b"), ("mlp", "fc_b"),
                      ("mlp", "proj_b")):
        p[part][key] = 0.1 * torch.randn(p[part][key].shape, generator=gen)
    jp = tree_map(lambda t: t.numpy(), p)
    return jp, tmodel.cast_tower(p, torch.bfloat16)


def _x(shape, seed: int) -> jnp.ndarray:
    return jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32)).astype(BF16)


@pytest.mark.parametrize("shape,causal", CASES)
def test_attn_block_plain_bf16_matches_jax(block, shape, causal):
    jp, tp = block
    x = _x(shape, 1)
    got = bk.attn_block(_bf16_torch(x), tp["ln_1"], tp["attn"], 2, causal)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    fused = fused_attn_block(x, jp["ln_1"], jp["attn"], 2, causal=causal, interpret=True)
    a = jp["attn"]
    ref = _attn_block_ref(x, jnp.asarray(a["in_proj_w"]).astype(BF16).T,
                          _row(a["in_proj_b"], BF16), jnp.asarray(a["out_proj_w"]).astype(BF16).T,
                          _row(a["out_proj_b"], BF16), _row(jp["ln_1"]["scale"], BF16),
                          _row(jp["ln_1"]["bias"], BF16), 2, causal, 1e-5)
    assert fused.dtype == ref.dtype == BF16
    for want in (_f32(fused), _f32(ref)):
        np.testing.assert_allclose(_f32(got), want, rtol=0, atol=_tol(want))


@pytest.mark.parametrize("shape,causal", CASES)
def test_mlp_block_plain_bf16_matches_jax(block, shape, causal):
    del causal  # the MLP half has no mask; the shapes are the attention half's
    jp, tp = block
    x = _x(shape, 2)
    got = bk.mlp_block(_bf16_torch(x), tp["ln_2"], tp["mlp"])
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    fused = fused_mlp_block(x, jp["ln_2"], jp["mlp"], interpret=True)
    m = jp["mlp"]
    ref = _mlp_block_ref(x, jnp.asarray(m["fc_w"]).astype(BF16).T, _row(m["fc_b"], BF16),
                         jnp.asarray(m["proj_w"]).astype(BF16).T, _row(m["proj_b"], BF16),
                         _row(jp["ln_2"]["scale"], BF16), _row(jp["ln_2"]["bias"], BF16), 1e-5)
    for want in (_f32(fused), _f32(ref)):
        np.testing.assert_allclose(_f32(got), want, rtol=0, atol=_tol(want))


def test_mlp_block_plain_casts_float32_weights(block):
    """The plain version applies weights in x's dtype, as ``_mlp_block_ref``
    is handed them, whatever dtype they arrive in."""
    _, tp = block
    x = _bf16_torch(_x((2, 5, 128), 3))
    f32 = {k: v.float() for k, v in tp["mlp"].items()}  # the same values, held in float32
    torch.testing.assert_close(bk.mlp_block_plain(x, tp["ln_2"], f32),
                               bk.mlp_block_plain(x, tp["ln_2"], tp["mlp"]), rtol=0, atol=0)


@pytest.mark.parametrize("make,key", [
    (lambda x: bk.attn_scratch(x), "stats"),
    (lambda x: bk.mlp_scratch(x, 512), "stats"),
    (lambda x: bk.mlp_scratch(x, 512, bk.MLP_CHUNKS), "stats"),
])
def test_layernorm_statistics_stay_float32_in_bf16(make, key):
    """The scratch the GPU wrappers launch on: the LN statistics are float32
    whatever x is (a bf16 mean would round away the row's offset), and so is
    K7's sum of its chunks in bf16 (``acc``); the activations' scratch is in
    x's dtype."""
    for dtype in (torch.bfloat16, torch.float32):
        buf = make(torch.zeros((3, 5, 128), dtype=dtype))
        assert buf[key].dtype == torch.float32 and tuple(buf[key].shape) == (15, 2)
        assert all(v.dtype == dtype for k, v in buf.items() if k not in (key, "acc"))
        assert buf.get("acc", torch.zeros((), dtype=torch.float32)).dtype == torch.float32


@pytest.mark.parametrize("name", ["attn_block", "mlp_block", "mlp_stream", "mlp_chunked",
                                  "attn_stream"])
def test_bf16_kernels_refuse_mixed_dtypes(block, name):
    jp, tp = block
    part = "attn" if name.startswith("attn") else "mlp"
    bk._check(torch.zeros((2, 3, 128), dtype=torch.bfloat16), tp[part], name)  # one dtype: taken
    f32 = {k: torch.as_tensor(v) for k, v in jp[part].items()}
    with pytest.raises(ValueError, match="cast_tower"):
        bk._check(torch.zeros((2, 3, 128), dtype=torch.bfloat16), f32, name)


@pytest.fixture(scope="module")
def tower():
    gen = torch.Generator()
    gen.manual_seed(3)
    tp = tmodel.init_clip_params(gen, TCLIPConfig(**TINY), "cpu")
    return tree_map(lambda t: t.numpy(), tp), tp


def test_cast_tower_casts_once_and_keeps_the_outer_layernorms(tower):
    _, tp = tower
    cast = tmodel.cast_tower(tp, torch.bfloat16)
    v = cast["visual"]
    assert v["proj"].dtype == v["transformer"]["resblocks"][0]["mlp"]["fc_w"].dtype == torch.bfloat16
    assert v["ln_pre"]["scale"].dtype == cast["text"]["ln_final"]["bias"].dtype == torch.float32
    assert v["ln_post"] is tp["visual"]["ln_post"]
    again = tmodel.cast_tower(cast, torch.bfloat16)
    assert again["visual"]["proj"] is v["proj"]  # already bf16: shared, not copied


def test_encode_image_bf16_matches_jax(tower):
    jp, tp = tower
    x = np.random.RandomState(4).randn(3, 32, 32, 3).astype(np.float32)
    encode = jax.jit(lambda p, x: jmodel.encode_image(p, CLIPConfig(**TINY), x, BF16))
    want = np.asarray(encode(jp, jnp.asarray(x)))
    cast = tmodel.cast_tower(convert.clip_params(jp), torch.bfloat16)
    got = tmodel.encode_image(cast, TCLIPConfig(**TINY), torch.as_tensor(x), torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == (3, 512)

    def unit(a):
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    np.testing.assert_allclose(unit(got.numpy()), unit(want), rtol=0, atol=2e-2)
