"""K4's and K8's plain versions, the port's attention routing and the towers
under each route, against the JAX package.

The JAX side runs ``fused_qkv_attention`` and ``packed_attention`` in
interpret mode. Inputs come from numpy seeds. Tolerances: the kernels
2e-5 absolute and relative, as ``tests/test_packed_attention.py`` holds the
JAX kernels to their einsum reference (float32 sums of 64 products and of
up to 257 softmax weights, taken in another order); the towers' features
1e-4 (sums of up to 4,096 products through a resblock). Tower weights carry
across with ``convert.clip_params``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.models.clip import CLIPConfig
from clip_ppo_tpu.models.clip import model as jmodel
from clip_ppo_tpu.models.clip import pallas_attention as jattn
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.models.clip import attention_kernels as ak
from clip_ppo_tpu_torch.models.clip import model as tmodel
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from clip_ppo_tpu_torch.utils.tree import tree_map

TINY = dict(embed_dim=512, image_size=32, patch_size=16, vision_width=128, vision_layers=2,
            vision_heads=2, text_width=128, text_heads=2, text_layers=1, vocab_size=49408)
# ViT-L/14's vision width and heads, one layer, 2 x 2 patches of 14 (T = 5).
WIDE = dict(embed_dim=64, image_size=28, patch_size=14, vision_width=1024, vision_layers=1,
            vision_heads=16, text_width=128, text_heads=2, text_layers=1, vocab_size=49408)


def _towers(cfg: dict, seed: int):
    gen = torch.Generator()
    gen.manual_seed(seed)
    jp = tree_map(lambda t: t.numpy(), tmodel.init_clip_params(gen, TCLIPConfig(**cfg), "cpu"))
    return jp, convert.clip_params(jp)


@pytest.mark.parametrize("b,t,heads,dh,group,causal", [
    (3, 17, 2, 64, 1, False),
    (3, 17, 2, 64, 1, True),
    (2, 257, 4, 64, 1, False),   # ViT-L/14's length
    (7, 50, 4, 16, 1, False),    # the generic per-head path
    (8, 50, 4, 16, 2, False),    # two heads per score matmul
])
def test_fused_qkv_plain_matches_jax_kernel(b, t, heads, dh, group, causal):
    qkv = np.random.RandomState(t + dh).randn(b, t, 3 * heads * dh).astype(np.float32)
    want = np.asarray(jattn.fused_qkv_attention(jnp.asarray(qkv), heads, group=group,
                                                interpret=True, causal=causal))
    got = ak.fused_qkv_attention_plain(torch.as_tensor(qkv), heads, causal)
    assert got.shape == (b, t, heads * dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    wrapped = ak.fused_qkv_attention(torch.as_tensor(qkv), heads, causal)  # CPU: the plain version
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("b,t,heads,dh,group,block_pairs", [
    (6, 50, 4, 32, 2, 4),
    (3, 13, 3, 16, 2, 4),  # b·h = 9 pairs, not a multiple of 4: the padding path
])
def test_packed_attention_plain_matches_jax_kernel(b, t, heads, dh, group, block_pairs):
    rng = np.random.RandomState(b * t)
    q, k, v = (rng.randn(b, t, heads, dh).astype(np.float32) for _ in range(3))
    want = np.asarray(jattn.packed_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             group=group, block_pairs=block_pairs,
                                             interpret=True))
    tq, tk, tv = (torch.as_tensor(z) for z in (q, k, v))
    got = ak.packed_attention_plain(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(ak.packed_attention(tq, tk, tv).numpy(), got.numpy())


def test_resblock_routes_match_jax_rules(monkeypatch):
    """Which kernel each attention_impl reaches, for each width and mask, as
    the JAX package's predicates decide on a TPU at batch 64."""
    monkeypatch.setattr(jmodel.jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("CLIP_PPO_ATTN_STREAM", raising=False)
    monkeypatch.delenv("CLIP_PPO_MLP_STREAM", raising=False)
    taken = []

    def spy(name, ret):
        def f(*args):
            taken.append((name, args[-1]) if isinstance(args[-1], (bool, int)) else name)
            return ret(*args)
        return f

    first_third = lambda qkv, *a: qkv[..., : qkv.shape[-1] // 3]  # noqa: E731
    monkeypatch.setattr(tmodel, "attn_block", spy("attn_block", lambda x, *a: x))
    monkeypatch.setattr(tmodel, "mlp_block", spy("mlp_block", lambda x, *a: x))
    monkeypatch.setattr(tmodel, "mlp_block_plain", spy("plain", lambda x, *a: x))
    monkeypatch.setattr(tmodel, "fused_qkv_attention", spy("fused_qkv", first_third))
    monkeypatch.setattr(tmodel, "fused_qkv_attention_plain", spy("einsum", first_third))
    monkeypatch.setattr(tmodel, "packed_attention", spy("packed_attention", lambda q, *a: q))
    monkeypatch.setattr(tmodel, "packed_sdpa", spy("packed_sdpa", lambda q, *a: q))
    t = 3
    for width in (768, 1024):
        z = torch.zeros
        p = {"ln_1": {"scale": z(width), "bias": z(width)}, "ln_2": {},
             "attn": {"in_proj_w": z(3 * width, width), "in_proj_b": z(3 * width),
                      "out_proj_w": z(width, width), "out_proj_b": z(width)}, "mlp": {}}
        for impl in ("auto", "fused", "block", "xla", "packed2", "pallas"):
            for causal in (False, True):
                mask = "causal" if causal else None
                if jmodel._use_fused_block(impl, mask, 64, width):
                    want = [("attn_block", causal), "mlp_block"]
                else:
                    assert not jmodel._use_stream_attn(impl, mask, 64, width)
                    array_mask = None if mask is None else jmodel.causal_mask(t)
                    if jmodel._use_fused_qkv(impl, mask, 64):
                        attn = ("fused_qkv", causal)
                    elif jmodel._use_packed_attention(impl, array_mask):
                        attn = "packed_attention"
                    elif jmodel._batch_pack_factor(impl, array_mask, t) > 1:
                        attn = ("packed_sdpa", jmodel._batch_pack_factor(impl, array_mask, t))
                    else:
                        attn = ("einsum", causal)
                    mlp = "mlp_block" if jmodel._use_stream_mlp(impl, mask, 64, width) else "plain"
                    want = [attn, mlp]
                taken.clear()
                tmodel.resblock(p, torch.zeros(2, t, width), width // 64, causal, impl)
                assert taken == want, (width, impl, causal)


def test_vit_l14_width_tower_takes_k4_and_matches_jax(monkeypatch):
    jp, tp = _towers(WIDE, 5)
    calls = []
    real = tmodel.fused_qkv_attention
    monkeypatch.setattr(tmodel, "fused_qkv_attention",
                        lambda qkv, h, c: calls.append((tuple(qkv.shape), h, c)) or real(qkv, h, c))
    x = np.random.RandomState(6).randn(2, 28, 28, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jmodel.encode_image(p, CLIPConfig(**WIDE), x))(
        jp, jnp.asarray(x)))
    got = tmodel.encode_image(tp, TCLIPConfig(**WIDE), torch.as_tensor(x))
    assert calls == [((2, 5, 3 * 1024), 16, False)]  # "auto" at D = 1024: K4, non-causal
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_tiny_towers_match_jax_under_impl(impl):
    jp, tp = _towers(TINY, 7)
    cfg, tcfg = CLIPConfig(**TINY), TCLIPConfig(**TINY)
    rng = np.random.RandomState(8)
    x = rng.randn(3, 32, 32, 3).astype(np.float32)
    toks = rng.randint(1, 49406, (2, 77)).astype(np.int32)
    toks[:, 40] = 49407  # EOT mid-sequence: pooling reads a causal row
    want_img = jmodel.encode_image(jp, cfg, jnp.asarray(x), attention_impl=impl)
    want_txt = jmodel.encode_text(jp, cfg, jnp.asarray(toks), attention_impl=impl)
    got_img = tmodel.encode_image(tp, tcfg, torch.as_tensor(x), attention_impl=impl)
    got_txt = tmodel.encode_text(tp, tcfg, torch.as_tensor(toks), attention_impl=impl)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_txt.numpy(), np.asarray(want_txt), rtol=1e-4, atol=1e-4)


def test_wrappers_refuse_other_devices():
    qkv = torch.zeros(1, 3, 3 * 64, device="meta")
    with pytest.raises(ValueError, match="fused_qkv_attention: unsupported device"):
        ak.fused_qkv_attention(qkv, 1)
    q = torch.zeros(1, 3, 1, 64, device="meta")
    with pytest.raises(ValueError, match="packed_attention: unsupported device"):
        ak.packed_attention(q, q, q)
