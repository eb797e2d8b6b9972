"""K2/K3 plain versions, the text tower and the description table against
the JAX package.

The JAX side runs ``fused_attn_block``/``fused_mlp_block`` in interpret
mode (width 128 = 2 heads × 64, so its head-pair path runs) and their XLA
references ``_attn_block_ref``/``_mlp_block_ref``. Weights carry across
with ``convert.clip_params``. Tolerance: float32, reductions of up to 512
products summed in another order — 2e-5 on the blocks, 1e-4 on the
2-layer tower and the L2-normalized table.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.models import clip_utils as jcu
from clip_ppo_tpu.models.clip import CLIPConfig
from clip_ppo_tpu.models.clip import model as jmodel
from clip_ppo_tpu.models.clip.pallas_block import (
    _attn_block_ref,
    _mlp_block_ref,
    _row,
    fused_attn_block,
    fused_mlp_block,
)
from clip_ppo_tpu.models.clip.tokenizer import tokenize
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.models import clip_utils as tcu
from clip_ppo_tpu_torch.models.clip import block_kernels as bk
from clip_ppo_tpu_torch.models.clip import model as tmodel
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig as TorchCLIPConfig

TINY = dict(embed_dim=512, image_size=32, patch_size=16, vision_width=128, vision_layers=1,
            vision_heads=2, text_width=128, text_heads=2, text_layers=2, vocab_size=49408)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def block():
    cfg = CLIPConfig(embed_dim=32, vision_width=128, vision_layers=1, vision_heads=2, text_layers=1)
    jp = jmodel.init_clip_params(jax.random.PRNGKey(0), cfg)["visual"]["transformer"]["resblocks"][0]
    x = np.random.RandomState(1).randn(4, 77, 128).astype(np.float32)
    return jp, convert.clip_params(_np(jp)), x


@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_plain_matches_jax(block, causal):
    jp, tp, x = block
    got = bk.attn_block(torch.as_tensor(x), tp["ln_1"], tp["attn"], 2, causal).numpy()
    fused = fused_attn_block(jnp.asarray(x), jp["ln_1"], jp["attn"], 2, causal=causal,
                             interpret=True)
    a = jp["attn"]
    ref = _attn_block_ref(jnp.asarray(x), a["in_proj_w"].T, _row(a["in_proj_b"], jnp.float32),
                          a["out_proj_w"].T, _row(a["out_proj_b"], jnp.float32),
                          _row(jp["ln_1"]["scale"], jnp.float32),
                          _row(jp["ln_1"]["bias"], jnp.float32), 2, causal, 1e-5)
    np.testing.assert_allclose(got, np.asarray(fused), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_mlp_block_plain_matches_jax(block):
    jp, tp, x = block
    got = bk.mlp_block(torch.as_tensor(x), tp["ln_2"], tp["mlp"]).numpy()
    fused = fused_mlp_block(jnp.asarray(x), jp["ln_2"], jp["mlp"], interpret=True)
    m = jp["mlp"]
    ref = _mlp_block_ref(jnp.asarray(x), m["fc_w"].T, _row(m["fc_b"], jnp.float32),
                         m["proj_w"].T, _row(m["proj_b"], jnp.float32),
                         _row(jp["ln_2"]["scale"], jnp.float32),
                         _row(jp["ln_2"]["bias"], jnp.float32), 1e-5)
    np.testing.assert_allclose(got, np.asarray(fused), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_layer_norm_and_attention_match_jax(block):
    jp, tp, x = block
    ln = jmodel.layer_norm(jp["ln_1"], jnp.asarray(x))
    np.testing.assert_allclose(bk.layer_norm(tp["ln_1"], torch.as_tensor(x)).numpy(),
                               np.asarray(ln), rtol=1e-5, atol=1e-5)
    want = jmodel.attention(jp["attn"], ln, 2, "causal", impl="xla")
    got = bk.attention(tp["attn"], torch.as_tensor(np.array(ln)), 2, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def tower():
    jcfg, tcfg = CLIPConfig(**TINY), TorchCLIPConfig(**TINY)
    jp = jmodel.init_clip_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, jp, convert.clip_params(_np(jp))


def test_encode_text_matches_jax(tower):
    jcfg, tcfg, jp, tp = tower
    toks = tokenize(["agent at (1,2) facing up, objects: wall at (0,0)", "a b c", "hello world"])
    want = jmodel.encode_text(jp, jcfg, jnp.asarray(toks))
    got = tmodel.encode_text(tp, tcfg, torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_text_table_matches_jax(tower):
    jcfg, tcfg, jp, tp = tower
    suffix = ", objects: wall at (0,0), wall at (0,1), wall at (0,2)"
    want = jcu.build_minigrid_text_table(jp, jcfg, 5, 5, suffix)
    got = tcu.build_minigrid_text_table(tp, tcfg, 5, 5, suffix)
    assert got.shape == (100, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    desc = {"agent_pos": np.array([[[1, 2], [3, 3]]]), "agent_dir": np.array([[0, 3]])}
    jemb = jcu.make_text_table_embed_fn(5)(
        {k: jnp.asarray(v) for k, v in desc.items()}, {"text_table": want})
    temb = tcu.make_text_table_embed_fn(5)(
        {k: torch.as_tensor(v) for k, v in desc.items()}, {"text_table": got})
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), rtol=1e-4, atol=1e-4)


def test_wrappers_refuse_other_devices(block):
    _, tp, x = block
    with pytest.raises(ValueError, match="unsupported device"):
        bk.attn_block(torch.as_tensor(x).to("meta"), tp["ln_1"], tp["attn"], 2)
    with pytest.raises(ValueError, match="unsupported device"):
        bk.mlp_block(torch.as_tensor(x).to("meta"), tp["ln_2"], tp["mlp"])


def _openai_state_dict(vw=64, tw=64, ps=8, grid=2, layers=1, vocab=50, ctx=7, embed=32):
    """A small OpenAI-layout CLIP state dict with random weights."""
    g = torch.Generator()
    g.manual_seed(0)
    r = lambda *shape: torch.randn(tuple(shape), generator=g)  # noqa: E731
    sd = {"visual.conv1.weight": r(vw, 3, ps, ps), "visual.class_embedding": r(vw),
          "visual.positional_embedding": r(grid * grid + 1, vw), "visual.proj": r(vw, embed),
          "token_embedding.weight": r(vocab, tw), "positional_embedding": r(ctx, tw),
          "text_projection": r(tw, embed), "logit_scale": r()}
    for pre, w in (("visual.ln_pre.", vw), ("visual.ln_post.", vw), ("ln_final.", tw)):
        sd[pre + "weight"], sd[pre + "bias"] = r(w), r(w)
    for tower, w in (("visual.transformer", vw), ("transformer", tw)):
        for i in range(layers):
            p = f"{tower}.resblocks.{i}."
            for ln in ("ln_1", "ln_2"):
                sd[p + ln + ".weight"], sd[p + ln + ".bias"] = r(w), r(w)
            sd[p + "attn.in_proj_weight"], sd[p + "attn.in_proj_bias"] = r(3 * w, w), r(3 * w)
            sd[p + "attn.out_proj.weight"], sd[p + "attn.out_proj.bias"] = r(w, w), r(w)
            sd[p + "mlp.c_fc.weight"], sd[p + "mlp.c_fc.bias"] = r(4 * w, w), r(4 * w)
            sd[p + "mlp.c_proj.weight"], sd[p + "mlp.c_proj.bias"] = r(w, 4 * w), r(w)
    return sd


def test_convert_openai_state_dict_matches_jax():
    from clip_ppo_tpu.models.clip.loader import convert_openai_state_dict as jconvert
    from clip_ppo_tpu_torch.models.clip.loader import convert_openai_state_dict as tconvert

    sd = _openai_state_dict()
    jparams, jcfg = jconvert(sd)
    tparams, tcfg = tconvert(sd, "cpu")
    assert jcfg == CLIPConfig(**{f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__})
    want = jax.tree_util.tree_leaves(_np(jparams))
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), tparams))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_load_clip_model_defaults_to_the_gpu(monkeypatch):
    """Without a device the loader puts the weights on the GPU, so leaving
    it out raises where there is none instead of running the plain blocks."""
    from clip_ppo_tpu_torch.models.clip import loader

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--no-cuda"):
        loader.load_clip_model("ViT-B/32", pretrained=False)
    with pytest.raises(RuntimeError, match="--no-cuda"):
        loader.convert_openai_state_dict(_openai_state_dict())


def test_find_checkpoint_searches_the_home_caches_like_jax(tmp_path, monkeypatch):
    """Both packages look in $CLIP_PPO_CHECKPOINT_DIR, then ~/.cache/clip,
    then ~/.cache/clip_ppo_tpu, find the same file at each step, and load
    the same weights from it."""
    from clip_ppo_tpu.models.clip import loader as jloader
    from clip_ppo_tpu_torch.models.clip import loader as tloader

    monkeypatch.delenv("CLIP_PPO_CHECKPOINT_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert tloader.find_checkpoint("ViT-B/32") is None and jloader.find_checkpoint("ViT-B/32") is None
    for where in ("home/.cache/clip_ppo_tpu", "home/.cache/clip", "env"):
        d = tmp_path / where
        d.mkdir(parents=True)
        torch.save(_openai_state_dict(), d / "ViT-B-32.pt")
        if where == "env":
            monkeypatch.setenv("CLIP_PPO_CHECKPOINT_DIR", str(d))
        found = tloader.find_checkpoint("ViT-B/32")
        assert found == jloader.find_checkpoint("ViT-B/32") == str(d / "ViT-B-32.pt")
    jparams, _ = jloader.load_clip_model("ViT-B/32", pretrained=True)
    tparams, _ = tloader.load_clip_model("ViT-B/32", "cpu", pretrained=True)
    want = jax.tree_util.tree_leaves(_np(jparams))
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), tparams))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
