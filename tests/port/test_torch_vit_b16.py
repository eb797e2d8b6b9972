"""ViT-B/16's vision tower, T = 197 (224 px in patches of 16), against the
JAX package, and the CLIs that now take it on the GPU.

The towers are narrow (width 128 = 2 heads x 64, one layer, 512-wide
embeddings) at ViT-B/16's image and patch sizes, so the tower runs K2's
route (``attn_block``) at 197 tokens, the length no other tower gives it.
Weights come from the port's initializer at a seed, handed to the JAX
package as numpy arrays and carried back with ``convert.clip_params``.

Tolerances: float32 features 1e-4 (sums of up to 512 products through a
resblock, taken in another order), L2-normalized embeddings after the 84 ->
224 resize 1e-5, as ``test_torch_image.py`` holds ViT-B/32's; K2's plain
version against the JAX interpret kernel 1e-4 in float32 and (1/64) x
max(1, max |ref|) in bf16 (``test_torch_bf16_blocks.py``); bf16 features
2e-2 on unit vectors (``tests/test_clip.py``'s bound on bf16 against
float32).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.models import clip_utils as jcu
from clip_ppo_tpu.models.clip import CLIPConfig
from clip_ppo_tpu.models.clip import model as jmodel
from clip_ppo_tpu.models.clip.pallas_block import fused_attn_block
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.cli import benchmark_clip as tbench
from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as tcli
from clip_ppo_tpu_torch.models import clip_utils as tcu
from clip_ppo_tpu_torch.models.clip import block_kernels as bk
from clip_ppo_tpu_torch.models.clip import model as tmodel
from clip_ppo_tpu_torch.models.clip.config import CLIP_CONFIGS
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from clip_ppo_tpu_torch.utils import flags
from clip_ppo_tpu_torch.utils.tree import tree_map

B16 = CLIP_CONFIGS["ViT-B/16"]
NARROW = dict(embed_dim=512, image_size=B16.image_size, patch_size=B16.patch_size,
              vision_width=128, vision_layers=1, vision_heads=2, text_width=128, text_heads=2,
              text_layers=1, vocab_size=49408)
ENV_ID = "MiniGrid-Empty-5x5-v0"


def _unit(a: np.ndarray) -> np.ndarray:
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def tower():
    gen = torch.Generator()
    gen.manual_seed(16)
    jp = tree_map(lambda t: t.numpy(), tmodel.init_clip_params(gen, TCLIPConfig(**NARROW), "cpu"))
    return jp, convert.clip_params(jp)


def test_narrow_tower_has_vit_b16_length():
    assert TCLIPConfig(**NARROW).num_patches + 1 == B16.num_patches + 1 == 197


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_image_at_197_tokens_matches_jax(tower, dtype):
    jp, tp = tower
    x = np.random.RandomState(5).randn(2, 224, 224, 3).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax.jit(lambda p, x: jmodel.encode_image(p, CLIPConfig(**NARROW), x, jdt))(
        jp, jnp.asarray(x)))
    params = tmodel.cast_tower(tp, tdt)
    calls = []
    real = tmodel.attn_block
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodel, "attn_block", lambda x, *a, **k: calls.append(tuple(x.shape)) or real(
            x, *a, **k))
        got = tmodel.encode_image(params, TCLIPConfig(**NARROW), torch.as_tensor(x), tdt)
    assert calls == [(2, 197, 128)]  # K2's route at ViT-B/16's length
    assert got.dtype == torch.float32 and got.shape == (2, 512)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(_unit(got.numpy()), _unit(want), rtol=0, atol=2e-2)


def test_encode_images_from_frames_match_jax(tower):
    """The image modality's path: 84 x 84 frames resized to 224 and
    encoded, as L2-normalized embeddings."""
    jp, tp = tower
    frames = np.random.RandomState(6).randint(0, 256, (3, 84, 84, 3)).astype(np.uint8)
    want = np.asarray(jcu.encode_images(jp, CLIPConfig(**NARROW), jnp.asarray(frames)))
    got = tcu.make_encode_images_fn(TCLIPConfig(**NARROW))(torch.as_tensor(frames), {"clip": tp})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_block_plain_matches_jax_at_197_tokens(tower, dtype):
    jp, tp = tower
    blk = jp["visual"]["transformer"]["resblocks"][0]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    x = jnp.asarray(np.random.RandomState(7).randn(2, 197, 128).astype(np.float32)).astype(jdt)
    want = np.asarray(fused_attn_block(x, blk["ln_1"], blk["attn"], 2, causal=False,
                                       interpret=True), dtype=np.float32)
    p = tmodel.cast_tower(tp["visual"]["transformer"]["resblocks"][0], tdt)
    got = bk.attn_block(torch.as_tensor(np.array(x, dtype=np.float32)).to(tdt), p["ln_1"],
                        p["attn"], 2).float().numpy()
    tol = 1e-4 if dtype == "float32" else max(1.0, float(np.abs(want).max())) / 64
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _narrow_clip(name, device, **_):
    assert name == "ViT-B/16"
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return tmodel.init_clip_params(gen, TCLIPConfig(**NARROW), device), TCLIPConfig(**NARROW)


@pytest.mark.parametrize("mode", ["image", "FROZEN_CLIP"])
def test_cli_takes_vit_b16_on_the_gpu(mode):
    """The CLI's refusals before any tower is built: ViT-B/16's vision tower
    now passes them whatever the device (the check reads no device)."""
    extra = (["--clip-config.clip-modality", "image", "--clip-config.clip-lambda", "1e-5"]
             if mode == "image" else ["--clip-config.ablation-mode", "FROZEN_CLIP"])
    args = flags.parse(tcli.Args, ["--clip-config.clip-model", "ViT-B/16", *extra])
    cc = args.clip_config
    tcli._reject_later_slices(args, tcu.should_compute_clip_loss(cc.ablation_mode,
                                                                cc.clip_lambda))


@pytest.mark.parametrize("mode,extra", [
    ("image", ["--clip-config.clip-modality", "image", "--clip-config.clip-lambda", "1e-5"]),
    ("FROZEN_CLIP", ["--clip-config.ablation-mode", "FROZEN_CLIP"]),
])
def test_cli_runs_vit_b16_on_cpu(tmp_path, monkeypatch, mode, extra):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcu, "load_clip_model", _narrow_clip)
    shapes = []
    real = tmodel.attn_block
    monkeypatch.setattr(tmodel, "attn_block",
                        lambda x, *a, **k: shapes.append((tuple(x.shape), x.dtype)) or real(
                            x, *a, **k))
    args = flags.parse(tcli.Args, [
        "--no-cuda", "--env-id", ENV_ID, "--num-envs", "2", "--num-steps", "8",
        "--total-timesteps", "16", "--clip-config.clip-model", "ViT-B/16",
        "--clip-config.apply-disturbances", "--clip-config.disturbance-severity", "HARD",
        "--no-capture-video", "--seed", "2", *extra,
    ])
    out = tcli.train(args, run_name=mode)
    assert out["global_step"] == 16
    scalars = out["last_scalars"]
    assert np.isfinite([float(v) for k, v in scalars.items() if k != "explained_variance"]).all()
    assert (float(scalars["first_clip_loss"]) > 0.0) == (mode == "image")
    # Every call of the tower ran K2's route at 197 tokens: one encode of the
    # iteration's 16 frames (image, fp32), or the bf16 trunk at each rollout
    # step, the bootstrap value and each minibatch (FROZEN_CLIP).
    assert {s[1:] for s, _ in shapes} == {(197, 128)}
    if mode == "image":
        assert shapes == [((16, 197, 128), torch.float32)]
    else:
        assert {dt for _, dt in shapes} == {torch.bfloat16}
        assert len(shapes) == 8 + 1 + args.update_epochs * args.num_minibatches
    assert "_final.ckpt" in "".join(os.listdir(tmp_path / "checkpoints"))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_benchmark_runs_vit_b16_on_cpu(monkeypatch, capsys, dtype):
    monkeypatch.setattr(tbench, "load_clip_model", _narrow_clip)
    tbench.main(["--no-cuda", "--model", "ViT-B/16", "--dtype", dtype, "--batch-sizes", "2",
                 "--text-batch", "2", "--iterations", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"model=ViT-B/16 dtype={dtype} device=cpu (cpu)"
    assert len(lines) == 4 and lines[3].startswith("text  batch=2: ")
