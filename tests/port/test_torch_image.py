"""The image modality against the JAX package: CLIP preprocessing, the
vision tower, one Trainer iteration with ``embed_images_fn``, and the
port's CLI on the CPU.

Towers are tiny (image 32, patch 16, width 128 = 2 heads × 64, 2 layers),
drawn once and handed to the JAX package as its tree of numpy arrays and
to the port through ``convert.clip_params``, so the visual tower's
conversion is checked through every encode here.
Tolerances: the resize and normalization 1e-5 (float32 filter sums, then a
divide by ~0.27); the tower's features 1e-4 (sums of up to 768 products
through two blocks); L2-normalized embeddings 1e-5.

The Trainer iteration (MiniGrid-Empty-5x5, 2 envs × 8 steps, no
disturbance) starts both packages from the same state and hands the port
the JAX iteration's Gumbel batch and permutations, as
``tests/port/test_torch_slice.py`` does; actions, rewards and dones must be
equal (the observations too: no disturbance, no rounding), the embeddings
agree to 1e-5 and the losses, the CLIP term among them, to 1e-4.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.envs import JaxVectorEnv
from clip_ppo_tpu.models import clip_utils as jcu
from clip_ppo_tpu.models.clip import CLIPConfig
from clip_ppo_tpu.models.clip import model as jmodel
from clip_ppo_tpu.ops import resize as jresize
from clip_ppo_tpu.train import PPOConfig as JPPOConfig
from clip_ppo_tpu.train import Trainer as JTrainer
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as tcli
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
from clip_ppo_tpu_torch.models import clip_utils as tcu
from clip_ppo_tpu_torch.models.agent import init_agent_params
from clip_ppo_tpu_torch.models.clip import model as tmodel
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from clip_ppo_tpu_torch.ops import resize as tresize
from clip_ppo_tpu_torch.train.ppo import PPOConfig as TPPOConfig
from clip_ppo_tpu_torch.train.runner import Draws, Trainer as TTrainer, TrainState
from clip_ppo_tpu_torch.utils import flags
from clip_ppo_tpu_torch.utils.tree import tree_map

TINY = dict(embed_dim=512, image_size=32, patch_size=16, vision_width=128, vision_layers=2,
            vision_heads=2, text_width=128, text_heads=2, text_layers=1, vocab_size=49408)
ENV_ID = "MiniGrid-Empty-5x5-v0"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tower():
    """The JAX package's tree (numpy leaves) and the port's, converted."""
    gen = torch.Generator()
    gen.manual_seed(3)
    jp = tree_map(lambda t: t.numpy(), tmodel.init_clip_params(gen, TCLIPConfig(**TINY), "cpu"))
    return jp, convert.clip_params(jp)


def _jax_agent_params(seed: int, num_actions: int) -> dict:
    """Agent params in the JAX package's layout (conv kernels HWIO), drawn
    by the port's initializer (the JAX one compiles for seconds)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    out = tree_map(lambda t: t.numpy(), init_agent_params(gen, num_actions, "cpu"))
    for name in ("conv1", "conv2", "conv3"):
        out["trunk"][name]["w"] = np.ascontiguousarray(out["trunk"][name]["w"].transpose(2, 3, 1, 0))
    return out


def test_preprocess_for_clip_matches_jax():
    x = np.random.RandomState(0).rand(2, 84, 84, 3).astype(np.float32)
    want = np.asarray(jresize.preprocess_for_clip(jnp.asarray(x), 224))
    got = tresize.preprocess_for_clip(torch.as_tensor(x), 224)
    assert got.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_encode_image_matches_jax(tower):
    jp, tp = tower
    x = np.random.RandomState(1).randn(3, 32, 32, 3).astype(np.float32)
    encode = jax.jit(lambda p, x: jmodel.encode_image(p, CLIPConfig(**TINY), x))
    want = np.asarray(encode(jp, jnp.asarray(x)))
    got = tmodel.encode_image(tp, TCLIPConfig(**TINY), torch.as_tensor(x))
    assert got.shape == (3, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_encode_images_matches_jax(tower):
    jp, tp = tower
    imgs = np.random.RandomState(2).randint(0, 256, (3, 84, 84, 3)).astype(np.uint8)
    want = np.asarray(jcu.encode_images(jp, CLIPConfig(**TINY), jnp.asarray(imgs)))
    got = tcu.make_encode_images_fn(TCLIPConfig(**TINY))(torch.as_tensor(imgs), {"clip": tp})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-5)


def test_trainer_image_iteration_matches_jax(tower):
    jp, tp = tower
    cfg = dict(num_envs=2, num_steps=8, num_minibatches=2, update_epochs=2,
               clip_mode="precomputed")
    jcfg, lam = JPPOConfig(**cfg), 1e-5
    jenv = JaxVectorEnv(ENV_ID, cfg["num_envs"])
    jtr = JTrainer(jcfg, jenv, 10, embed_images_fn=jcu.make_encode_images_fn(CLIPConfig(**TINY)),
                   clip_lambda=lam, frozen_params={"clip": jp})
    jstate = jtr.init_state(_jax_agent_params(1, jenv.num_actions), 7)

    def one_iteration(state, frozen):
        state1, batch = jtr._rollout(state, frozen)
        data = jtr._data2d(state1, batch, frozen)
        emb = jtr.embed_images_fn(data["obs"].reshape((-1,) + data["obs"].shape[2:]), frozen)
        state2, scalars = jtr._update(state1, data, jnp.int32(1), emb, frozen)
        return batch, emb, scalars

    with jax.default_matmul_precision("highest"):
        jbatch, jemb, jscalars = jax.jit(one_iteration)(jstate, jtr.frozen_params)

    # The JAX iteration's draws (rollout.py:96-106, runner.py:500, ppo.py:298).
    key, k_gumbel = jax.random.split(jstate.key)
    gumbels = jax.random.gumbel(k_gumbel, (8, 2, jenv.num_actions), jnp.float32)
    _, k_update = jax.random.split(key)
    perms = np.stack([np.asarray(jax.random.permutation(k, jcfg.batch_size))
                      for k in jax.random.split(k_update, jcfg.update_epochs)])
    draws = Draws(torch.as_tensor(np.array(gumbels)), None, torch.as_tensor(perms))

    tenv = TorchVectorEnv(ENV_ID, cfg["num_envs"], "cpu")
    ttr = TTrainer(TPPOConfig(**cfg), tenv, 10,
                   embed_images_fn=tcu.make_encode_images_fn(TCLIPConfig(**TINY)),
                   clip_lambda=lam, frozen_params={"clip": tp})
    tstate = TrainState(
        params=convert.agent_params(_np(jstate.params)),
        opt_state=convert.adam_state(_np(jstate.opt_state)),
        vec_state=convert.vec_state(_np(jstate.vec_state)),
        obs=torch.as_tensor(np.array(jstate.obs)),
        next_done=torch.as_tensor(np.array(jstate.next_done)),
        gen=torch.Generator(),
    )
    _, tscalars, _, tbatch, tdata = ttr.iteration(tstate, 1, draws)

    for name in ("actions", "rewards", "dones", "obs"):
        np.testing.assert_array_equal(getattr(tbatch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)), err_msg=name)
    temb = ttr.embed(tbatch, tdata)
    assert temb.shape == (16, 512)
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), rtol=1e-5, atol=1e-5)
    for name, value in jscalars.items():
        np.testing.assert_allclose(float(tscalars[name]), float(value), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert float(tscalars["first_clip_loss"]) > 0.0  # the CLIP term ran on the images


def _tiny_clip(name, device, **_):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return tmodel.init_clip_params(gen, TCLIPConfig(**TINY), device), TCLIPConfig(**TINY)


def test_cli_image_modality_runs_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcu, "load_clip_model", _tiny_clip)
    calls = []
    encode = tcu.encode_images
    monkeypatch.setattr(tcu, "encode_images", lambda *a: calls.append(a[2].shape) or encode(*a))
    args = flags.parse(tcli.Args, [
        "--no-cuda", "--env-id", ENV_ID, "--num-envs", "2", "--num-steps", "16",
        "--total-timesteps", "32", "--clip-config.clip-lambda", "1e-5",
        "--clip-config.clip-modality", "image", "--clip-config.apply-disturbances",
        "--clip-config.disturbance-severity", "HARD", "--no-capture-video",
    ])
    out = tcli.train(args, run_name="image")
    assert out["global_step"] == 32 and out["table_seconds"] == 0.0
    assert calls == [(32, 84, 84, 3)]  # one encode of the iteration's 2 x 16 frames
    assert float(out["last_scalars"]["first_clip_loss"]) > 0.0
    assert np.isfinite([float(v) for k, v in out["last_scalars"].items()
                        if k != "explained_variance"]).all()
    assert os.listdir(tmp_path / "runs" / "image")
    assert "image_final.ckpt" in os.listdir(tmp_path / "checkpoints")


@pytest.mark.parametrize("model,error,match", [
    ("ViT-L/14", ValueError, r"Dimension mismatch: PPO latents \(512\) vs CLIP embeddings \(768\)"),
])
def test_cli_rejects_image_towers_it_cannot_run(tmp_path, monkeypatch, model, error, match):
    """Up front, before any tower is built: ViT-L/14's 768-wide embedding
    cannot align with the 512-wide latent, the error the JAX package raises
    at the loss."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcli, "resolve_device", lambda cuda: torch.device("cuda", 0))
    monkeypatch.setattr(tcu, "load_clip_model", lambda *a, **k: pytest.fail("tower built"))
    args = flags.parse(tcli.Args, [
        "--no-capture-video", "--clip-config.clip-lambda", "1e-5",
        "--clip-config.clip-modality", "image", "--clip-config.clip-model", model,
    ])
    with pytest.raises(error, match=match):
        tcli.train(args, run_name="x")
    assert not (tmp_path / "runs").exists()
