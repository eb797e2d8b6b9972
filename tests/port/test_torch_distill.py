"""The structured frozen-tower initialization against the JAX package: the
random-policy observations, the pixel-PCA teacher, the distillation's Adam
steps, and ``--clip-config.structured-frozen-init`` in the CLI.

Draws. ``collect_random_observations`` takes its actions, and
``distill_visual_tower`` its minibatch indices, as inputs; the tests rebuild
both from the JAX package's key splits (the CLI's seed + 2 and seed + 3) and
start the port's env from the JAX reset state.

Tolerances. The observations are uint8 frames and must be equal. The PCA
mean, per-component scale and features agree to 1e-5 (float32 sums over
5,292 pixels); ``torch.linalg.svd`` and ``jnp.linalg.svd`` may each flip a
component's sign, so components and features are compared up to a sign per
component, on the components whose singular values stand apart from their
neighbours (a gap of more than 1% of the largest), where the SVD is unique
up to that sign. The distillation is held against JAX with JAX's PCA
statistics carried across: after 5 Adam steps the visual tower's leaves
agree to 1e-5 in float32 and to 2e-2 in bf16 (Adam's step is about ±lr =
1e-3 wherever a gradient is well above its eps, so bf16 gradients that
differ in their last bits move a leaf by at most a few lr), and the
losses of the five steps to 1e-5 and 2e-2 relative.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.envs import JaxVectorEnv
from clip_ppo_tpu.models import distill as jdistill
from clip_ppo_tpu.models.clip import CLIPConfig
from clip_ppo_tpu.models.clip import model as jmodel
from clip_ppo_tpu.ops import resize as jresize
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as tcli
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
from clip_ppo_tpu_torch.models import clip_utils as tcu
from clip_ppo_tpu_torch.models import distill as tdistill
from clip_ppo_tpu_torch.models.clip import model as tmodel
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from clip_ppo_tpu_torch.models.agent import AblationMode
from clip_ppo_tpu_torch.utils.tree import tree_leaves, tree_map

# embed_dim 512: FROZEN_CLIP's features feed the agent's 512-wide heads.
TINY = dict(embed_dim=512, image_size=32, patch_size=16, vision_width=128, vision_layers=2,
            vision_heads=2, text_width=128, text_heads=2, text_layers=1, vocab_size=49408)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_observations(env_id: str, num_envs: int, seed: int, num_steps: int):
    """The JAX package's observations and, rebuilt from its key splits, the
    reset state and actions that produced them (computed once a module:
    each JAX rollout compiles for seconds)."""
    jenv = JaxVectorEnv(env_id, num_envs)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jdistill.collect_random_observations(jenv, key, num_steps))
    k_reset, k_scan = jax.random.split(key)
    vec_state, obs = jenv.reset_fn(k_reset)
    actions = np.stack([np.asarray(jax.random.randint(k, (num_envs,), 0, jenv.num_actions))
                        for k in jax.random.split(k_scan, num_steps)])
    start = (convert.vec_state(_np(vec_state)), torch.as_tensor(np.array(obs)))
    return want, start, torch.as_tensor(actions)


@pytest.mark.parametrize("env_id,num_envs,num_steps", [
    ("MiniGrid-Empty-8x8-v0", 2, 48),
    ("MiniGrid-DoorKey-6x6-v0", 8, 32),  # the CLI's max(256 // 8, 8) steps of 8 envs
])
def test_collect_random_observations_equal_jax(env_id, num_envs, num_steps):
    want, start, actions = _jax_observations(env_id, num_envs, 3, num_steps)
    env = TorchVectorEnv(env_id, num_envs, "cpu")
    got = tdistill.collect_random_observations(env, torch.Generator(), num_steps,
                                               actions=actions, start=start)
    assert got.dtype == torch.uint8 and got.shape == want.shape == (num_steps * num_envs, 84, 84, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def _separated(s: np.ndarray) -> np.ndarray:
    """Indices of singular values more than 1% of the largest away from both
    neighbours."""
    gap = 0.01 * s[0]
    left = np.r_[np.inf, s[:-1] - s[1:]]
    right = np.r_[s[:-1] - s[1:], np.inf]
    return np.where((left > gap) & (right > gap))[0]


def test_pca_teacher_matches_jax_up_to_sign():
    want_obs, _, _ = _jax_observations("MiniGrid-DoorKey-6x6-v0", 8, 3, 32)
    obs = jnp.asarray(want_obs)
    jteacher, jstats = jdistill.pixel_pca_teacher(obs, 64)
    tteacher, tstats = tdistill.pixel_pca_teacher(torch.as_tensor(want_obs.copy()), 64)
    np.testing.assert_allclose(tstats["mean"].numpy(), np.asarray(jstats["mean"]), atol=1e-6)
    scale = np.asarray(jstats["scale"])
    np.testing.assert_allclose(tstats["scale"].numpy(), scale, rtol=1e-5, atol=1e-6)
    keep = _separated(scale)
    assert len(keep) >= 8
    jc, tc = np.asarray(jstats["components"])[keep], tstats["components"].numpy()[keep]
    sign = np.sign((jc * tc).sum(axis=1))
    np.testing.assert_allclose(tc * sign[:, None], jc, atol=1e-4)
    jf = np.asarray(jteacher(obs))[:, keep]
    tf = tteacher(torch.as_tensor(want_obs.copy())).numpy()[:, keep]
    np.testing.assert_allclose(tf * sign, jf, rtol=1e-4, atol=1e-4)
    # whitened: the leading component's variance is about 1
    assert 0.5 < float(tf[:, 0].var()) < 2.0


def test_pca_teacher_pads_when_samples_are_few():
    obs = torch.randint(0, 256, (6, 8, 8, 3), dtype=torch.uint8, generator=torch.Generator())
    teacher, stats = tdistill.pixel_pca_teacher(obs, 16)
    assert stats["components"].shape == (16, 48) and stats["scale"].shape == (16,)
    assert (stats["components"][6:] == 0).all() and (stats["scale"][6:] == 1).all()
    assert teacher(obs).shape == (6, 16)


@pytest.fixture(scope="module")
def tower():
    gen = torch.Generator()
    gen.manual_seed(7)
    return tree_map(lambda t: t.numpy(), tmodel.init_clip_params(gen, TCLIPConfig(**TINY), "cpu"))


def _jax_student_loss(tower: dict, obs: np.ndarray, targets, dtype):
    """The JAX distillation's loss, from the JAX package's own parts."""
    cfg = CLIPConfig(**TINY)

    def loss(visual):
        x = jresize.preprocess_for_clip(jnp.asarray(obs).astype(jnp.float32) / 255.0,
                                        cfg.image_size)
        feats = jmodel.encode_image({**tower, "visual": visual}, cfg, x, dtype,
                                    attention_impl="xla")
        return jnp.mean((feats - targets) ** 2)

    return loss


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_distillation_loss_and_gradient_match_jax(tower, dtype, tol):
    """The loss and its gradient at the tower's initial values on one
    minibatch: fp32 each leaf within 1e-5 of its largest element (measured
    1.1e-6), bf16 the whole gradient within 2e-2 in L2 (measured 6.8e-3)."""
    obs, _, _ = _jax_observations("MiniGrid-Empty-8x8-v0", 2, 4, 24)
    jteacher, jstats = jdistill.pixel_pca_teacher(jnp.asarray(obs), 512)
    idx = np.random.RandomState(0).randint(0, len(obs), 16)
    targets = np.asarray(jteacher(jnp.asarray(obs)))[idx]
    jloss, jgrad = jax.value_and_grad(_jax_student_loss(tower, obs[idx], targets,
                                                        getattr(jnp, dtype)))(
        jax.tree_util.tree_map(jnp.asarray, tower["visual"]))
    tparams = convert.clip_params(tower)
    visual = tree_map(lambda t: t.clone().requires_grad_(True), tparams["visual"])
    loss = tdistill.student_loss({**tparams, "visual": visual}, TCLIPConfig(**TINY),
                                 torch.as_tensor(obs[idx]), torch.as_tensor(targets),
                                 getattr(torch, dtype))
    grads = torch.autograd.grad(loss, tree_leaves(visual))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=tol)
    want = tree_leaves(tree_map(lambda _, w: np.asarray(w, np.float32), visual, _np(jgrad)))
    got = [g.numpy() for g in grads]
    if dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max())
    else:
        err = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
        norm = sum(float((w ** 2).sum()) for w in want)
        assert (err / norm) ** 0.5 < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_distillation_steps_match_jax(tower, dtype, capsys):
    """Five Adam steps of the JAX package's ``distill_visual_tower`` and of
    the port's on the same minibatches, with JAX's PCA statistics. Adam's
    first step moves each element by about ±lr whatever its gradient's size,
    so an element whose gradient is near zero steps one way in one package
    and the other way in the other even in float32 (after one step up to
    2e-3 = 2 lr, measured): the leaves are held to Adam's reach, 2 lr a
    step, and the losses the two packages print to their 4 decimals, and the
    distilled towers' loss over every observation to 1e-3 (fp32) and 2e-2
    (bf16) relative."""
    steps, batch, lr = 5, 16, 1e-3
    obs, _, _ = _jax_observations("MiniGrid-Empty-8x8-v0", 2, 4, 24)
    jteacher, jstats = jdistill.pixel_pca_teacher(jnp.asarray(obs), 512)
    key = jax.random.PRNGKey(5)
    want = jdistill.distill_visual_tower(key, tower, CLIPConfig(**TINY), jnp.asarray(obs),
                                         steps=steps, batch_size=batch,
                                         compute_dtype=getattr(jnp, dtype))
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    indices = torch.as_tensor(np.stack([
        np.asarray(jax.random.randint(k, (batch,), 0, len(obs)))
        for k in jax.random.split(key, steps)]))
    tparams = convert.clip_params(tower)
    got, losses = tdistill.distill_visual_tower(
        None, tparams, TCLIPConfig(**TINY), torch.as_tensor(obs), steps=steps, batch_size=batch,
        compute_dtype=getattr(torch, dtype), indices=indices,
        stats=convert.clip_params(_np(jstats)))
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    assert losses.shape == (steps,) and losses.dtype == torch.float32
    jfirst, jlast = (float(v) for v in jline.split("MSE ")[1].split(" over")[0].split(" → "))
    tol = 1e-3 if dtype == "float32" else 2e-2
    np.testing.assert_allclose([float(losses[0]), float(losses[-1])], [jfirst, jlast],
                               rtol=tol, atol=1e-4)
    assert tline.split(":")[0] == jline.split(":")[0]
    assert float(losses[-1]) < 0.5 * float(losses[0])

    def check(g, w):
        assert g.dtype == torch.float32 and not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2 * lr * steps)

    tree_map(check, got["visual"], _np(want["visual"]))
    assert got["text"] is tparams["text"]  # the text tower is shared, untouched
    targets = tdistill.pca_features(convert.clip_params(_np(jstats)), torch.as_tensor(obs))
    mse = [float(tdistill.student_loss(p, TCLIPConfig(**TINY), torch.as_tensor(obs), targets,
                                       torch.float32))
           for p in (got, {**tparams, "visual": convert.clip_params(_np(want["visual"]))})]
    np.testing.assert_allclose(mse[0], mse[1], rtol=tol)


def test_distillation_draws_its_own_indices_and_lowers_the_loss(tower):
    obs, _, _ = _jax_observations("MiniGrid-Empty-8x8-v0", 2, 4, 24)
    params = convert.clip_params(tower)
    gen = torch.Generator()
    gen.manual_seed(0)
    before = [t.clone() for t in tree_leaves(params["visual"])]
    _, losses = tdistill.distill_visual_tower(gen, params, TCLIPConfig(**TINY),
                                              torch.as_tensor(obs), steps=60, batch_size=16,
                                              compute_dtype=torch.float32)
    assert float(losses[-10:].mean()) < 0.5 * float(losses[:5].mean())
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params["visual"])))


def _tiny_clip(name, device, **_):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return tmodel.init_clip_params(gen, TCLIPConfig(**TINY), device), TCLIPConfig(**TINY)


@pytest.mark.parametrize("mode,extra", [
    ("FROZEN_CLIP", []),
    ("NONE", ["--clip-config.clip-lambda", "1e-5", "--clip-config.clip-modality", "image"]),
])
def test_cli_flag_distills_the_loaded_tower(tmp_path, monkeypatch, mode, extra):
    """As ``tests/test_distill.py``: the flag runs under FROZEN_CLIP (the
    distilled tower, cast to bf16, is the trunk) and in the image modality
    (the distilled tower encodes the frames), with the JAX CLI's draws'
    seeds and step counts."""
    from clip_ppo_tpu_torch.utils import flags

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcu, "load_clip_model", _tiny_clip)
    calls = []
    real = tdistill.distill_visual_tower

    def spy(gen, params, cfg, obs, *a, **k):
        calls.append((gen.initial_seed(), tuple(obs.shape)))
        return real(gen, params, cfg, obs, *a, **k)

    monkeypatch.setattr(tdistill, "distill_visual_tower", spy)
    args = flags.parse(tcli.Args, [
        "--no-cuda", "--env-id", "MiniGrid-Empty-5x5-v0", "--num-envs", "2", "--num-steps", "8",
        "--num-minibatches", "2", "--update-epochs", "1", "--total-timesteps", "32",
        "--no-capture-video", "--no-save-model", "--seed", "3",
        "--clip-config.ablation-mode", mode, "--clip-config.structured-frozen-init", *extra,
    ])
    out = tcli.train(args, run_name=f"structured_{mode}")
    assert out["global_step"] == 32
    assert calls == [(3 + 3, (128 * 2, 84, 84, 3))]  # max(256 // 2, 8) steps of 2 envs
    losses = out["distill_losses"]
    assert losses.shape == (300,) and float(losses[-20:].mean()) < float(losses[:5].mean())
    assert np.isfinite([float(v) for k, v in out["last_scalars"].items()
                        if k != "explained_variance"]).all()
    assert (float(out["last_scalars"]["first_clip_loss"]) > 0.0) == (mode == "NONE")


def test_cli_without_the_flag_distills_nothing(tmp_path, monkeypatch):
    from clip_ppo_tpu_torch.utils import flags

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcu, "load_clip_model", _tiny_clip)
    monkeypatch.setattr(tdistill, "distill_visual_tower", None)  # would raise if called
    args = flags.parse(tcli.Args, [
        "--no-cuda", "--env-id", "MiniGrid-Empty-5x5-v0", "--num-envs", "2", "--num-steps", "8",
        "--total-timesteps", "16", "--no-capture-video", "--no-save-model",
        "--clip-config.ablation-mode", AblationMode.FROZEN_CLIP.value,
    ])
    out = tcli.train(args, run_name="plain")
    assert out["distill_losses"] is None and out["distill_seconds"] == 0.0
