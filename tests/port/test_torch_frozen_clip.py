"""The FROZEN_CLIP and RANDOM_ENCODER ablations against the JAX package: the
frozen-CLIP feature trunk, one Trainer iteration of each, and the CLIs (and
``benchmark_clip`` at its default bf16) on the CPU.

The tower is tiny (image 32, patch 16, width 128 = 2 heads × 64, 2 layers),
drawn once and handed to the JAX package as its numpy tree and to the port
through ``convert.clip_params``; the port casts it once to bf16
(``model.cast_tower``), as its CLI does. Both packages run it in bf16.

Tolerances. The frozen features (not normalized): 2e-2 × max |ref|, the
bound ``tests/test_clip.py`` puts on bf16 against float32: the two packages
round the same bf16 steps in other orders (the JAX package runs its einsum
path on the CPU with the resblocks' LayerNorm parameters in float32, the
port its plain versions of K2 and K3 with them in bf16), about one bf16 ulp
of a feature. Through the heads that moves the FROZEN_CLIP iteration's
values by up to 0.018 (of 0.50) and its log-probs by 1.4e-4, measured on the
CPU, held to 5e-2 and 1e-3; the losses to 5e-2 relative or 1e-3 absolute.
Adam's step is about ±lr wherever a gradient is well above eps, so an
element whose gradient sits near zero may step the other way: after 4 Adam
steps of lr 2.5e-4 the actor and critic within 2 lr per step (measured
9.5e-4 of the 2e-3 allowed), their moments within 1e-1 of their largest
element (measured up to 6.7e-2). The iteration runs on a seed where one env
reaches the goal: with no reward at all the advantages are bf16 noise over
their own tiny spread, and their normalization magnifies it to the size of
the signal. The agent's own conv trunk
is not in the loss: its parameters stay exactly at their initial values and
its Adam moments exactly 0 in both packages (``jax.grad`` gives its
gradient as zeros; the port's update asks autograd for zeros where a
parameter is unused, ``train/ppo.py``). RANDOM_ENCODER runs no tower: the
embeddings are the JAX iteration's own normals, normalized (1e-6), and the
iteration agrees to the float32 tolerance of ``test_torch_image.py``, 1e-4.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.envs import JaxVectorEnv
from clip_ppo_tpu.models import clip_utils as jcu
from clip_ppo_tpu.models.clip import CLIPConfig
from clip_ppo_tpu.train import PPOConfig as JPPOConfig
from clip_ppo_tpu.train import Trainer as JTrainer
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.cli import benchmark_clip as tbench
from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as tcli
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
from clip_ppo_tpu_torch.io.checkpoint import load_checkpoint
from clip_ppo_tpu_torch.models import clip_utils as tcu
from clip_ppo_tpu_torch.models.agent import init_agent_params
from clip_ppo_tpu_torch.models.clip import model as tmodel
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from clip_ppo_tpu_torch.train.ppo import PPOConfig as TPPOConfig
from clip_ppo_tpu_torch.train.ppo import init_adam_state
from clip_ppo_tpu_torch.train.runner import Draws, Trainer as TTrainer, TrainState
from clip_ppo_tpu_torch.utils import flags
from clip_ppo_tpu_torch.utils.tree import tree_leaves, tree_map

TINY = dict(embed_dim=512, image_size=32, patch_size=16, vision_width=128, vision_layers=2,
            vision_heads=2, text_width=128, text_heads=2, text_layers=1, vocab_size=49408)
ENV_ID = "MiniGrid-Empty-5x5-v0"
CFG = dict(num_envs=2, num_steps=8, num_minibatches=2, update_epochs=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tower():
    """The JAX package's tree (numpy leaves), and the port's cast to bf16."""
    gen = torch.Generator()
    gen.manual_seed(5)
    jp = tree_map(lambda t: t.numpy(), tmodel.init_clip_params(gen, TCLIPConfig(**TINY), "cpu"))
    return jp, tmodel.cast_tower(convert.clip_params(jp), torch.bfloat16)


def _jax_agent_params(seed: int, num_actions: int) -> dict:
    """Agent params in the JAX package's layout (conv kernels HWIO), drawn
    by the port's initializer."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    out = tree_map(lambda t: t.numpy(), init_agent_params(gen, num_actions, "cpu"))
    for name in ("conv1", "conv2", "conv3"):
        out["trunk"][name]["w"] = np.ascontiguousarray(out["trunk"][name]["w"].transpose(2, 3, 1, 0))
    return out


def _port_state(jstate) -> TrainState:
    return TrainState(
        params=convert.agent_params(_np(jstate.params)),
        opt_state=convert.adam_state(_np(jstate.opt_state)),
        vec_state=convert.vec_state(_np(jstate.vec_state)),
        obs=torch.as_tensor(np.array(jstate.obs)),
        next_done=torch.as_tensor(np.array(jstate.next_done)),
        gen=torch.Generator(),
    )


def test_frozen_clip_features_match_jax(tower):
    jp, tp = tower
    obs = np.random.RandomState(6).randint(0, 256, (3, 84, 84, 3)).astype(np.uint8)
    jfn = jcu.make_frozen_clip_features_fn(CLIPConfig(**TINY))
    want = np.asarray(jax.jit(jfn)({}, jnp.asarray(obs), {"clip": jp}))
    got = tcu.make_frozen_clip_features_fn(TCLIPConfig(**TINY))({}, torch.as_tensor(obs),
                                                                  {"clip": tp})
    assert got.dtype == torch.float32 and got.shape == (3, 512) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2 * np.abs(want).max())


def test_random_embed_fn_normalizes_given_or_drawn_normals():
    fn = tcu.make_random_embed_fn(4, embed_dim=8, frames=2)
    normals = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    got = fn(None, normals)
    assert got.shape == (4, 16)
    np.testing.assert_allclose(got.reshape(8, 8).norm(dim=-1).numpy(), 1.0, rtol=1e-6)
    want = jcu.make_random_embed_fn(4, 8, 2)  # the JAX fn draws its own; same layout
    ref = np.asarray(want(jax.random.PRNGKey(0)))
    assert ref.shape == (4, 16)
    drawn = fn(torch.Generator().manual_seed(1))
    assert drawn.shape == (4, 16) and not torch.equal(drawn, got)


def _compare_batches(tbatch, jbatch, names=("actions", "rewards", "dones", "obs")):
    for name in names:
        np.testing.assert_array_equal(getattr(tbatch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)), err_msg=name)


def test_trainer_frozen_clip_iteration_matches_jax(tower):
    jp, tp = tower
    jcfg = JPPOConfig(**CFG)
    jenv = JaxVectorEnv(ENV_ID, CFG["num_envs"])
    jtr = JTrainer(jcfg, jenv, 10,
                   features_fn=jcu.make_frozen_clip_features_fn(CLIPConfig(**TINY)),
                   frozen_params={"clip": jp})
    # An actor that leans to "forward" and "right", and a seed on which one
    # env reaches the goal in its 8 steps: with no reward the advantages are
    # bf16 noise over their own tiny spread, and normalizing them would blow
    # that noise up to the size of the signal.
    params = _jax_agent_params(2, jenv.num_actions)
    params["actor"]["b"] = np.array([0, 1, 2, 0, 0, 0, 0], np.float32)
    jstate = jtr.init_state(params, 1)
    assert not jtr.view_mode

    def one_iteration(state, frozen):
        state1, batch = jtr._rollout(state, frozen)
        data = jtr._data2d(state1, batch, frozen)
        state2, scalars = jtr._update(state1, data, jnp.int32(1), None, frozen)
        return batch, data, scalars, state2

    jbatch, jdata, jscalars, jstate2 = jax.jit(one_iteration)(jstate, jtr.frozen_params)

    # The JAX iteration's draws (rollout.py:96-106, runner.py:500, ppo.py:298).
    key, k_gumbel = jax.random.split(jstate.key)
    gumbels = jax.random.gumbel(k_gumbel, (8, 2, jenv.num_actions), jnp.float32)
    _, k_update = jax.random.split(key)
    perms = np.stack([np.asarray(jax.random.permutation(k, jcfg.batch_size))
                      for k in jax.random.split(k_update, jcfg.update_epochs)])
    draws = Draws(torch.as_tensor(np.array(gumbels)), None, torch.as_tensor(perms))

    tenv = TorchVectorEnv(ENV_ID, CFG["num_envs"], "cpu")
    ttr = TTrainer(TPPOConfig(**CFG), tenv, 10,
                   features_fn=tcu.make_frozen_clip_features_fn(TCLIPConfig(**TINY)),
                   frozen_params={"clip": tp})
    assert not ttr.view_mode
    tstate = _port_state(jstate)
    trunk0 = tree_map(lambda t: t.clone(), tstate.params["trunk"])
    tstate2, tscalars, _, tbatch, tdata = ttr.iteration(tstate, 1, draws)

    _compare_batches(tbatch, jbatch)
    assert float(tbatch.rewards.sum()) > 0.0
    np.testing.assert_allclose(tbatch.values.numpy(), np.asarray(jbatch.values), rtol=0,
                               atol=5e-2)
    np.testing.assert_allclose(tbatch.logprobs.numpy(), np.asarray(jbatch.logprobs), rtol=0,
                               atol=1e-3)
    for name in ("policy_loss", "value_loss", "entropy", "approx_kl", "old_approx_kl",
                 "clipfrac", "first_pg_loss", "first_v_loss", "first_entropy"):
        np.testing.assert_allclose(float(tscalars[name]), float(jscalars[name]), rtol=5e-2,
                                   atol=1e-3, err_msg=name)
    np.testing.assert_allclose(float(tscalars["explained_variance"]),
                               float(jscalars["explained_variance"]), rtol=0, atol=1e-2)
    assert float(tscalars["clip_loss"]) == float(jscalars["clip_loss"]) == 0.0  # no CLIP loss

    jparams = convert.agent_params(_np(jstate2.params))
    jopt = convert.adam_state(_np(jstate2.opt_state))
    steps = int(jopt["count"])
    assert int(tstate2.opt_state["count"]) == steps == 4
    for part in ("actor", "critic"):
        for k in ("w", "b"):
            np.testing.assert_allclose(tstate2.params[part][k].numpy(), jparams[part][k].numpy(),
                                       rtol=0, atol=2 * 2.5e-4 * steps, err_msg=f"{part}.{k}")
            for moment in ("mu", "nu"):
                want = jopt[moment][part][k].numpy()
                np.testing.assert_allclose(tstate2.opt_state[moment][part][k].numpy(), want,
                                           rtol=0, atol=1e-1 * np.abs(want).max(),
                                           err_msg=f"{moment} {part}.{k}")
    # The unused conv trunk: exactly its initial values, moments exactly 0,
    # in both packages.
    for got, want, start in zip(tree_leaves(tstate2.params["trunk"]),
                                tree_leaves(jparams["trunk"]), tree_leaves(trunk0)):
        assert torch.equal(got, start) and torch.equal(want, start)
    for moment in ("mu", "nu"):
        for got, want in zip(tree_leaves(tstate2.opt_state[moment]["trunk"]),
                             tree_leaves(jopt[moment]["trunk"])):
            assert not got.any() and not want.any()


def test_trainer_random_encoder_iteration_matches_jax():
    cfg = dict(CFG, clip_mode="precomputed")
    jcfg, lam = JPPOConfig(**cfg), 1e-5
    jenv = JaxVectorEnv(ENV_ID, cfg["num_envs"])
    jtr = JTrainer(jcfg, jenv, 10, embed_random_fn=jcu.make_random_embed_fn(jcfg.batch_size),
                   clip_lambda=lam)
    jstate = jtr.init_state(_jax_agent_params(4, jenv.num_actions), 5)

    def one_iteration(state):
        state1, batch = jtr._rollout(state, None)
        data = jtr._data2d(state1, batch, None)
        key, k_emb = jax.random.split(state1.key)  # runner.py:763-765
        emb = jtr.embed_random_fn(k_emb)
        state2, scalars = jtr._update(dataclasses.replace(state1, key=key), data, jnp.int32(1),
                                      emb, None)
        return batch, emb, scalars, state2, k_emb, key

    jbatch, jemb, jscalars, jstate2, k_emb, key_after = jax.jit(one_iteration)(jstate)

    # The JAX iteration's draws: the Gumbel batch, the embeddings' normals
    # (runner.py:763-765, clip_utils.py:305-319), the permutations.
    key, k_gumbel = jax.random.split(jstate.key)
    gumbels = jax.random.gumbel(k_gumbel, (8, 2, jenv.num_actions), jnp.float32)
    normals = np.asarray(jax.random.normal(k_emb, (jcfg.batch_size, 512), jnp.float32))
    _, k_update = jax.random.split(key_after)
    perms = np.stack([np.asarray(jax.random.permutation(k, jcfg.batch_size))
                      for k in jax.random.split(k_update, jcfg.update_epochs)])
    draws = Draws(torch.as_tensor(np.array(gumbels)), None, torch.as_tensor(perms),
                  torch.as_tensor(normals.copy()))

    tenv = TorchVectorEnv(ENV_ID, cfg["num_envs"], "cpu")
    ttr = TTrainer(TPPOConfig(**cfg), tenv, 10,
                   embed_random_fn=tcu.make_random_embed_fn(jcfg.batch_size), clip_lambda=lam)
    assert ttr.view_mode == jtr.view_mode
    tstate2, tscalars, _, tbatch, tdata = ttr.iteration(_port_state(jstate), 1, draws)

    _compare_batches(tbatch, jbatch)
    temb = ttr.embed(tbatch, tdata, None, torch.as_tensor(normals.copy()))
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), rtol=0, atol=1e-6)
    for name, value in jscalars.items():
        np.testing.assert_allclose(float(tscalars[name]), float(value), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert float(tscalars["first_clip_loss"]) > 0.0  # the CLIP term ran on the random embeddings
    jparams = convert.agent_params(_np(jstate2.params))
    for got, want in zip(tree_leaves(tstate2.params), tree_leaves(jparams)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def _tiny_clip(name, device, **_):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return tmodel.init_clip_params(gen, TCLIPConfig(**TINY), device), TCLIPConfig(**TINY)


@pytest.mark.parametrize("mode,extra", [
    ("FROZEN_CLIP", []),
    ("RANDOM_ENCODER", ["--clip-config.clip-lambda", "1e-5"]),
])
def test_cli_ablations_run_on_cpu(tmp_path, monkeypatch, mode, extra):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcu, "load_clip_model", _tiny_clip)
    args = flags.parse(tcli.Args, [
        "--no-cuda", "--env-id", ENV_ID, "--num-envs", "2", "--num-steps", "8",
        "--total-timesteps", "32", "--clip-config.ablation-mode", mode,
        "--clip-config.apply-disturbances", "--clip-config.disturbance-severity", "HARD",
        "--no-capture-video", "--seed", "3", *extra,
    ])
    out = tcli.train(args, run_name=mode)
    assert out["global_step"] == 32 and out["table_seconds"] == 0.0 and not out["view_mode"]
    scalars = out["last_scalars"]
    assert np.isfinite([float(v) for k, v in scalars.items() if k != "explained_variance"]).all()
    if mode == "RANDOM_ENCODER":
        assert float(scalars["first_clip_loss"]) > 0.0
    else:
        assert float(scalars["first_clip_loss"]) == 0.0  # FROZEN_CLIP has no CLIP loss
    assert os.listdir(tmp_path / "runs" / mode)
    template = init_agent_params(torch.Generator(), 7, "cpu")
    params, opt_state, it, _, _ = load_checkpoint(
        str(tmp_path / "checkpoints" / f"{mode}_final.ckpt"), template, init_adam_state(template),
        "cpu")
    assert it == 2 and int(opt_state["count"]) == 2 * 4 * 4
    start = init_agent_params(torch.Generator().manual_seed(3), 7, "cpu")
    trunk_moved = any(not torch.equal(a, b) for a, b in zip(tree_leaves(params["trunk"]),
                                                            tree_leaves(start["trunk"])))
    assert trunk_moved == (mode != "FROZEN_CLIP")  # the frozen trunk's conv layers never move


def _b32_like(name, device, **_):
    """A narrow two-layer tower whose widths fit K2 and K3's routes."""
    cfg = CLIPConfig(**{**TINY, "vision_layers": 1})
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return tmodel.init_clip_params(gen, cfg, device), cfg


def test_benchmark_runs_its_default_bf16_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(tbench, "load_clip_model", _b32_like)
    seen = []
    real = tmodel.encode_image
    monkeypatch.setattr(tbench, "encode_image",
                        lambda p, cfg, x, dtype, **k: seen.append(
                            (dtype, p["visual"]["proj"].dtype)) or real(p, cfg, x, dtype, **k))
    tbench.main(["--no-cuda", "--batch-sizes", "2", "--text-batch", "2", "--iterations", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "model=ViT-B/32 dtype=bfloat16 device=cpu (cpu)"
    assert len(lines) == 4 and lines[3].startswith("text  batch=2: ")
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 2  # the tower cast once, run in bf16
