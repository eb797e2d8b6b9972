"""``--recurrent``, the LSTM agent, against the JAX package's.

The cell (``models/recurrent.py``) matches the JAX package's and
``torch.nn.LSTMCell`` at 1e-6, its done-mask resets where an episode ended,
and the update's sequence replay reproduces the rollout's log-probs at
unchanged parameters (approx_kl < 1e-9, as the JAX package's
``tests/test_recurrent.py`` requires). One recurrent Trainer iteration on
MiniGrid-Empty-5x5 (4 envs × 16 steps, 2 epochs × 2 env-slice minibatches)
from converted params, Adam state and env state matches the JAX Trainer's
at 1e-5, with the Gumbel batch and the env permutations recomputed from the
JAX key splits (`train/rollout.py:193-196`, `train/runner.py:500`,
`train/ppo.py:426-429`). The CLI trains with ``--recurrent``, writes the
carried (h, c) as ``lstm_carry_state`` and resumes it bit-identically; the
Trainer refuses it beside a CLIP modality and with an env count the
minibatches do not divide.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.envs import JaxVectorEnv
from clip_ppo_tpu.models import recurrent as jrec
from clip_ppo_tpu.train import PPOConfig as JPPOConfig
from clip_ppo_tpu.train import Trainer as JTrainer
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.cli import ppo_minigrid as tcli
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
from clip_ppo_tpu_torch.models import recurrent as trec
from clip_ppo_tpu_torch.train import ppo as tppo
from clip_ppo_tpu_torch.train.ppo import PPOConfig as TPPOConfig
from clip_ppo_tpu_torch.train.runner import Draws, Trainer as TTrainer, TrainState
from clip_ppo_tpu_torch.utils import flags

ENV_ID = "MiniGrid-Empty-5x5-v0"
CFG = dict(num_envs=4, num_steps=16, num_minibatches=2, update_epochs=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def test_cell_matches_jax_and_torch_lstm_cell():
    p = jrec.init_lstm(jax.random.PRNGKey(0), 12, 8)
    p = dict(p, b=jax.random.normal(jax.random.PRNGKey(1), (32,)) * 0.1)
    tp = {k: _t(v) for k, v in _np(p).items()}
    rng = np.random.RandomState(0)
    x, h0, c0 = (rng.randn(5, n).astype(np.float32) for n in (12, 8, 8))
    done = np.array([1.0, 0.0, 1.0, 0.0, 0.0], np.float32)

    out, (h, c) = trec.lstm_step(tp, _t(x), (_t(h0), _t(c0)))
    jout, (jh, jc) = jrec.lstm_step(p, jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)))
    cell = torch.nn.LSTMCell(12, 8)
    with torch.no_grad():
        cell.weight_ih.copy_(tp["w_ih"].T)
        cell.weight_hh.copy_(tp["w_hh"].T)
        cell.bias_ih.copy_(tp["b"])
        cell.bias_hh.zero_()
        th, tc = cell(_t(x), (_t(h0), _t(c0)))
    for got, ref in ((h, jh), (c, jc), (out, jout), (h, th), (c, tc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.detach() if isinstance(
            ref, torch.Tensor) else ref), rtol=0, atol=1e-6)

    mout, (mh, mc) = trec.masked_lstm_step(tp, _t(x), (_t(h0), _t(c0)), _t(done))
    jm, (jmh, jmc) = jrec.masked_lstm_step(p, jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)),
                                           jnp.asarray(done))
    for got, ref in ((mout, jm), (mh, jmh), (mc, jmc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    fresh, _ = trec.lstm_step(tp, _t(x), (torch.zeros(5, 8), torch.zeros(5, 8)))
    np.testing.assert_array_equal(mout[[0, 2]].numpy(), fresh[[0, 2]].numpy())  # reset where done
    np.testing.assert_array_equal(mout[[1, 3, 4]].numpy(), out[[1, 3, 4]].numpy())

    xs = rng.randn(6, 5, 12).astype(np.float32)
    dones = (rng.rand(6, 5) < 0.3).astype(np.float32)
    hs, (uh, uc) = trec.unroll(tp, _t(xs), _t(dones), (_t(h0), _t(c0)))
    jhs, (juh, juc) = jrec.unroll(p, jnp.asarray(xs), jnp.asarray(dones),
                                  (jnp.asarray(h0), jnp.asarray(c0)))
    for got, ref in ((hs, jhs), (uh, juh), (uc, juc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_init_is_orthogonal_with_zero_bias_and_concat_heads():
    gen = torch.Generator()
    gen.manual_seed(0)
    p = trec.init_agent_params_recurrent(gen, 7, "cpu", lstm_hidden=16)
    assert p["lstm"]["w_ih"].shape == (512, 64) and p["lstm"]["w_hh"].shape == (16, 64)
    assert not p["lstm"]["b"].any()
    w = p["lstm"]["w_hh"]
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(16), atol=1e-5)
    assert p["actor"]["w"].shape == (528, 7) and p["critic"]["w"].shape == (528, 1)
    jp = jrec.init_agent_params_recurrent(jax.random.PRNGKey(0), 7, lstm_hidden=16)
    got = jax.tree_util.tree_map(lambda a: a.shape, _np(jp))
    want = convert.jax_agent_params(p)
    assert jax.tree_util.tree_map(lambda a: a.shape, want) == got


def test_replay_matches_rollout_logprobs():
    """At unchanged parameters the update's replay reproduces the rollout's
    log-probs: 128 steps exceed Empty-5x5's max_steps of 100, so episodes
    end inside the rollout and the reset path is replayed."""
    cfg = TPPOConfig(num_envs=8, num_steps=128, num_minibatches=4, update_epochs=2)
    env = TorchVectorEnv(ENV_ID, 8, "cpu")
    tr = TTrainer(cfg, env, 40, recurrent=True)
    assert tr.view_mode  # the view fast path stays on under --recurrent
    gen = torch.Generator()
    gen.manual_seed(0)
    state = tr.init_state(trec.init_agent_params_recurrent(gen, env.num_actions, "cpu"), 0)
    init = state.lstm_state
    state2, batch = tr._rollout(state, Draws())
    data = tr._data2d(state2, batch)
    assert float(batch.dones.sum()) > 0
    assert float(state2.lstm_state[0].norm()) > 0
    with torch.no_grad():
        _, aux = tppo.recurrent_loss(state2.params, dict(data, h0=init[0], c0=init[1]), cfg,
                                     tr.features_fn)
    assert abs(float(aux["approx_kl"])) < 1e-9
    assert abs(float(aux["old_approx_kl"])) < 1e-9


def _jax_draws(key, cfg, num_actions):
    """Replay the JAX recurrent iteration's key chain: the rollout's Gumbel
    batch, then one env permutation an epoch."""
    key, k_gumbel = jax.random.split(key)
    gumbels = jax.random.gumbel(k_gumbel, (cfg.num_steps, cfg.num_envs, num_actions))
    _, k_update = jax.random.split(key)
    perms = np.stack([np.asarray(jax.random.permutation(k, cfg.num_envs))
                      for k in jax.random.split(k_update, cfg.update_epochs)])
    return Draws(_t(gumbels), None, torch.as_tensor(perms))


def test_recurrent_iteration_matches_jax():
    jcfg = JPPOConfig(**CFG)
    jenv = JaxVectorEnv(ENV_ID, CFG["num_envs"])
    jtr = JTrainer(jcfg, jenv, 10, recurrent=True)
    params = jrec.init_agent_params_recurrent(jax.random.PRNGKey(1), jenv.num_actions,
                                              lstm_hidden=32)
    jstate = jtr.init_state(params, 7)
    # a non-zero carried state, as after earlier iterations, and two envs
    # that truncate inside the rollout, so the replay crosses a reset
    h0 = jax.random.normal(jax.random.PRNGKey(2), (4, 32)) * 0.5
    vs = jstate.vec_state
    env = dataclasses.replace(vs.env, step_count=jnp.asarray([95, 0, 90, 40], jnp.int32))
    jstate = dataclasses.replace(jstate, lstm_state=(h0, jnp.tanh(h0)),
                                 vec_state=dataclasses.replace(vs, env=env))

    def one_iteration(state):
        init = state.lstm_state
        state1, batch = jtr._rollout(state, None)
        data = jtr._data2d(state1, batch, None)
        state2, scalars = jtr._update(state1, data, jnp.int32(1), None, None,
                                      initial_lstm_state=init)
        return batch, data, state1, state2, scalars

    with jax.default_matmul_precision("highest"):
        jbatch, jdata, jstate1, jstate2, jscalars = jax.jit(one_iteration)(jstate)
    draws = _jax_draws(jstate.key, jcfg, jenv.num_actions)

    tenv = TorchVectorEnv(ENV_ID, CFG["num_envs"], "cpu")
    ttr = TTrainer(TPPOConfig(**CFG), tenv, 10, recurrent=True)
    assert ttr.view_mode is jtr.view_mode is True
    tstate = TrainState(
        params=convert.agent_params(_np(jstate.params)),
        opt_state=convert.adam_state(_np(jstate.opt_state)),
        vec_state=convert.vec_state(_np(jstate.vec_state)),
        obs=_t(jstate.obs), next_done=_t(jstate.next_done), gen=torch.Generator(),
        lstm_state=tuple(_t(a) for a in jstate.lstm_state),
    )
    tstate2, tscalars, _, tbatch, tdata = ttr.iteration(tstate, 1, draws)

    for name in ("actions", "rewards", "dones", "done_mask"):
        np.testing.assert_array_equal(getattr(tbatch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)), err_msg=name)
    assert float(tbatch.dones.sum()) == 2  # both truncations are replayed
    np.testing.assert_array_equal(tbatch.obs.numpy(), np.asarray(jbatch.obs))
    for name in ("logprobs", "values"):
        np.testing.assert_allclose(getattr(tbatch, name).numpy(), np.asarray(getattr(jbatch, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    for name in ("advantages", "returns", "dones"):
        np.testing.assert_allclose(tdata[name].numpy(), np.asarray(jdata[name]),
                                   rtol=0, atol=1e-5, err_msg=name)
    for got, ref in zip(tstate2.lstm_state, jstate1.lstm_state):  # carried past the rollout
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    for name, value in jscalars.items():
        np.testing.assert_allclose(float(tscalars[name]), float(value), rtol=0, atol=1e-5,
                                   err_msg=name)
    want = jax.tree_util.tree_leaves(_np(jstate2.params))
    got = jax.tree_util.tree_leaves(convert.jax_agent_params(tstate2.params))
    assert len(want) == len(got) == 15
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_trainer_refuses_clip_and_indivisible_envs():
    env = TorchVectorEnv(ENV_ID, 6, "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        TTrainer(TPPOConfig(num_envs=6, num_steps=8, num_minibatches=4), env, 2, recurrent=True)
    env = TorchVectorEnv(ENV_ID, 4, "cpu")
    cfg = TPPOConfig(num_envs=4, num_steps=8, num_minibatches=2)
    for kwargs in ({"embed_desc_fn": lambda d, f: None}, {"embed_images_fn": lambda o, f: None},
                   {"embed_random_fn": lambda g, n: None}, {"clip_lambda": 1e-5}):
        with pytest.raises(ValueError, match="vanilla PPO only"):
            TTrainer(cfg, env, 2, recurrent=True, **kwargs)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _args(tmp_path, *extra):
    return flags.parse(tcli.Args, [
        "--no-cuda", "--env-id", "MiniGrid-MemoryS7-v0", "--recurrent", "--lstm-hidden", "16",
        "--num-envs", "4", "--num-steps", "16", "--num-minibatches", "2", "--update-epochs", "2",
        "--total-timesteps", "128", "--save-freq", "64", "--no-capture-video", "--seed", "3",
        "--model-path", str(tmp_path / "checkpoints"), *extra,
    ])


def test_cli_recurrent_trains_writes_lstm_carry_and_resumes(tmp_path, monkeypatch):
    """Two iterations uninterrupted, then the same run resumed from the
    checkpoint after the first: the resumed run ends bit-identical, its
    LSTM carry included."""
    monkeypatch.chdir(tmp_path)
    ckpts = tmp_path / "checkpoints"
    full = tcli.train(_args(tmp_path), run_name="full")
    assert full["recurrent"] and full["view_mode"] and full["global_step"] == 128
    mid = _load(ckpts / "full_step_64.ckpt")
    h, c = mid["lstm_carry_state"]
    assert h.shape == c.shape == (4, 16) and np.abs(h).sum() > 0
    assert mid["agent_state"]["lstm"]["w_hh"].shape == (16, 64)
    half = tcli.train(_args(tmp_path, "--resume-checkpoint", str(ckpts / "full_step_64.ckpt")),
                      run_name="half")
    assert half["global_step"] == 128
    a, b = _load(ckpts / "full_final.ckpt"), _load(ckpts / "half_final.ckpt")
    for x, y in zip(jax.tree_util.tree_leaves(a["agent_state"]),
                    jax.tree_util.tree_leaves(b["agent_state"])):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a["lstm_carry_state"], b["lstm_carry_state"]):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a["lstm_carry_state"][0], h)


def test_cli_resumes_a_jax_recurrent_checkpoint(tmp_path, monkeypatch):
    """A checkpoint as the JAX CLI writes it under ``--recurrent`` on
    MemoryS7: params with the LSTM, the optimizer, the env state of its
    ``loop_state`` (the mission ``target`` included) and its
    ``lstm_carry``, all taken by the port's CLI."""
    from clip_ppo_tpu.io.checkpoint import save_checkpoint as jsave

    env_id = "MiniGrid-MemoryS7-v0"
    jenv = JaxVectorEnv(env_id, 2)
    jtr = JTrainer(JPPOConfig(num_envs=2, num_steps=16, num_minibatches=2), jenv, 2,
                   recurrent=True)
    params = jrec.init_agent_params_recurrent(jax.random.PRNGKey(2), 7, lstm_hidden=16)
    jstate = jtr.init_state(params, 5)
    h = jax.random.normal(jax.random.PRNGKey(3), (2, 16))
    loop = {"vec_state": jstate.vec_state, "obs": jstate.obs,
            "next_done": jnp.asarray([0.0, 1.0]), "key": jstate.key}
    path = jsave(str(tmp_path / "jax"), jstate.params, jstate.opt_state, 1, 32, {"seed": 5},
                 extra_models={"loop": loop, "lstm_carry": (h, jnp.tanh(h))})
    monkeypatch.chdir(tmp_path)
    seen = []
    run_iterations = TTrainer.run_iterations

    def spy(self, state, start, k):
        seen.append(dataclasses.replace(state))
        return run_iterations(self, state, start, k)

    monkeypatch.setattr(TTrainer, "run_iterations", spy)
    args = flags.parse(tcli.Args, [
        "--no-cuda", "--env-id", env_id, "--recurrent", "--lstm-hidden", "16", "--num-envs", "2",
        "--num-steps", "16", "--num-minibatches", "2", "--update-epochs", "1",
        "--total-timesteps", "64", "--no-capture-video", "--no-save-model",
        "--resume-checkpoint", path])
    out = tcli.train(args, run_name="from_jax")
    assert out["global_step"] == 64 and out["recurrent"]
    state = seen[0]
    target = np.asarray(jstate.vec_state.env.target)
    assert target[:, 0].all()  # Memory's success cells
    np.testing.assert_array_equal(state.vec_state.env.target.numpy(), target)
    np.testing.assert_array_equal(state.lstm_state[0].numpy(), np.asarray(h))
    np.testing.assert_array_equal(state.lstm_state[1].numpy(), np.asarray(jnp.tanh(h)))
    np.testing.assert_array_equal(state.params["lstm"]["w_hh"].numpy(),
                                  np.asarray(params["lstm"]["w_hh"]))
