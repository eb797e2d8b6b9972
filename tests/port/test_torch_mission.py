"""``--mission-conditioning``, the FiLM agent, against the JAX package's.

``featurize`` and ``mission_film`` match the JAX package's at 1e-6 on
carried params (the FiLM head drawn away from its zero init) and missions
that hold the −1 wildcards and packed positions; ``mission_fn`` of a
carried ``VecState`` of BabyAI's composite levels equals the JAX package's
exactly; at init the conditioned features are the plain trunk's. One
mission-conditioned Trainer iteration, feed-forward on MiniGrid-Fetch-5x5-N2
and recurrent on BabyAI-OpenDoorsOrderN2, matches the JAX Trainer's from
converted params, Adam state and env state: the Gumbel batch and the
permutations are recomputed from the JAX key splits, and the fresh states
the JAX autoreset selects are rebuilt from its env keys and handed to the
port as its reset bank, so episodes that end inside the rollout restart
alike. The recurrent replay reproduces the rollout's log-probs. Checkpoints
keep ``params["mission"]`` both ways, a JAX checkpoint of a composite level
resumes in the port with its instructions, and ``clip_ppo_minigrid
--mission-conditioning`` runs the text modality on a tiny tower.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.envs import JaxVectorEnv
from clip_ppo_tpu.envs.minigrid import core as jmg
from clip_ppo_tpu.envs.vector import VecState as JVecState
from clip_ppo_tpu.io.checkpoint import load_checkpoint as jload
from clip_ppo_tpu.io.checkpoint import save_checkpoint as jsave
from clip_ppo_tpu.models import agent as jagent
from clip_ppo_tpu.models import mission as jmission
from clip_ppo_tpu.models import recurrent as jrec
from clip_ppo_tpu.train import PPOConfig as JPPOConfig
from clip_ppo_tpu.train import Trainer as JTrainer
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as tclip
from clip_ppo_tpu_torch.cli import ppo_minigrid as tcli
from clip_ppo_tpu_torch.envs.minigrid import core as tmg
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
from clip_ppo_tpu_torch.models import agent as tagent
from clip_ppo_tpu_torch.models import clip_utils as tcu
from clip_ppo_tpu_torch.models import mission as tmission
from clip_ppo_tpu_torch.models import recurrent as trec
from clip_ppo_tpu_torch.train.ppo import PPOConfig as TPPOConfig
from clip_ppo_tpu_torch.train.runner import Draws, Trainer as TTrainer, TrainState
from clip_ppo_tpu_torch.utils import flags
from clip_ppo_tpu_torch.utils.tree import tree_map
from test_torch_slice import _tiny_clip

CFG = dict(num_envs=2, num_steps=16, num_minibatches=2, update_epochs=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _film_away_from_zero(params, key):
    """``params`` with the FiLM head drawn at random, so γ and β are not 0."""
    k1, k2 = jax.random.split(key)
    film = params["mission"]["film"]
    mission = dict(params["mission"], film={
        "w": 0.05 * jax.random.normal(k1, film["w"].shape),
        "b": 0.05 * jax.random.normal(k2, film["b"].shape)})
    return dict(params, mission=mission)


def _missions(n, seed=0):
    """[n, 64] int32 missions: enum values with the −1 wildcards, and packed
    positions up to 22·22 + 1 in the slots that hold them."""
    rng = np.random.RandomState(seed)
    m = rng.randint(-1, 16, size=(n, 64))
    instr = m[:, 8:56].reshape(n, 4, 12)
    instr[:, :, 6:12] = rng.randint(0, 22 * 22 + 2, size=(n, 4, 6))
    return m.astype(np.int32)


def test_featurize_and_film_match_jax():
    m = _missions(16)
    np.testing.assert_array_equal(tmission.featurize(_t(m)).numpy(),
                                  np.asarray(jmission.featurize(jnp.asarray(m))))
    jp = _film_away_from_zero({"mission": jmission.init_mission_params(
        jax.random.PRNGKey(0), hidden=512)}, jax.random.PRNGKey(1))["mission"]
    tp = tree_map(_t, _np(jp))
    (g, b), (jg, jb) = tmission.mission_film(tp, _t(m)), jmission.mission_film(jp, jnp.asarray(m))
    assert float(jnp.abs(jg).max()) > 0.01
    with jax.default_matmul_precision("highest"):
        jg, jb = jmission.mission_film(jp, jnp.asarray(m))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    assert tp["fc"]["w"].shape == (64 * 18, 128) and tp["film"]["w"].shape == (128, 1024)


def _jax_env_states(st):
    n = st.grid.shape[0]
    return jmg.EnvState(
        grid=jnp.asarray(st.grid.numpy()), agent_pos=jnp.asarray(st.agent_pos.numpy(), jnp.int32),
        agent_dir=jnp.asarray(st.agent_dir.numpy(), jnp.int32),
        carrying=jnp.asarray(st.carrying.numpy()),
        step_count=jnp.asarray(st.step_count.numpy(), jnp.int32),
        rng=jax.random.split(jax.random.PRNGKey(0), n), target=jnp.asarray(st.target.numpy()),
        instr=jnp.asarray(st.instr.numpy()), instr_state=jnp.asarray(st.instr_state.numpy()))


def _port_resets(env_id, n, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return tmg.reset(tmg.parse_env_id(env_id), n, gen, "cpu")


@pytest.mark.parametrize("env_id", ["BabyAI-MiniBossLevel-v0", "BabyAI-PickupLoc-v0",
                                    "MiniGrid-Fetch-5x5-N2-v0"])
def test_mission_fn_equals_jax(env_id):
    st = _port_resets(env_id, 6)
    st.instr_state[:, :, 0] = torch.tensor([1, 0, 1, 0], dtype=torch.int32)  # latches and
    st.instr_state[:, 1, 1] = 17                                              # a carry
    jvs = JVecState(env=_jax_env_states(st), episode_return=jnp.zeros(6),
                    episode_length=jnp.zeros(6, jnp.int32))
    tenv, jenv = TorchVectorEnv(env_id, 6, "cpu"), JaxVectorEnv(env_id, 6)
    assert tenv.mission_dim == jenv.mission_dim == 64
    got = tenv.mission_fn(convert.vec_state(_np(jvs)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jenv.mission_fn(jvs)))


def test_film_is_identity_at_init():
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tagent.init_agent_params(gen, 7, "cpu", mission_dim=64)
    assert not params["mission"]["film"]["w"].any() and not params["mission"]["film"]["b"].any()
    env = TorchVectorEnv("BabyAI-SynthSeq-v0", 4, "cpu")
    state, _ = env.reset_fn(gen)
    view = env.observe_view_fn(state)
    base = tagent.make_view_features(env.view_upscale)
    film = tmission.MissionFeatures(base)
    torch.testing.assert_close(film(params, (view, env.mission_fn(state))), base(params, view),
                               rtol=0, atol=0)
    fixed = film.fixed(params)  # the rollout's copy, the view trunk's pre-sum once
    torch.testing.assert_close(fixed(params, (view, env.mission_fn(state))),
                               base(params, view), rtol=1e-6, atol=1e-6)


def jax_reset_bank(jenv, rng0, done_mask):
    """The fresh states the JAX autoreset offers at each rollout step: env i
    at step t gets reset(split(rng_i)[0]), its key the one it holds then (a
    reset hands it the fresh state's key). Returns the port's [T·N] bank."""
    reset = jax.jit(jax.vmap(jmg.reset, in_axes=(None, 0)), static_argnums=0)
    rng, bank = rng0, []
    for t in range(done_mask.shape[0]):
        fresh = reset(jenv.params, jax.vmap(lambda k: jax.random.split(k)[0])(rng))
        bank.append(fresh)
        rng = jnp.where(jnp.asarray(done_mask[t])[:, None], fresh.rng, rng)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *bank)
    return convert.env_state(_np(stacked))


def _with_bank(monkeypatch, tenv, bank):
    monkeypatch.setattr(tenv, "prepare_resets", lambda vs, k, gen: dataclasses.replace(
        vs, reset_bank=bank, reset_step=0))


def _jax_draws(key, cfg, num_actions, perm_size):
    key, k_gumbel = jax.random.split(key)
    gumbels = jax.random.gumbel(k_gumbel, (cfg.num_steps, cfg.num_envs, num_actions))
    _, k_update = jax.random.split(key)
    perms = np.stack([np.asarray(jax.random.permutation(k, perm_size))
                      for k in jax.random.split(k_update, cfg.update_epochs)])
    return Draws(_t(gumbels), None, torch.as_tensor(perms))


def _tstate(jstate, lstm=False):
    return TrainState(
        params=convert.agent_params(_np(jstate.params)),
        opt_state=convert.adam_state(_np(jstate.opt_state)),
        vec_state=convert.vec_state(_np(jstate.vec_state)),
        obs=_t(jstate.obs), next_done=_t(jstate.next_done), gen=torch.Generator(),
        lstm_state=tuple(_t(a) for a in jstate.lstm_state) if lstm else None)


def _compare_iteration(jbatch, jdata, jstate2, jscalars, tbatch, tdata, tstate2, tscalars, atol):
    for name in ("actions", "rewards", "dones", "done_mask"):
        np.testing.assert_array_equal(getattr(tbatch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)), err_msg=name)
    (tview, tmis), (jview, jmis) = tbatch.obs, jbatch.obs
    np.testing.assert_array_equal(tview.numpy(), np.asarray(jview))
    np.testing.assert_array_equal(tmis.numpy(), np.asarray(jmis))
    for name in ("logprobs", "values"):
        np.testing.assert_allclose(getattr(tbatch, name).numpy(), np.asarray(getattr(jbatch, name)),
                                   rtol=0, atol=atol, err_msg=name)
    for name in ("advantages", "returns"):
        np.testing.assert_allclose(tdata[name].numpy(), np.asarray(jdata[name]),
                                   rtol=0, atol=atol, err_msg=name)
    for name, value in jscalars.items():
        np.testing.assert_allclose(float(tscalars[name]), float(value), rtol=1e-4,
                                   atol=atol, err_msg=name)
    want = _np(jstate2.params)
    got = convert.jax_agent_params(tstate2.params)
    assert set(got) == set(want) and "mission" in got
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        diff = np.abs(g - w)
        assert diff.max() <= 1e-4 and diff.mean() <= 1e-6


@pytest.mark.parametrize("recurrent", [False, True], ids=["feed-forward", "recurrent"])
def test_mission_iteration_matches_jax(recurrent, monkeypatch):
    env_id = "BabyAI-OpenDoorsOrderN2-v0" if recurrent else "MiniGrid-Fetch-5x5-N2-v0"
    jcfg = JPPOConfig(**CFG)
    jenv = JaxVectorEnv(env_id, CFG["num_envs"])
    jtr = JTrainer(jcfg, jenv, 10, recurrent=recurrent, mission_conditioning=True)
    key = jax.random.PRNGKey(1)
    if recurrent:
        params = jrec.init_agent_params_recurrent(key, jenv.num_actions, lstm_hidden=32,
                                                  mission_dim=jenv.mission_dim)
    else:
        params = jagent.init_agent_params(key, jenv.num_actions, mission_dim=jenv.mission_dim)
    jstate = jtr.init_state(_film_away_from_zero(params, jax.random.PRNGKey(9)), 7)
    # env 0 truncates inside the rollout, so a fresh state of the bank is taken
    vs = jstate.vec_state
    steps = jnp.asarray([jenv.params.max_steps - 5, 0], jnp.int32)
    jstate = dataclasses.replace(jstate, vec_state=dataclasses.replace(
        vs, env=dataclasses.replace(vs.env, step_count=steps)))
    if recurrent:
        h0 = jax.random.normal(jax.random.PRNGKey(2), (2, 32)) * 0.5
        jstate = dataclasses.replace(jstate, lstm_state=(h0, jnp.tanh(h0)))

    def one_iteration(state):
        init = state.lstm_state
        state1, batch = jtr._rollout(state, None)
        data = jtr._data2d(state1, batch, None)
        kw = {"initial_lstm_state": init} if recurrent else {}
        state2, scalars = jtr._update(state1, data, jnp.int32(1), None, None, **kw)
        return batch, data, state2, scalars

    with jax.default_matmul_precision("highest"):
        jbatch, jdata, jstate2, jscalars = jax.jit(one_iteration)(jstate)
    cfg = TPPOConfig(**CFG)
    draws = _jax_draws(jstate.key, cfg, jenv.num_actions,
                       cfg.num_envs if recurrent else cfg.batch_size)
    tenv = TorchVectorEnv(env_id, CFG["num_envs"], "cpu")
    _with_bank(monkeypatch, tenv, jax_reset_bank(jenv, jstate.vec_state.env.rng,
                                                 np.asarray(jbatch.done_mask)))
    ttr = TTrainer(cfg, tenv, 10, recurrent=recurrent, mission_conditioning=True)
    assert ttr.view_mode is jtr.view_mode is True
    tstate2, tscalars, _, tbatch, tdata = ttr.iteration(_tstate(jstate, recurrent), 1, draws)
    assert np.asarray(jbatch.done_mask)[:, 0].any()
    assert tbatch.obs[1][..., :8].any()  # a mission in every step's input
    if recurrent:
        assert tbatch.obs[1][..., 8:56].any()  # the composite slots
    _compare_iteration(jbatch, jdata, jstate2, jscalars, tbatch, tdata, tstate2, tscalars, 1e-4)


def test_recurrent_mission_replay_matches_rollout_logprobs():
    """At unchanged parameters the LSTM agent's replay of (view, mission)
    sequences reproduces the rollout's log-probs, across the resets of
    episodes that end inside the rollout."""
    from clip_ppo_tpu_torch.train import ppo as tppo

    cfg = TPPOConfig(num_envs=4, num_steps=48, num_minibatches=2, update_epochs=1)
    env = TorchVectorEnv("BabyAI-OpenDoorsOrderN2-v0", 4, "cpu")
    tr = TTrainer(cfg, env, 4, recurrent=True, mission_conditioning=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = trec.init_agent_params_recurrent(gen, 7, "cpu", lstm_hidden=16, mission_dim=64)
    params["mission"]["film"]["w"] = 0.05 * torch.randn((128, 1024), generator=gen)
    state = tr.init_state(params, 0)
    state.vec_state.env.step_count[:2] = 700  # two truncate inside the rollout
    init = state.lstm_state
    state2, batch = tr._rollout(state, Draws())
    data = tr._data2d(state2, batch)
    assert float(batch.dones.sum()) >= 2
    with torch.no_grad():
        _, aux = tppo.recurrent_loss(state2.params, dict(data, h0=init[0], c0=init[1]), cfg,
                                     tr.features_fn)
    assert abs(float(aux["approx_kl"])) < 1e-9
    assert abs(float(aux["old_approx_kl"])) < 1e-9


def _cli_args(tmp_path, env_id, *extra):
    return flags.parse(tcli.Args, [
        "--no-cuda", "--env-id", env_id, "--num-envs", "2", "--num-steps", "16",
        "--num-minibatches", "2", "--update-epochs", "1", "--total-timesteps", "64",
        "--save-freq", "32", "--no-capture-video", "--mission-conditioning",
        "--model-path", str(tmp_path / "ck"), *extra])


def test_checkpoints_keep_mission_params_both_ways(tmp_path, monkeypatch):
    """A port checkpoint of a mission-conditioned run loads in the JAX
    package with ``params["mission"]`` as written, and the JAX CLI's resume
    templates read its env state's ``instr``, ``instr_state`` and
    ``target`` from ``loop_state``; a JAX checkpoint of a
    composite level resumes in the port with its ``params["mission"]``
    and its env state's ``instr``, ``instr_state`` and ``target``."""
    monkeypatch.chdir(tmp_path)
    out = tcli.train(_cli_args(tmp_path, "BabyAI-GoToSeqS5R2-v0"), run_name="m")
    assert out["global_step"] == 64 and out["mission_conditioning"]
    with open(tmp_path / "ck" / "m_final.ckpt", "rb") as f:
        written = pickle.load(f)
    assert written["agent_state"]["mission"]["fc"]["w"].shape == (64 * 18, 128)
    env = written["torch_loop_state"]["vec_state"]["env"]
    assert env["instr"].shape == (2, 4, 12) and env["instr"][:, 0, 0].all()
    jparams = jagent.init_agent_params(jax.random.PRNGKey(0), 7, mission_dim=64)
    jtr = JTrainer(JPPOConfig(**CFG), JaxVectorEnv("MiniGrid-Empty-5x5-v0", 2), 2)
    jstate = jtr.init_state(jparams, 0)
    templates = {"loop": {"vec_state": jstate.vec_state, "obs": jstate.obs,
                          "next_done": jstate.next_done, "key": jstate.key}}
    loaded, _, it, step, raw = jload(str(tmp_path / "ck" / "m_final.ckpt"), jstate.params,
                                     jstate.opt_state, extra_templates=templates)
    assert (it, step) == (2, 64)
    jenv = raw["extras"]["loop"]["vec_state"].env
    for name in ("instr", "instr_state", "target", "grid", "step_count"):
        np.testing.assert_array_equal(np.asarray(getattr(jenv, name)), env[name], err_msg=name)
    for g, w in zip(jax.tree_util.tree_leaves(_np(loaded["mission"])),
                    jax.tree_util.tree_leaves(written["agent_state"]["mission"])):
        np.testing.assert_array_equal(g, w)

    # the JAX CLI's checkpoint of BabyAI-OpenDoorsOrderN2 mid-episode
    st = _port_resets("BabyAI-OpenDoorsOrderN2-v0", 2, seed=3)
    st.instr_state[:, 2, 0] = 1  # a latch the episode gathered
    st.step_count[:] = 9
    jvs = JVecState(env=_jax_env_states(st), episode_return=jnp.zeros(2),
                    episode_length=jnp.asarray([9, 9], jnp.int32))
    mparams = _film_away_from_zero(jparams, jax.random.PRNGKey(5))
    loop = {"vec_state": jvs, "obs": jnp.zeros((2, 7, 7, 3), jnp.uint8),
            "next_done": jnp.zeros(2), "key": jax.random.PRNGKey(4)}
    path = jsave(str(tmp_path / "jax"), mparams, jstate.opt_state, 1, 32, {"seed": 5},
                 extra_models={"loop": loop})
    seen = []
    run_iterations = TTrainer.run_iterations

    def spy(self, state, start, k):
        seen.append(dataclasses.replace(state))
        return run_iterations(self, state, start, k)

    monkeypatch.setattr(TTrainer, "run_iterations", spy)
    out = tcli.train(_cli_args(tmp_path, "BabyAI-OpenDoorsOrderN2-v0", "--resume-checkpoint",
                               path, "--no-save-model"), run_name="from_jax")
    assert out["global_step"] == 64
    state = seen[0]
    for name in ("instr", "instr_state", "target", "grid", "step_count"):
        np.testing.assert_array_equal(getattr(state.vec_state.env, name).numpy(),
                                      getattr(st, name).numpy(), err_msg=name)
    assert state.vec_state.env.instr[:, 0, 0].all()
    for g, w in zip(jax.tree_util.tree_leaves(convert.jax_agent_params(state.params)["mission"]),
                    jax.tree_util.tree_leaves(_np(mparams["mission"]))):
        np.testing.assert_array_equal(g, w)


def test_clip_cli_mission_conditioning_text_modality(tmp_path, monkeypatch):
    """``clip_ppo_minigrid --mission-conditioning`` in the text modality on a
    tiny tower: the description table, the FiLM trunk and its params in the
    checkpoint; the image modality is refused before any work."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcu, "load_clip_model", _tiny_clip)
    base = ["--no-cuda", "--env-id", "BabyAI-PickupLoc-v0", "--num-envs", "2", "--num-steps",
            "16", "--total-timesteps", "64", "--clip-config.clip-lambda", "1e-5",
            "--no-capture-video", "--mission-conditioning", "--save-freq", "64",
            "--model-path", str(tmp_path / "ck")]
    out = tclip.train(flags.parse(tclip.Args, base), run_name="text")
    assert out["global_step"] == 64 and not out["split_path"] and out["table_seconds"] > 0
    assert float(out["last_scalars"]["first_clip_loss"]) > 0
    with open(tmp_path / "ck" / "text_final.ckpt", "rb") as f:
        assert "mission" in pickle.load(f)["agent_state"]
    with pytest.raises(SystemExit, match="text modality"):
        tclip.train(flags.parse(tclip.Args, base + ["--clip-config.clip-modality", "image"]),
                    run_name="image")
    assert not (tmp_path / "runs" / "image").exists()


def test_learning_checks_take_the_mission_and_recurrent_options(monkeypatch, capsys):
    """``tools/learning_checks.py``'s ``env_id=steps,mission,recurrent``
    specs reach ``ppo_minigrid.train`` as its flags, and each line names its
    options (the JAX tool's ``benchmarks/learning_checks.py`` spec form)."""
    import json
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tools"))
    import learning_checks

    seen = []

    def fake_train(args, run_name):
        seen.append(args)
        return {"global_step": args.total_timesteps, "sps": 1.0, "episodes": 2,
                "recent_returns": [0.5, 1.0], "episode_returns": [0.5, 1.0]}

    monkeypatch.setattr(tcli, "train", fake_train)
    lines = learning_checks.main(["MiniGrid-GoToDoor-5x5-v0=2048,mission",
                                  "BabyAI-OpenTwoDoors-v0=1024,mission,recurrent",
                                  "MiniGrid-Empty-5x5-v0=512", "--no-cuda", "--seeds", "1"])
    assert [(a.env_id, a.total_timesteps, a.mission_conditioning, a.recurrent) for a in seen] == [
        ("MiniGrid-GoToDoor-5x5-v0", 2048, True, False),
        ("BabyAI-OpenTwoDoors-v0", 1024, True, True), ("MiniGrid-Empty-5x5-v0", 512, False, False)]
    assert [(line.get("mission"), line.get("recurrent")) for line in lines] == [
        (True, None), (True, True), (None, None)]
    assert json.loads(capsys.readouterr().out.splitlines()[0])["mission"] is True
    with pytest.raises(SystemExit):
        learning_checks.main(["MiniGrid-Empty-5x5-v0=512,eb=0.01", "--no-cuda"])
