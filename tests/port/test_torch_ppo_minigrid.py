"""Vanilla PPO on MiniGrid: the port's ``Trainer`` iteration against the
JAX package's, and the port's CLI (``cli/ppo_minigrid.py``) on the CPU —
its refusals, its checkpoints, bit-identical resume, and resuming a JAX
vanilla checkpoint.

Trainer parity (MiniGrid-Empty-5x5, 2 envs × 16 steps, 2 epochs × 2
minibatches): both packages start from the same params, Adam state and env
state (carried across with ``convert``), and the port is handed every draw
the JAX iteration makes, recomputed with its key splits (the Gumbel batch,
`train/rollout.py:96-99`; each step's per-image disturbance, :104 and
`ops/disturbances.py:222`; the update's permutations, `train/runner.py:500`
and `train/ppo.py:298`). Actions, rewards and dones must be equal.
Without disturbances (the view fast path in both packages) the stored views
are equal; with them a disturbed pixel may round one level apart (the
per-image tolerance of ``test_torch_disturb_per_image``). Values,
log-probs, advantages, returns and the logged scalars agree to 1e-4, and
the weights after the 4 Adam steps to 1e-4 elementwise with a mean
difference under 1e-6 (the bound ``test_torch_slice`` explains).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.envs import JaxVectorEnv
from clip_ppo_tpu.io.checkpoint import load_checkpoint as jload
from clip_ppo_tpu.io.checkpoint import save_checkpoint as jsave
from clip_ppo_tpu.models import agent as jagent
from clip_ppo_tpu.ops.severity import DisturbanceSeverity, SEVERITY_CONFIGS
from clip_ppo_tpu.train import PPOConfig as JPPOConfig
from clip_ppo_tpu.train import Trainer as JTrainer
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.cli import ppo_minigrid as tcli
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
from clip_ppo_tpu_torch.ops.severity import SEVERITY_CONFIGS as TSEVERITY
from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity as TSev
from clip_ppo_tpu_torch.train.ppo import PPOConfig as TPPOConfig
from clip_ppo_tpu_torch.train.runner import Draws, Trainer as TTrainer, TrainState
from clip_ppo_tpu_torch.utils import flags
from test_torch_disturb_per_image import assert_levels_close, jax_per_image_draws

ROOT = Path(__file__).resolve().parent.parent.parent
ENV_ID = "MiniGrid-Empty-5x5-v0"
CFG = dict(num_envs=2, num_steps=16, num_minibatches=2, update_epochs=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_draws(key, cfg, num_actions, obs_shape, disturbance):
    """Replay the JAX iteration's key chain."""
    key, k_gumbel = jax.random.split(key)
    gumbels = jax.random.gumbel(k_gumbel, (cfg.num_steps, cfg.num_envs, num_actions))
    disturb = None
    if disturbance is not None:
        disturb = []
        for _ in range(cfg.num_steps):
            key, k_dist = jax.random.split(key)
            disturb.append(jax_per_image_draws(k_dist, obs_shape, disturbance))
    _, k_update = jax.random.split(key)
    perms = np.stack([np.asarray(jax.random.permutation(k, cfg.batch_size))
                      for k in jax.random.split(k_update, cfg.update_epochs)])
    return Draws(torch.as_tensor(np.array(gumbels)), disturb, torch.as_tensor(perms))


@pytest.mark.parametrize("severity", [None, "MILD"], ids=["view-mode", "per-image-MILD"])
def test_vanilla_iteration_matches_jax(severity):
    jcfg = JPPOConfig(**CFG)
    jdist = None if severity is None else SEVERITY_CONFIGS[DisturbanceSeverity[severity]]
    jenv = JaxVectorEnv(ENV_ID, CFG["num_envs"])
    jtr = JTrainer(jcfg, jenv, 10, disturbance=jdist, disturbance_semantics="per_image")
    jstate = jtr.init_state(jagent.init_agent_params(jax.random.PRNGKey(1), jenv.num_actions), 7)

    def one_iteration(state):
        state1, batch = jtr._rollout(state, None)
        data = jtr._data2d(state1, batch, None)
        state2, scalars = jtr._update(state1, data, jnp.int32(1), None, None)
        return batch, data, state2, scalars

    with jax.default_matmul_precision("highest"):
        jbatch, jdata, jstate2, jscalars = jax.jit(one_iteration)(jstate)
    draws = _jax_draws(jstate.key, jcfg, jenv.num_actions, jstate.obs.shape, jdist)

    tenv = TorchVectorEnv(ENV_ID, CFG["num_envs"], "cpu")
    ttr = TTrainer(TPPOConfig(**CFG), tenv, 10,
                   disturbance=None if severity is None else TSEVERITY[TSev[severity]],
                   disturbance_semantics="per_image")
    assert ttr.view_mode is jtr.view_mode is (severity is None)
    tstate = TrainState(
        params=convert.agent_params(_np(jstate.params)),
        opt_state=convert.adam_state(_np(jstate.opt_state)),
        vec_state=convert.vec_state(_np(jstate.vec_state)),
        obs=torch.as_tensor(np.array(jstate.obs)),
        next_done=torch.as_tensor(np.array(jstate.next_done)),
        gen=torch.Generator(),
    )
    tstate2, tscalars, _, tbatch, tdata = ttr.iteration(tstate, 1, draws)

    for name in ("actions", "rewards", "dones", "done_mask"):
        np.testing.assert_array_equal(getattr(tbatch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)), err_msg=name)
    if severity is None:
        assert tbatch.obs.shape == (16, 2, 7, 7, 3)
        np.testing.assert_array_equal(tbatch.obs.numpy(), np.asarray(jbatch.obs))
    else:
        assert_levels_close(tbatch.obs.numpy() / 255.0, np.asarray(jbatch.obs) / 255.0)
    for name in ("logprobs", "values"):
        np.testing.assert_allclose(getattr(tbatch, name).numpy(), np.asarray(getattr(jbatch, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for name in ("advantages", "returns"):
        np.testing.assert_allclose(tdata[name].numpy(), np.asarray(jdata[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for name, value in jscalars.items():
        np.testing.assert_allclose(float(tscalars[name]), float(value), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    want = convert.agent_params(_np(jstate2.params))
    pairs = [(tstate2.params[k]["w"], want[k]["w"]) for k in ("actor", "critic")]
    pairs += [(tstate2.params["trunk"][k]["w"], want["trunk"][k]["w"])
              for k in ("conv1", "conv2", "conv3", "fc")]
    for got, ref in pairs:
        diff = (got - ref).abs()
        assert float(diff.max()) <= 1e-4 and float(diff.mean()) <= 1e-6


# -- the CLI ------------------------------------------------------------------


def _args(tmp_path, *extra):
    return flags.parse(tcli.Args, [
        "--no-cuda", "--env-id", ENV_ID, "--num-envs", "2", "--num-steps", "16",
        "--num-minibatches", "2", "--update-epochs", "2", "--total-timesteps", "64",
        "--save-freq", "32", "--no-capture-video", "--seed", "3",
        "--model-path", str(tmp_path / "checkpoints"), *extra,
    ])


@pytest.mark.parametrize("argv,match", [
    (["--recurrent", "--num-envs", "3"], "--recurrent.*not divisible"),
    (["--mission-conditioning", "--exploration-bonus", "0.01"],
     "--exploration-bonus.*extensions slice"),
    (["--exploration-bonus", "0.01"], "--exploration-bonus.*extensions slice"),
    (["--episodic-bonus", "0.01"], "--episodic-bonus.*extensions slice"),
    (["--num-devices", "2"], "--num-devices.*multi-GPU slice"),
    (["--distributed"], "--distributed.*multi-GPU slice"),
])
def test_cli_refuses_later_slices_before_any_work(tmp_path, monkeypatch, argv, match):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=match):
        tcli.train(_args(tmp_path, *argv), run_name="x")
    assert not (tmp_path / "runs").exists() and not (tmp_path / "checkpoints").exists()


def test_cli_cuda_flag_needs_a_gpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the error without one")
    monkeypatch.chdir(tmp_path)
    args = flags.parse(tcli.Args, ["--total-timesteps", "64", "--no-capture-video"])
    with pytest.raises(RuntimeError, match="--no-cuda"):
        tcli.train(args, run_name="x")
    assert not (tmp_path / "runs").exists()


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_payloads_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_payloads_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_payloads_equal(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("extra", [[], ["--apply-disturbances", "--disturbance-severity", "HARD"]],
                         ids=["view-mode", "per-image-HARD"])
def test_cli_resume_is_bit_identical(tmp_path, monkeypatch, extra):
    """Two iterations uninterrupted, then the same run resumed from its
    checkpoint after the first: the final checkpoints agree bit for bit,
    params, optimizer, loop state and generator included. The JAX package's
    loader reads the same checkpoint, its env state from ``loop_state``."""
    monkeypatch.chdir(tmp_path)
    full = tcli.train(_args(tmp_path, *extra), run_name="full")
    assert full["global_step"] == 64 and full["view_mode"] is (not extra)
    assert all(np.isfinite(float(v)) for k, v in full["last_scalars"].items()
               if k != "explained_variance")
    ckpts = tmp_path / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["full_final.ckpt", "full_latest.ckpt",
                                         "full_step_32.ckpt", "full_step_64.ckpt"]
    half = tcli.train(_args(tmp_path, "--resume-checkpoint", str(ckpts / "full_step_32.ckpt"),
                            *extra), run_name="half")
    assert half["global_step"] == 64
    a, b = _load(ckpts / "full_final.ckpt"), _load(ckpts / "half_final.ckpt")
    assert set(a) == {"iteration", "global_step", "agent_state", "optimizer_state", "args",
                      "returns", "training_complete", "torch_loop_state", "loop_state"}
    assert a["torch_loop_state"]["obs"].shape == ((2, 7, 7, 3) if not extra else (2, 84, 84, 3))
    for key in ("iteration", "global_step", "agent_state", "optimizer_state", "returns",
                "torch_loop_state"):
        _assert_payloads_equal(a[key], b[key], key)
    for x, y in ((a, a), (a, b)):  # loop_state holds torch_loop_state's env state
        want = convert.vec_state(x["loop_state"]["vec_state"])
        for name, v in y["torch_loop_state"]["vec_state"]["env"].items():
            np.testing.assert_array_equal(getattr(want.env, name).numpy(), v, err_msg=name)
    np.testing.assert_array_equal(a["loop_state"]["obs"], a["torch_loop_state"]["obs"])
    mid = _load(ckpts / "full_step_32.ckpt")["torch_loop_state"]
    assert not np.array_equal(mid["gen"], a["torch_loop_state"]["gen"])

    # The JAX vanilla CLI's resume templates (its `state_extras`) read the
    # port's env state, in the JAX package's dtypes.
    jenv = JaxVectorEnv(ENV_ID, 2)
    jtr = JTrainer(JPPOConfig(**CFG), jenv, 2)
    jstate = jtr.init_state(jagent.init_agent_params(jax.random.PRNGKey(0), 7), 0)
    loop = {"vec_state": jstate.vec_state, "obs": jstate.obs, "next_done": jstate.next_done,
            "key": jstate.key}
    jparams, _, it, step, raw = jload(str(ckpts / "full_final.ckpt"), jstate.params,
                                      jstate.opt_state, extra_templates={"loop": loop})
    assert (it, step) == (2, 64)
    np.testing.assert_array_equal(np.asarray(jparams["trunk"]["fc"]["w"]),
                                  a["agent_state"]["trunk"]["fc"]["w"])
    got = raw["extras"]["loop"]
    for f in dataclasses.fields(got["vec_state"].env):
        x, t = getattr(got["vec_state"].env, f.name), getattr(jstate.vec_state.env, f.name)
        assert (x.dtype, x.shape[1:]) == (t.dtype, t.shape[1:]), f.name
    for name, v in a["torch_loop_state"]["vec_state"]["env"].items():
        np.testing.assert_array_equal(np.asarray(getattr(got["vec_state"].env, name)), v,
                                      err_msg=name)
    if not extra:
        assert (got["obs"].dtype, got["obs"].shape) == (jstate.obs.dtype, jstate.obs.shape)
    np.testing.assert_array_equal(np.asarray(got["obs"]), a["torch_loop_state"]["obs"])


def test_jax_cli_resumes_a_port_checkpoint(tmp_path, monkeypatch):
    """The JAX vanilla CLI resumes the port's checkpoint of iteration 1
    mid-episode: params, global step, and the env state, observations and
    ``next_done`` of its ``loop_state``; it then runs iteration 2."""
    from clip_ppo_tpu.cli import ppo_minigrid as jcli

    monkeypatch.chdir(tmp_path)
    tcli.train(_args(tmp_path), run_name="port")
    path = tmp_path / "checkpoints" / "port_step_32.ckpt"
    written = _load(path)
    assert written["torch_loop_state"]["vec_state"]["env"]["step_count"].any()
    seen = []
    run_iterations = JTrainer.run_iterations

    def spy(self, state, start, k):  # a copy: the iteration donates the state's buffers
        seen.append((start, jax.tree_util.tree_map(np.array, state)))
        return run_iterations(self, state, start, k)

    monkeypatch.setattr(JTrainer, "run_iterations", spy)
    out = jcli.train(jcli.Args(env_id=ENV_ID, seed=3, num_envs=2, num_steps=16,
                               num_minibatches=2, update_epochs=2, total_timesteps=64,
                               capture_video=False, save_model=False,
                               resume_checkpoint=str(path)), run_name="jax_from_port")
    assert out["global_step"] == 64
    (start, state), = seen
    assert start == 2
    loop = written["torch_loop_state"]
    for name, v in loop["vec_state"]["env"].items():
        np.testing.assert_array_equal(np.asarray(getattr(state.vec_state.env, name)), v,
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(state.obs), loop["obs"])
    np.testing.assert_array_equal(np.asarray(state.next_done), loop["next_done"])
    np.testing.assert_array_equal(np.asarray(state.params["trunk"]["fc"]["w"]),
                                  written["agent_state"]["trunk"]["fc"]["w"])


def _jax_vanilla_checkpoint(tmp_path) -> tuple[str, dict]:
    """A checkpoint as the JAX vanilla CLI writes it after iteration 1 of
    2 envs × 16 steps (`clip_ppo_tpu/cli/ppo_minigrid.py:233-247, 310`):
    its params, optimizer and ``loop_state``, the env stepped away from
    its reset so that the state is not a fresh one."""
    jenv = JaxVectorEnv(ENV_ID, 2)
    jtr = JTrainer(JPPOConfig(**CFG), jenv, 2)
    jstate = jtr.init_state(jagent.init_agent_params(jax.random.PRNGKey(2), 7), 5)
    vec_state = jstate.vec_state
    for action in (2, 2, 1, 2, 0):  # forward, forward, right, forward, left
        vec_state, obs, *_ = jenv._jit_step(vec_state, jnp.full((2,), action), small_obs=True)
    loop = {"vec_state": vec_state, "obs": obs, "next_done": jnp.asarray([0.0, 1.0]),
            "key": jstate.key}
    path = jsave(str(tmp_path / "jax"), jstate.params, jstate.opt_state, 1, 32,
                 {"seed": 5}, extra_models={"loop": loop})
    assert path.endswith("jax_step_32.ckpt")
    return path, _np(loop)


def test_port_reads_a_jax_vanilla_checkpoint_without_jax(tmp_path):
    """The port's loader reads the JAX package's ``VecState``/``EnvState``
    in ``loop_state`` as stand-ins, in a process where neither jax, optax
    nor the JAX package can be imported."""
    path, loop = _jax_vanilla_checkpoint(tmp_path)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'optax', 'clip_ppo_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from clip_ppo_tpu_torch import convert\n"
        "from clip_ppo_tpu_torch.io.checkpoint import load_checkpoint\n"
        "from clip_ppo_tpu_torch.models.agent import init_agent_params\n"
        "from clip_ppo_tpu_torch.train.ppo import init_adam_state\n"
        "t = init_agent_params(torch.Generator(), 7, 'cpu')\n"
        f"_, _, it, step, raw = load_checkpoint({path!r}, t, init_adam_state(t), 'cpu')\n"
        "vs = convert.vec_state(raw['loop_state']['vec_state'])\n"
        "print(it, step, type(raw['loop_state']['vec_state']).__name__,\n"
        "      ','.join(str(v) for v in vs.env.agent_pos.flatten().tolist()),\n"
        "      ','.join(str(v) for v in vs.env.step_count.tolist()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    it, step, cls, pos, steps = out.stdout.splitlines()[-1].split()
    assert (it, step, cls) == ("1", "32", "JaxVecState")
    env = loop["vec_state"].env
    assert pos == ",".join(str(v) for v in env.agent_pos.flatten().tolist())
    assert steps == ",".join(str(v) for v in env.step_count.tolist()) != "0,0"


def test_unpickler_refuses_other_jax_package_classes(tmp_path):
    from clip_ppo_tpu.ops.severity import DisturbanceParams
    from clip_ppo_tpu_torch.io.checkpoint import _Unpickler

    path = tmp_path / "other.pkl"
    with open(path, "wb") as f:
        pickle.dump({"x": SEVERITY_CONFIGS[DisturbanceSeverity.MILD]}, f)
    assert DisturbanceParams.__module__ == "clip_ppo_tpu.ops.severity"
    with open(path, "rb") as f, pytest.raises(pickle.UnpicklingError,
                                              match="ops.severity.DisturbanceParams"):
        _Unpickler(f).load()


def test_cli_resumes_a_jax_vanilla_checkpoint(tmp_path, monkeypatch, capsys):
    """Params, optimizer, iteration and global step from the JAX checkpoint,
    and the env state of its ``loop_state`` with the views observed anew;
    the generator is seeded from --seed, and the run says so."""
    path, loop = _jax_vanilla_checkpoint(tmp_path)
    monkeypatch.chdir(tmp_path)
    seen = []
    run_iterations = TTrainer.run_iterations

    def spy(self, state, start, k):
        seen.append((start, dataclasses.replace(state)))
        return run_iterations(self, state, start, k)

    monkeypatch.setattr(TTrainer, "run_iterations", spy)
    out = tcli.train(_args(tmp_path, "--resume-checkpoint", path, "--no-save-model"),
                     run_name="from_jax")
    assert out["global_step"] == 64 and out["view_mode"]
    assert "seeded from --seed 3" in capsys.readouterr().out
    (start, state), = seen
    assert start == 2
    want = convert.vec_state(loop["vec_state"])
    for f in dataclasses.fields(want.env):
        torch.testing.assert_close(getattr(state.vec_state.env, f.name), getattr(want.env, f.name),
                                   rtol=0, atol=0, msg=f.name)
    np.testing.assert_array_equal(state.obs.numpy(), loop["obs"])
    np.testing.assert_array_equal(state.next_done.numpy(), loop["next_done"])
