"""The slice as a whole: one CLIP-PPO Trainer iteration against the JAX
package, and the port's CLI end to end on the CPU.

Trainer parity (MiniGrid-Empty-5x5, 2 envs × 16 steps, HARD disturbances,
the CLIP text term on a 2-layer tower): both packages start from the same
params, Adam state and env state (carried across with ``convert``), and
the port is handed every random draw the JAX iteration makes — its Gumbel
batch, each step's disturbance noise, contrast factor and cutout origin,
and the update's permutations — recomputed with the same ``jax.random``
splits as ``train/rollout.py``, ``ops/disturbances.py`` and
``train/ppo.py``. Actions, rewards and dones must be equal. The disturbed
observations are quantized to uint8 after a blur whose float sums may
round differently in the two packages, so a pixel may land one level
apart (bounded here; none did when this was written). Per-step values,
log-probs, advantages and losses agree to 1e-4. Parameters after the 16
Adam steps (lr 2.5e-4 each): every element within 1e-4 — under half of
one step — and the mean difference of each weight under 1e-6. Adam
normalizes each element's gradient by its running RMS (eps 1e-5), so
where a gradient is tiny — conv1's and conv2's on these piecewise-constant
grid images sum many cancelling terms, and a ReLU pre-activation within
round-off of zero switches a unit's gradient on or off — float32
round-off of the gradient becomes a visible fraction of a step (measured:
max 2.2e-5, means at most 6.5e-7; actor, critic and fc agree to 1e-6).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.envs import JaxVectorEnv
from clip_ppo_tpu.models import agent as jagent
from clip_ppo_tpu.models import clip_utils as jcu
from clip_ppo_tpu.models.clip import CLIPConfig
from clip_ppo_tpu.models.clip import model as jmodel
from clip_ppo_tpu.ops.disturbances import _cutout_patch_hw
from clip_ppo_tpu.ops.severity import DisturbanceSeverity, SEVERITY_CONFIGS
from clip_ppo_tpu.train import PPOConfig as JPPOConfig
from clip_ppo_tpu.train import Trainer as JTrainer
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as tcli
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
from clip_ppo_tpu_torch.io.checkpoint import load_checkpoint
from clip_ppo_tpu_torch.models import clip_utils as tcu
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from clip_ppo_tpu_torch.models.clip.model import init_clip_params as tinit_clip
from clip_ppo_tpu_torch.ops.disturbances import DisturbanceDraws
from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity as TSev
from clip_ppo_tpu_torch.ops.severity import SEVERITY_CONFIGS as TSEVERITY
from clip_ppo_tpu_torch.train.ppo import PPOConfig as TPPOConfig
from clip_ppo_tpu_torch.train.runner import Draws, Trainer as TTrainer, TrainState
from clip_ppo_tpu_torch.utils import flags

ENV_ID = "MiniGrid-Empty-5x5-v0"
TINY = dict(embed_dim=512, image_size=32, patch_size=16, vision_width=128, vision_layers=1,
            vision_heads=2, text_width=128, text_heads=2, text_layers=2, vocab_size=49408)
SUFFIX = ", objects: wall at (0,0), wall at (0,1), wall at (0,2)"
CFG = dict(num_envs=2, num_steps=16, num_minibatches=4, update_epochs=4, clip_mode="precomputed")
NUM_ITERATIONS, LAMBDA = 10, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_draws(key, cfg, num_actions, obs_shape, params):
    """Replay the JAX iteration's key chain (rollout.py:96-106,
    disturbances.py:222-227, runner.py:500, ppo.py:298)."""
    t_steps, n = cfg.num_steps, cfg.num_envs
    key, k_gumbel = jax.random.split(key)
    gumbels = jax.random.gumbel(k_gumbel, (t_steps, n, num_actions), jnp.float32)
    _, h, w, _ = obs_shape
    ph, pw = _cutout_patch_hw(h, w, params.cutout_ratio)
    lo, hi = params.contrast_range
    disturb = []
    for _ in range(t_steps):
        key, k_dist = jax.random.split(key)
        k_noise, k_contrast, k_cutout = jax.random.split(k_dist, 3)
        kh, kw = jax.random.split(k_cutout)
        disturb.append(DisturbanceDraws(
            torch.as_tensor(np.array(jax.random.normal(k_noise, obs_shape, jnp.float32))),
            torch.tensor(float(jax.random.uniform(k_contrast, (), jnp.float32, lo, hi))),
            torch.tensor([int(jax.random.randint(kh, (), 0, max(1, h - ph + 1))),
                          int(jax.random.randint(kw, (), 0, max(1, w - pw + 1)))],
                         dtype=torch.int32)))
    rollout_key = key
    _, k_update = jax.random.split(key)
    perms = np.stack([np.asarray(jax.random.permutation(k, cfg.batch_size))
                      for k in jax.random.split(k_update, cfg.update_epochs)])
    return Draws(torch.as_tensor(np.array(gumbels)), disturb, torch.as_tensor(perms)), rollout_key


def test_trainer_iteration_matches_jax():
    jcfg, tcfg = JPPOConfig(**CFG), TPPOConfig(**CFG)
    hard = SEVERITY_CONFIGS[DisturbanceSeverity.HARD]

    clip_j = jmodel.init_clip_params(jax.random.PRNGKey(3), CLIPConfig(**TINY))
    jtable = jcu.build_minigrid_text_table(clip_j, CLIPConfig(**TINY), 5, 5, SUFFIX)
    jenv = JaxVectorEnv(ENV_ID, CFG["num_envs"])
    jtr = JTrainer(jcfg, jenv, NUM_ITERATIONS, disturbance=hard,
                   embed_desc_fn=jcu.make_text_table_embed_fn(5), clip_lambda=LAMBDA,
                   frozen_params={"text_table": jtable})
    jstate = jtr.init_state(jagent.init_agent_params(jax.random.PRNGKey(1), jenv.num_actions), 7)

    def one_iteration(state, frozen):
        state1, batch = jtr._rollout(state, frozen)
        data = jtr._data2d(state1, batch, frozen)
        emb = jtr.embed_desc_fn(batch.desc, frozen)
        state2, scalars = jtr._update(state1, data, jnp.int32(1), emb, frozen)
        return state1.key, batch, data, state2, scalars

    with jax.default_matmul_precision("highest"):
        jkey1, jbatch, jdata, jstate2, jscalars = jax.jit(one_iteration)(jstate, jtr.frozen_params)

    draws, rollout_key = _jax_draws(jstate.key, jcfg, jenv.num_actions, jstate.obs.shape, hard)
    assert np.array_equal(np.asarray(rollout_key), np.asarray(jkey1))  # key chain replayed

    ttable = tcu.build_minigrid_text_table(convert.clip_params(_np(clip_j)), TCLIPConfig(**TINY),
                                           5, 5, SUFFIX)
    tenv = TorchVectorEnv(ENV_ID, CFG["num_envs"], "cpu")
    ttr = TTrainer(tcfg, tenv, NUM_ITERATIONS, disturbance=TSEVERITY[TSev.HARD],
                   embed_desc_fn=tcu.make_text_table_embed_fn(5), clip_lambda=LAMBDA,
                   frozen_params={"text_table": ttable})
    tstate = TrainState(
        params=convert.agent_params(_np(jstate.params)),
        opt_state=convert.adam_state(_np(jstate.opt_state)),
        vec_state=convert.vec_state(_np(jstate.vec_state)),
        obs=torch.as_tensor(np.array(jstate.obs)),
        next_done=torch.as_tensor(np.array(jstate.next_done)),
        gen=torch.Generator(),
    )
    tstate2, tscalars, _, tbatch, tdata = ttr.iteration(tstate, 1, draws)

    np.testing.assert_array_equal(tbatch.actions.numpy(), np.asarray(jbatch.actions))
    np.testing.assert_array_equal(tbatch.rewards.numpy(), np.asarray(jbatch.rewards))
    np.testing.assert_array_equal(tbatch.dones.numpy(), np.asarray(jbatch.dones))
    np.testing.assert_array_equal(tbatch.done_mask.numpy(), np.asarray(jbatch.done_mask))
    obs_diff = np.abs(tbatch.obs.numpy().astype(int) - np.asarray(jbatch.obs).astype(int))
    assert obs_diff.max() <= 1 and obs_diff.mean() < 1e-3
    for name in ("logprobs", "values"):
        np.testing.assert_allclose(tbatch._asdict()[name].numpy(), np.asarray(getattr(jbatch, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for name in ("advantages", "returns"):
        np.testing.assert_allclose(tdata[name].numpy(), np.asarray(jdata[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for name, value in jscalars.items():
        np.testing.assert_allclose(float(tscalars[name]), float(value), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert float(tscalars["first_clip_loss"]) > 0.0  # the CLIP term ran
    want = convert.agent_params(_np(jstate2.params))
    pairs = [(tstate2.params[k]["w"], want[k]["w"]) for k in ("actor", "critic")]
    pairs += [(tstate2.params["trunk"][k]["w"], want["trunk"][k]["w"])
              for k in ("conv1", "conv2", "conv3", "fc")]
    for got, ref in pairs:
        diff = (got - ref).abs()
        assert float(diff.max()) <= 1e-4 and float(diff.mean()) <= 1e-6


REFERENCE_SCALAR_TAGS = {
    "losses/value_loss", "losses/policy_loss", "losses/entropy", "losses/old_approx_kl",
    "losses/approx_kl", "losses/clipfrac", "losses/explained_variance", "losses/clip_loss",
    "charts/learning_rate", "charts/SPS",
}


def _tiny_clip(name, device, **_):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return tinit_clip(gen, TCLIPConfig(**TINY), device), TCLIPConfig(**TINY)


def test_cli_runs_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcu, "load_clip_model", _tiny_clip)
    args = flags.parse(tcli.Args, [
        "--no-cuda", "--env-id", ENV_ID, "--num-envs", "2", "--num-steps", "16",
        "--total-timesteps", "64", "--clip-config.clip-lambda", "1e-5",
        "--clip-config.apply-disturbances", "--clip-config.disturbance-severity", "HARD",
        "--no-capture-video", "--save-freq", "32",
    ])
    out = tcli.train(args, run_name="smoke")
    assert out["global_step"] == 64

    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    ea = EventAccumulator(str(tmp_path / "runs" / "smoke"))
    ea.Reload()
    tags = ea.Tags()
    assert REFERENCE_SCALAR_TAGS <= set(tags["scalars"])
    assert [e.step for e in ea.Scalars("losses/value_loss")] == [32, 64]
    sev = ea.Tensors("config/disturbance_severity/text_summary")[0].tensor_proto.string_val
    assert sev == [b"HARD"]
    assert "hyperparameters/text_summary" in tags["tensors"]

    ckpts = sorted(os.listdir(tmp_path / "checkpoints"))
    assert ckpts == ["smoke_final.ckpt", "smoke_latest.ckpt", "smoke_step_32.ckpt",
                     "smoke_step_64.ckpt"]
    with open(tmp_path / "checkpoints" / "smoke_final.ckpt", "rb") as f:
        raw = pickle.load(f)
    assert set(raw) == {"iteration", "global_step", "agent_state", "optimizer_state", "args",
                        "returns", "training_complete"}
    assert raw["training_complete"] and raw["global_step"] == 64 and raw["returns"].shape == (32,)
    template = tcli.init_agent_params(torch.Generator(), 7, "cpu")
    from clip_ppo_tpu_torch.train.ppo import init_adam_state

    params, opt_state, it, step, _ = load_checkpoint(
        str(tmp_path / "checkpoints" / "smoke_final.ckpt"), template, init_adam_state(template), "cpu")
    assert (it, step) == (2, 64)
    # The payload is the JAX package's: conv kernels HWIO, the port's OIHW.
    np.testing.assert_array_equal(params["trunk"]["conv1"]["w"].permute(2, 3, 1, 0).numpy(),
                                  raw["agent_state"]["trunk"]["conv1"]["w"])
    assert int(opt_state["count"]) == 32  # 2 iterations × 4 epochs × 4 minibatches


def test_cli_cuda_flag_needs_a_gpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the error without one")
    monkeypatch.chdir(tmp_path)
    args = flags.parse(tcli.Args, ["--total-timesteps", "64", "--no-capture-video"])
    with pytest.raises(RuntimeError, match="--no-cuda"):
        tcli.train(args, run_name="x")
    assert not (tmp_path / "runs").exists()


@pytest.mark.parametrize("argv,match", [
    (["--num-devices", "2"], "multi-GPU"),
    (["--tp", "2"], "multi-GPU"),
    (["--distributed"], "multi-GPU"),
    (["--mission-conditioning", "--clip-config.clip-lambda", "1e-5",
      "--clip-config.clip-modality", "image"], "image modality"),
])
def test_cli_rejects_later_slices(tmp_path, monkeypatch, argv, match):
    monkeypatch.chdir(tmp_path)
    args = flags.parse(tcli.Args, ["--no-cuda", "--no-capture-video", *argv])
    with pytest.raises(SystemExit, match=match):
        tcli.train(args, run_name="x")


def test_cli_no_text_embed_table_runs_the_split_path(tmp_path, monkeypatch):
    """``--no-text-embed-table`` encodes each iteration's descriptions
    (2 × 16 here) on the split path, one iteration a dispatch, with no
    table built."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcu, "load_clip_model", _tiny_clip)
    encoded = []
    real = tcu.encode_texts
    monkeypatch.setattr(tcu, "encode_texts",
                        lambda *a, **k: encoded.append(list(a[2])) or real(*a, **k))
    args = flags.parse(tcli.Args, ["--no-cuda", "--no-capture-video", "--env-id", ENV_ID,
                                   "--num-envs", "2", "--num-steps", "16", "--total-timesteps",
                                   "64", "--clip-config.clip-lambda", "1e-5",
                                   "--no-text-embed-table", "--no-save-model"])
    out = tcli.train(args, run_name="x")
    assert out["split_path"] and out["table_seconds"] == 0.0 and out["global_step"] == 64
    assert [len(e) for e in encoded] == [32, 32]
    assert all(d.endswith(SUFFIX) and d.startswith("agent at (") for e in encoded for d in e)
    assert float(out["last_scalars"]["first_clip_loss"]) > 0.0


def test_video_capture_records_env0_renders(tmp_path):
    """With capture on, each iteration surfaces env 0's top-down renders
    ([T, H·6, W·6, 3] uint8) and the recorder writes a finished episode."""
    from clip_ppo_tpu_torch.envs.minigrid import core as tmg
    from clip_ppo_tpu_torch.io.video import VideoRecorder

    env = TorchVectorEnv(ENV_ID, 2, "cpu")
    trainer = TTrainer(TPPOConfig(num_envs=2, num_steps=4, num_minibatches=2, update_epochs=1),
                       env, 1, capture_env0=True)
    state = trainer.init_state(tcli.init_agent_params(torch.Generator(), 7, "cpu"), 0)
    first = tmg.render_rgb(env.params, state.vec_state.env.grid[0],
                           state.vec_state.env.agent_pos[0], state.vec_state.env.agent_dir[0])
    _, packed = trainer.run_iterations(state, 1, 1)
    (_, stats), = trainer.fetch_logs_chunk(packed)
    assert stats["env0_frames"].shape == (4, 30, 30, 3) and stats["env0_frames"].dtype == np.uint8
    np.testing.assert_array_equal(stats["env0_frames"][0], first.numpy())
    rec = VideoRecorder(str(tmp_path))
    written = rec.add_rollout(stats["env0_frames"], np.array([False, False, False, True]))
    assert len(written) == 1 and os.path.exists(written[0])
