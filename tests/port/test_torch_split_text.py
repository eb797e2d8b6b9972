"""The text modality's split path against the JAX package.

Where the descriptions' object suffix varies across episodes (MultiRoom,
whose grid has no border) or the CLI is given ``--no-text-embed-table``, each
iteration's 1,024 descriptions are built and tokenized on the host between
the rollout and the update and encoded by the text tower. Held here against
the JAX package: ``describe_rollout`` and ``describe_states`` strings (on
MultiRoom grids, whose suffixes vary) and the token ids; ``encode_texts`` on
a 2-layer tower (1e-5 on unit vectors); one split iteration — rollout half,
host descriptions, encode, update half — on Empty-5x5 with HARD
disturbances, every draw replayed from the JAX key chain as
``test_torch_slice.py`` does, to that test's tolerances. On Empty the split
path's embeddings are the table path's rows. The CLI takes the split path on
MultiRoom and under ``--no-text-embed-table`` on a bordered family, and the
families run through the vanilla CLI, the image modality and the ablations.
"""

import numpy as np
import pytest
import torch

import jax

from clip_ppo_tpu.envs import JaxVectorEnv
from clip_ppo_tpu.envs.minigrid import core as jmg
from clip_ppo_tpu.models import agent as jagent
from clip_ppo_tpu.models import clip_utils as jcu
from clip_ppo_tpu.models.clip import CLIPConfig
from clip_ppo_tpu.models.clip import model as jmodel
from clip_ppo_tpu.models.clip.tokenizer import tokenize as jtokenize
from clip_ppo_tpu.ops.severity import DisturbanceSeverity, SEVERITY_CONFIGS
from clip_ppo_tpu.train import PPOConfig as JPPOConfig
from clip_ppo_tpu.train import Trainer as JTrainer
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as tcli
from clip_ppo_tpu_torch.cli import ppo_minigrid as tvanilla
from clip_ppo_tpu_torch.envs.minigrid import core as tmg
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
from clip_ppo_tpu_torch.models import clip_utils as tcu
from clip_ppo_tpu_torch.models.agent import AblationMode
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from clip_ppo_tpu_torch.models.clip.tokenizer import tokenize as ttokenize
from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity as TSev
from clip_ppo_tpu_torch.ops.severity import SEVERITY_CONFIGS as TSEVERITY
from clip_ppo_tpu_torch.train.ppo import PPOConfig as TPPOConfig
from clip_ppo_tpu_torch.train.runner import Trainer as TTrainer, TrainState
from clip_ppo_tpu_torch.utils import flags
from test_torch_slice import CFG, LAMBDA, NUM_ITERATIONS, SUFFIX, TINY, _jax_draws, _np, _tiny_clip


def _multiroom_rollout(t_steps=3, n=4, seed=0):
    """MultiRoom grids of the port's resets and random agent snapshots."""
    p = tmg.parse_env_id("MiniGrid-MultiRoom-N4-S5-v0")
    gen = torch.Generator()
    gen.manual_seed(seed)
    grids = tmg.reset(p, n, gen, "cpu").grid.numpy()
    rng = np.random.RandomState(seed)
    pos = rng.randint(0, 25, size=(t_steps, n, 2))
    dirs = rng.randint(0, 4, size=(t_steps, n))
    return grids, pos, dirs


def test_descriptions_and_tokens_match_jax():
    grids, pos, dirs = _multiroom_rollout()
    got = tmg.describe_rollout(grids, pos, dirs)
    want = jmg.describe_rollout(grids, pos, dirs)
    assert got == want and len(got) == 12
    assert len({d.split(", objects")[1] for d in got}) > 1  # the suffixes vary by env
    flat = pos.reshape(-1, 2)
    assert tmg.describe_states(np.repeat(grids, 3, 0), flat, dirs.reshape(-1)) == \
        jmg.describe_states(np.repeat(grids, 3, 0), flat, dirs.reshape(-1))
    np.testing.assert_array_equal(np.asarray(ttokenize(got)), np.asarray(jtokenize(want)))


def _towers():
    clip_j = jmodel.init_clip_params(jax.random.PRNGKey(3), CLIPConfig(**TINY))
    return clip_j, convert.clip_params(_np(clip_j))


def test_encode_texts_matches_jax():
    grids, pos, dirs = _multiroom_rollout()
    descriptions = tmg.describe_rollout(grids, pos, dirs)
    clip_j, clip_t = _towers()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jcu.encode_texts(clip_j, CLIPConfig(**TINY), descriptions))
    got = tcu.encode_texts(clip_t, TCLIPConfig(**TINY), descriptions)
    assert got.shape == (12, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    gen_emb = tcu.generate_clip_embeddings(AblationMode.NONE, clip_t, TCLIPConfig(**TINY), "text",
                                           12, descriptions=descriptions)
    torch.testing.assert_close(gen_emb, got, rtol=0, atol=0)
    gen = torch.Generator()
    gen.manual_seed(1)
    rand = tcu.generate_clip_embeddings(AblationMode.RANDOM_ENCODER, None, None, "text", 12, gen)
    torch.testing.assert_close(rand.norm(dim=-1), torch.ones(12))


def test_split_iteration_matches_jax():
    """Rollout half, host descriptions, the text encode and the update half
    in both packages on the same start and draws."""
    jcfg, tcfg = JPPOConfig(**CFG), TPPOConfig(**CFG)
    hard = SEVERITY_CONFIGS[DisturbanceSeverity.HARD]
    clip_j, clip_t = _towers()
    env_id = "MiniGrid-Empty-5x5-v0"
    jenv = JaxVectorEnv(env_id, CFG["num_envs"])
    jtr = JTrainer(jcfg, jenv, NUM_ITERATIONS, disturbance=hard, clip_lambda=LAMBDA)
    jstate = jtr.init_state(jagent.init_agent_params(jax.random.PRNGKey(1), jenv.num_actions), 7)
    draws, _ = _jax_draws(jstate.key, jcfg, jenv.num_actions, jstate.obs.shape, hard)
    ttr = TTrainer(tcfg, TorchVectorEnv(env_id, CFG["num_envs"], "cpu"), NUM_ITERATIONS,
                   disturbance=TSEVERITY[TSev.HARD], clip_lambda=LAMBDA)
    tstate = TrainState(
        params=convert.agent_params(_np(jstate.params)),
        opt_state=convert.adam_state(_np(jstate.opt_state)),
        vec_state=convert.vec_state(_np(jstate.vec_state)),
        obs=torch.as_tensor(np.array(jstate.obs)),
        next_done=torch.as_tensor(np.array(jstate.next_done)), gen=torch.Generator())
    with jax.default_matmul_precision("highest"):  # the JAX halves donate their state
        jstate1, jdata, _, jdesc = jtr.run_rollout_half(jstate)
        jtexts = jmg.describe_rollout(np.asarray(jstate1.vec_state.env.grid),
                                      np.asarray(jdesc["agent_pos"]), np.asarray(jdesc["agent_dir"]))
        jemb = jcu.encode_texts(clip_j, CLIPConfig(**TINY), jtexts)
        jstate2, jscalars = jtr.run_update_half(jstate1, jdata, 1, jemb)

    tstate1, tdata, _, tdesc = ttr.run_rollout_half(tstate, draws)
    ttexts = tmg.describe_rollout(tstate1.vec_state.env.grid.numpy(), tdesc["agent_pos"].numpy(),
                                  tdesc["agent_dir"].numpy())
    assert ttexts == jtexts and len(ttexts) == jcfg.batch_size
    temb = tcu.encode_texts(clip_t, TCLIPConfig(**TINY), ttexts)
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=1e-5, rtol=0)
    tstate2, tscalars = ttr.run_update_half(tstate1, tdata, 1, temb, draws)

    np.testing.assert_array_equal(tdata["actions"].numpy(), np.asarray(jdata["actions"]))
    for name in ("logprobs", "values", "advantages", "returns"):
        np.testing.assert_allclose(tdata[name].numpy(), np.asarray(jdata[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for name, value in jscalars.items():
        np.testing.assert_allclose(float(tscalars[name]), float(value), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert float(tscalars["first_clip_loss"]) > 0.0
    want = convert.agent_params(_np(jstate2.params))
    for k in ("actor", "critic"):
        diff = (tstate2.params[k]["w"] - want[k]["w"]).abs()
        assert float(diff.max()) <= 1e-4 and float(diff.mean()) <= 1e-6


def test_split_embeddings_are_the_table_rows_on_empty():
    """On Empty (a constant border-wall suffix) the split path's per-step
    embeddings equal the description table's rows for the same snapshots."""
    _, clip_t = _towers()
    cfg = TCLIPConfig(**TINY)
    table = tcu.build_minigrid_text_table(clip_t, cfg, 5, 5, SUFFIX)
    env = TorchVectorEnv("MiniGrid-Empty-5x5-v0", 2, "cpu")
    ttr = TTrainer(TPPOConfig(**CFG), env, 1, clip_lambda=LAMBDA)
    gen = torch.Generator()
    gen.manual_seed(4)
    state = ttr.init_state(tcli.init_agent_params(gen, 7, "cpu"), 4)
    state, _, _, desc = ttr.run_rollout_half(state)
    texts = tmg.describe_rollout(state.vec_state.env.grid.numpy(), desc["agent_pos"].numpy(),
                                 desc["agent_dir"].numpy())
    assert {t.split(", objects")[1] for t in texts} == {SUFFIX.split(", objects")[1]}
    rows = tcu.make_text_table_embed_fn(5)(desc, {"text_table": table})
    np.testing.assert_allclose(tcu.encode_texts(clip_t, cfg, texts).numpy(), rows.numpy(),
                               atol=1e-6, rtol=0)


def _cli_args(tmp_path, *argv):
    return flags.parse(tcli.Args, [
        "--no-cuda", "--num-envs", "2", "--num-steps", "16", "--total-timesteps", "64",
        "--no-capture-video", "--save-freq", "32", "--clip-config.clip-lambda", "1e-5", *argv])


@pytest.mark.parametrize("argv,split", [
    (["--env-id", "MiniGrid-MultiRoom-N2-S4-v0"], True),
    (["--env-id", "MiniGrid-FourRooms-v0", "--no-text-embed-table"], True),
    (["--env-id", "MiniGrid-LavaGapS5-v0", "--clip-config.apply-disturbances",
      "--clip-config.disturbance-severity", "HARD"], False),
], ids=["multiroom", "fourrooms-no-table", "lavagap-table"])
def test_cli_text_modality_paths(tmp_path, monkeypatch, argv, split):
    """A varying suffix and ``--no-text-embed-table`` on a family run the
    split path, one iteration a dispatch; a bordered family keeps the
    table."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcu, "load_clip_model", _tiny_clip)
    calls = []
    real = tcu.encode_texts
    monkeypatch.setattr(tcu, "encode_texts", lambda *a, **k: calls.append(len(a[2])) or real(*a, **k))
    out = tcli.train(_cli_args(tmp_path, *argv), run_name="split")
    assert out["global_step"] == 64 and out["split_path"] is split
    assert calls == ([32, 32] if split else [])
    assert (out["table_seconds"] == 0.0) is split
    assert float(out["last_scalars"]["first_clip_loss"]) > 0.0
    assert (tmp_path / "checkpoints" / "split_final.ckpt").exists()


@pytest.mark.parametrize("argv", [
    ["--env-id", "MiniGrid-KeyCorridorS3R1-v0", "--clip-config.clip-modality", "image"],
    ["--env-id", "MiniGrid-Dynamic-Obstacles-5x5-v0", "--clip-config.ablation-mode",
     "RANDOM_ENCODER"],
    ["--env-id", "MiniGrid-RedBlueDoors-6x6-v0", "--clip-config.ablation-mode", "FROZEN_CLIP",
     "--clip-config.clip-lambda", "0"],
], ids=["image", "random-encoder", "frozen-clip"])
def test_cli_runs_the_families(tmp_path, monkeypatch, argv):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcu, "load_clip_model", _tiny_clip)
    out = tcli.train(_cli_args(tmp_path, *argv), run_name="fam")
    assert out["global_step"] == 64 and not out["split_path"]
    assert all(np.isfinite(float(v)) for k, v in out["last_scalars"].items()
               if k != "explained_variance")


@pytest.mark.parametrize("env_id", ["MiniGrid-Dynamic-Obstacles-5x5-v0",
                                    "MiniGrid-MultiRoom-N2-S4-v0",
                                    "MiniGrid-ObstructedMaze-1Dlh-v0"])
def test_vanilla_cli_runs_the_families(tmp_path, monkeypatch, env_id):
    """Vanilla PPO in view mode; Dynamic-Obstacles' head has 3 actions."""
    monkeypatch.chdir(tmp_path)
    args = flags.parse(tvanilla.Args, ["--no-cuda", "--env-id", env_id, "--num-envs", "2",
                                       "--num-steps", "16", "--total-timesteps", "64",
                                       "--no-capture-video", "--no-save-model"])
    out = tvanilla.train(args, run_name="vanilla")
    assert out["global_step"] == 64 and out["view_mode"]
    assert all(np.isfinite(float(v)) for k, v in out["last_scalars"].items()
               if k != "explained_variance")
    env = TorchVectorEnv(env_id, 2, "cpu")
    assert env.num_actions == (3 if "Dynamic" in env_id else 7)
