"""The port's Atari CLIs (``cli/ppo_atari.py``, ``cli/clip_ppo_atari.py``) on
the CPU at tiny sizes: 2 envs × 8 steps, 2 iterations, and a tiny CLIP
tower (image 32, patch 16, width 128 = 2 heads × 64, 2 layers) patched in
for the ViT-B/32 the CLI loads.

``ppo_atari`` on each of Breakout, Pong and Seaquest; ``clip_ppo_atari`` in
every mode the card runs: the image modality (the default), the text
modality (the split path: descriptions of the live games tokenized between
the rollout and the update), FROZEN_CLIP, RANDOM_ENCODER in both
modalities, and HARD ``stack_frames`` disturbances on Pong. Each run's
losses are finite, its CLIP loss positive (0 under FROZEN_CLIP, which has
none), and its TensorBoard events and final checkpoint written. The
options of later slices are refused by name before any work, and
checkpoints cross between the packages both ways with
``temporal_projection`` in them: the JAX package's loader reads the port's,
and the port reads the JAX package's in a process where JAX cannot be
imported, and resumes from it.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from clip_ppo_tpu.cli import clip_ppo_atari as jcli
from clip_ppo_tpu.cli import ppo_atari as jvcli
from clip_ppo_tpu.io.checkpoint import load_checkpoint as jload
from clip_ppo_tpu.io.checkpoint import save_checkpoint as jsave
from clip_ppo_tpu.models import agent as jagent
from clip_ppo_tpu.train import PPOConfig as JPPOConfig
from clip_ppo_tpu.train import ppo as jppo
from clip_ppo_tpu.utils import flags as jflags
from clip_ppo_tpu_torch.cli import clip_ppo_atari as tcli
from clip_ppo_tpu_torch.cli import ppo_atari as tvcli
from clip_ppo_tpu_torch.io.checkpoint import load_checkpoint
from clip_ppo_tpu_torch.models import clip_utils as tcu
from clip_ppo_tpu_torch.models.agent import init_agent_params
from clip_ppo_tpu_torch.models.clip import model as tmodel
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from clip_ppo_tpu_torch.train.ppo import init_adam_state
from clip_ppo_tpu_torch.utils import flags

ROOT = Path(__file__).resolve().parent.parent.parent
TINY = dict(embed_dim=512, image_size=32, patch_size=16, vision_width=128, vision_layers=2,
            vision_heads=2, text_width=128, text_heads=2, text_layers=1, vocab_size=49408)
SMALL = ["--num-envs", "2", "--num-steps", "8", "--num-minibatches", "2", "--update-epochs",
         "2", "--total-timesteps", "32", "--no-capture-video", "--seed", "3"]


def _tiny_clip(name, device, **_):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return tmodel.init_clip_params(gen, TCLIPConfig(**TINY), device), TCLIPConfig(**TINY)


def _finite(scalars: dict) -> bool:
    return bool(np.isfinite([float(v) for k, v in scalars.items()
                             if k != "explained_variance"]).all())


def test_atari_cli_flag_surfaces_match_jax():
    def names(cls):
        return [p for p, _f, _t in jflags._iter_flags(cls)]

    assert names(tcli.Args) == names(jcli.Args)
    assert names(tvcli.Args) == names(jvcli.Args)


@pytest.mark.parametrize("env_id", ["ALE/Breakout-v5", "ALE/Pong-v5", "ALE/Seaquest-v5"])
def test_ppo_atari_runs_on_cpu(tmp_path, monkeypatch, env_id):
    monkeypatch.chdir(tmp_path)
    out = tvcli.train(flags.parse(tvcli.Args, ["--no-cuda", "--env-id", env_id, *SMALL]),
                      run_name="v")
    assert out["global_step"] == 32 and _finite(out["last_scalars"])
    assert os.listdir(tmp_path / "runs" / "v") and not (tmp_path / "checkpoints").exists()


MODES = {
    "image": [],
    "text": ["--clip-config.clip-modality", "text"],
    "frozen": ["--clip-config.ablation-mode", "FROZEN_CLIP"],
    "random-image": ["--clip-config.ablation-mode", "RANDOM_ENCODER"],
    "random-text": ["--clip-config.ablation-mode", "RANDOM_ENCODER",
                    "--clip-config.clip-modality", "text"],
    "hard-pong": ["--env-id", "ALE/Pong-v5", "--clip-config.apply-disturbances",
                  "--clip-config.disturbance-severity", "HARD"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_clip_ppo_atari_runs_on_cpu(tmp_path, monkeypatch, mode):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcu, "load_clip_model", _tiny_clip)
    args = flags.parse(tcli.Args, ["--no-cuda", *SMALL, *MODES[mode]])
    out = tcli.train(args, run_name=mode)
    scalars = out["last_scalars"]
    assert out["global_step"] == 32 and _finite(scalars)
    clip_loss = float(scalars["first_clip_loss"])
    assert clip_loss == 0.0 if mode == "frozen" else clip_loss > 0.0
    assert os.listdir(tmp_path / "runs" / mode)
    projection = mode in ("image", "frozen", "random-image", "hard-pong")
    num_actions = 6 if mode == "hard-pong" else 4
    template = init_agent_params(torch.Generator(), num_actions, "cpu", in_channels=4,
                                 with_temporal_projection=projection)
    params, opt_state, it, step, raw = load_checkpoint(
        str(tmp_path / "checkpoints" / f"{mode}_final.ckpt"), template,
        init_adam_state(template), "cpu")
    assert (it, step) == (2, 32) and int(opt_state["count"]) == 2 * 2 * 2
    assert raw["args"]["env_id"] == args.env_id
    if projection:  # trained: the projection left its initial values
        start = init_agent_params(torch.Generator().manual_seed(3), num_actions, "cpu",
                                  in_channels=4, with_temporal_projection=True)
        assert not torch.equal(params["temporal_projection"]["w"],
                               start["temporal_projection"]["w"])


def test_seaquest_text_modality_raises_like_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcu, "load_clip_model", _tiny_clip)
    args = flags.parse(tcli.Args, ["--no-cuda", *SMALL, "--env-id", "ALE/Seaquest-v5",
                                   "--clip-config.clip-modality", "text"])
    with pytest.raises(ValueError, match="Seaquest not supported for CLIP PPO"):
        tcli.train(args, run_name="x")


@pytest.mark.parametrize("cli", [tcli, tvcli], ids=["clip_ppo_atari", "ppo_atari"])
@pytest.mark.parametrize("argv,match", [
    (["--env-backend", "ale"], "--env-backend ale.*host/ALE slice"),
    (["--distributed"], "--distributed.*multi-GPU slice"),
    (["--num-devices", "2"], "--num-devices above 1.*multi-GPU slice"),
])
def test_atari_clis_refuse_later_slices_before_any_work(tmp_path, monkeypatch, cli, argv, match):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=match):
        cli.train(flags.parse(cli.Args, ["--no-cuda", *SMALL, *argv]), run_name="x")
    assert not (tmp_path / "runs").exists() and not (tmp_path / "checkpoints").exists()


def test_atari_cli_cuda_flag_needs_a_gpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the error without one")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="--no-cuda"):
        tcli.train(flags.parse(tcli.Args, SMALL), run_name="x")
    assert not (tmp_path / "runs").exists()


def _jax_atari_checkpoint(tmp_path) -> tuple[str, dict]:
    """A checkpoint as the JAX Atari CLI writes it after iteration 1 of the
    image modality: params with ``temporal_projection`` and the optimizer."""
    params = jagent.init_agent_params(jax.random.PRNGKey(2), 4, in_channels=4,
                                      with_temporal_projection=True)
    opt_state = jppo.make_optimizer(JPPOConfig()).init(params)
    path = jsave(str(tmp_path / "jax"), params, opt_state, 1, 16, {"seed": 5})
    return path, jax.tree_util.tree_map(np.asarray, params)


def test_checkpoints_cross_between_the_packages(tmp_path, monkeypatch, capsys):
    path, jparams = _jax_atari_checkpoint(tmp_path)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'optax', 'clip_ppo_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from clip_ppo_tpu_torch.io.checkpoint import load_checkpoint\n"
        "from clip_ppo_tpu_torch.models.agent import init_agent_params\n"
        "from clip_ppo_tpu_torch.train.ppo import init_adam_state\n"
        "t = init_agent_params(torch.Generator(), 4, 'cpu', in_channels=4,\n"
        "                      with_temporal_projection=True)\n"
        f"p, _, it, step, _ = load_checkpoint({path!r}, t, init_adam_state(t), 'cpu')\n"
        "print(it, step, float(p['temporal_projection']['w'].double().sum()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    it, step, total = out.stdout.splitlines()[-1].split()
    assert (it, step) == ("1", "16")
    # the same float32 values (their float64 sums, taken in other orders)
    assert abs(float(total) - float(jparams["temporal_projection"]["w"].astype(np.float64).sum())) \
        < 1e-9

    # The port's CLI resumes from it (iteration 2 of 2) and writes its own,
    # which the JAX package's loader reads.
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcu, "load_clip_model", _tiny_clip)
    out = tcli.train(flags.parse(tcli.Args, ["--no-cuda", *SMALL, "--resume-checkpoint", path]),
                     run_name="resumed")
    assert out["global_step"] == 32 and "iteration 1, global_step 16" in capsys.readouterr().out
    template = jagent.init_agent_params(jax.random.PRNGKey(0), 4, in_channels=4,
                                        with_temporal_projection=True)
    got, _, it, step, _ = jload(str(tmp_path / "checkpoints" / "resumed_final.ckpt"), template,
                                jppo.make_optimizer(JPPOConfig()).init(template))
    assert (it, step) == (2, 32)
    assert np.asarray(got["temporal_projection"]["w"]).shape == (2048, 512)
    assert not np.array_equal(np.asarray(got["temporal_projection"]["w"]),
                              jparams["temporal_projection"]["w"])
