"""The experiment pipeline against the JAX package: the synthesized OpenAI
archive, the Hugging Face state-dict conversion, the pretrained-robustness
drill end to end, and the ``run_experiments`` grid.

Sizes. One test synthesizes the full ViT-B/32 archive (its layout is what
the drill rehearses) and loads it through both packages' loaders. The drill
runs end to end on the CPU as the JAX package's drill test does, but with the
registry's ViT-B/32 entry narrowed for the test (width 64, one layer each):
the archive is still written, found and read back through the real loader
path, and the full-width text table is what ``chip_smoke.py`` runs on the
card. Everything the loaders produce is compared exactly: both convert the
same fp16 or float32 values to float32.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from clip_ppo_tpu.cli import run_experiments as jrun
from clip_ppo_tpu.models.clip import loader as jloader
from clip_ppo_tpu.models.clip import synth_checkpoint as jsynth
from clip_ppo_tpu.models.clip.config import CLIPConfig as JCLIPConfig
from clip_ppo_tpu_torch.cli import run_experiments as trun
from clip_ppo_tpu_torch.cli import run_pretrained_robustness as tdrill
from clip_ppo_tpu_torch.metrics import get_disturbance_severity
from clip_ppo_tpu_torch.models.clip import config as tconfig
from clip_ppo_tpu_torch.models.clip import loader as tloader
from clip_ppo_tpu_torch.models.clip import synth_checkpoint as tsynth
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig
from clip_ppo_tpu_torch.utils.tree import tree_map

NARROW = dict(embed_dim=512, image_size=64, patch_size=32, vision_width=64, vision_layers=1,
              vision_heads=1, context_length=77, vocab_size=49408, text_width=64, text_heads=1,
              text_layers=1)


def _same_tree(got: dict, want: dict) -> None:
    """Every leaf of the port's params equals the JAX package's."""
    assert set(got) == set(want)

    def check(g, w):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    tree_map(check, got, want)


def test_synthesized_archive_loads_alike_in_both_packages(tmp_path):
    """The full ViT-B/32 archive: the port writes OpenAI's layout with the
    JAX package's weights for the same seed, and both loaders read it to the
    same params and configuration."""
    path = tsynth.write_fake_openai_checkpoint(str(tmp_path / "ViT-B-32.pt"), seed=3)
    want, jcfg = jloader.load_openai_checkpoint(path)
    got, cfg = tloader.load_openai_checkpoint(path, "cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) == \
        dataclasses.asdict(tconfig.CLIP_CONFIGS["ViT-B/32"])
    _same_tree(got, want)
    sd = torch.jit.load(path).state_dict()
    assert sd["visual.conv1.weight"].dtype == torch.float16  # the released files' dtype
    assert len(sd) == 302 and "logit_scale" in sd


def test_openai_module_equals_jax_module_for_a_seed():
    cfg = CLIPConfig(**NARROW)
    got = tsynth.build_openai_module(cfg, seed=11).state_dict()
    want = jsynth.build_openai_module(JCLIPConfig(**NARROW), seed=11).state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _hf_state_dict(cfg: CLIPConfig, seed: int) -> dict:
    """A Hugging Face ``CLIPModel`` state dict of random values (its key
    layout, split q/k/v, [out, in] projections)."""
    rng = np.random.RandomState(seed)
    sd = {}

    def put(key, *shape):
        sd[key] = torch.as_tensor(np.asarray(rng.randn(*shape), dtype=np.float32))

    def layers(prefix, width, n):
        for i in range(n):
            p = f"{prefix}.encoder.layers.{i}."
            for name in ("layer_norm1", "layer_norm2"):
                put(p + f"{name}.weight", width)
                put(p + f"{name}.bias", width)
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                put(p + f"self_attn.{proj}.weight", width, width)
                put(p + f"self_attn.{proj}.bias", width)
            put(p + "mlp.fc1.weight", 4 * width, width)
            put(p + "mlp.fc1.bias", 4 * width)
            put(p + "mlp.fc2.weight", width, 4 * width)
            put(p + "mlp.fc2.bias", width)

    vw, tw = cfg.vision_width, cfg.text_width
    put("vision_model.embeddings.patch_embedding.weight", vw, 3, cfg.patch_size, cfg.patch_size)
    put("vision_model.embeddings.class_embedding", vw)
    put("vision_model.embeddings.position_embedding.weight", cfg.grid_size ** 2 + 1, vw)
    put("vision_model.pre_layrnorm.weight", vw)
    put("vision_model.pre_layrnorm.bias", vw)
    layers("vision_model", vw, cfg.vision_layers)
    put("vision_model.post_layernorm.weight", vw)
    put("vision_model.post_layernorm.bias", vw)
    put("visual_projection.weight", cfg.embed_dim, vw)
    put("text_model.embeddings.token_embedding.weight", cfg.vocab_size, tw)
    put("text_model.embeddings.position_embedding.weight", cfg.context_length, tw)
    layers("text_model", tw, cfg.text_layers)
    put("text_model.final_layer_norm.weight", tw)
    put("text_model.final_layer_norm.bias", tw)
    put("text_projection.weight", cfg.embed_dim, tw)
    put("logit_scale")
    return sd


@pytest.mark.parametrize("layers", [1, 2])
def test_convert_hf_state_dict_matches_jax(layers):
    cfg = CLIPConfig(**dict(NARROW, vision_layers=layers, text_layers=layers, vocab_size=300))
    sd = _hf_state_dict(cfg, seed=layers)
    want = jloader.convert_hf_state_dict(sd, JCLIPConfig(**dataclasses.asdict(cfg)))
    got = tloader.convert_hf_state_dict(sd, cfg, "cpu")
    _same_tree(got, want)
    assert got["visual"]["patch_embed_w"].shape == (cfg.patch_size ** 2 * 3, cfg.vision_width)
    # numpy state dicts convert alike
    _same_tree(tloader.convert_hf_state_dict({k: v.numpy() for k, v in sd.items()}, cfg, "cpu"),
               want)


def test_convert_hf_state_dict_defaults_to_the_gpu():
    cfg = CLIPConfig(**dict(NARROW, vocab_size=300))
    with pytest.raises(RuntimeError, match="--no-cuda|GPU|CUDA"):
        tloader.convert_hf_state_dict(_hf_state_dict(cfg, 0), cfg)


@pytest.fixture
def narrow_registry(monkeypatch):
    """ViT-B/32's registry entry narrowed (the archive, the loader's checks
    and the CLI read the same dict)."""
    monkeypatch.setitem(tconfig.CLIP_CONFIGS, "ViT-B/32", CLIPConfig(**NARROW))


def test_drill_end_to_end_on_the_cpu(tmp_path, monkeypatch, narrow_registry, capsys):
    """--synthesize-checkpoint → the loader path → the clean and disturbed
    pair → the RI, read back from the pair's logs by the port's metrics."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CLIP_PPO_CHECKPOINT_DIR", "")  # the drill sets it; restored after
    loaded = []
    real = tloader.load_openai_checkpoint
    monkeypatch.setattr(tloader, "load_openai_checkpoint",
                        lambda path, device=None: loaded.append(path) or real(path, device))
    # Empty-5x5 truncates at 100 steps: 14 iterations of 2 envs × 8 steps
    # finish episodes in both runs.
    result = tdrill.main(tdrill.Args(
        env_id="MiniGrid-Empty-5x5-v0", total_timesteps=224, num_envs=2, num_steps=8,
        synthesize_checkpoint=True, checkpoint_dir=str(tmp_path / "ckpts"), run_prefix="drill",
        cuda=False))
    out = capsys.readouterr().out
    assert os.path.exists(result["checkpoint"]) and loaded == [result["checkpoint"]] * 2
    assert "Synthesized OpenAI-format checkpoint" in out and "Final robustness index" in out
    assert result["clean_run"] == "runs/drill_MiniGrid-Empty-5x5-v0_clean_s0"
    assert get_disturbance_severity(result["clean_run"]).value == "NONE"
    assert get_disturbance_severity(result["disturbed_run"]).value == "HARD"
    for key in ("final_ri", "mean_ri", "clean_auc", "disturbed_auc"):
        assert np.isfinite(result[key]), key
    assert out.count("Text table: 100 descriptions encoded") == 2  # Empty-5x5's W·H·4


def test_drill_refuses_without_a_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("CLIP_PPO_CHECKPOINT_DIR", str(tmp_path / "empty"))
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(SystemExit, match="No ViT-B/32 checkpoint found"):
        tdrill.main(tdrill.Args(total_timesteps=32, num_envs=2, num_steps=8, cuda=False))
    with pytest.raises(SystemExit, match="needs --checkpoint-dir"):
        monkeypatch.delenv("CLIP_PPO_CHECKPOINT_DIR")
        tdrill.main(tdrill.Args(synthesize_checkpoint=True, cuda=False))


@pytest.mark.parametrize("flag", ["tp", "num_devices"])
def test_drill_refuses_more_than_one_device(tmp_path, monkeypatch, flag):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="multi-GPU"):
        tdrill.main(dataclasses.replace(tdrill.Args(cuda=False), **{flag: 2}))
    assert not os.listdir(tmp_path)


def test_drill_flags_match_jax():
    from clip_ppo_tpu.cli import run_pretrained_robustness as jdrill
    from clip_ppo_tpu.utils import flags as jflags

    names = [p for p, _f, _t in jflags._iter_flags(jdrill.Args)]
    assert [p for p, _f, _t in jflags._iter_flags(tdrill.Args)] == names + ["cuda"]
    assert {k: v for k, v in dataclasses.asdict(tdrill.Args()).items() if k != "cuda"} == \
        dataclasses.asdict(jdrill.Args())


def test_grid_commands_equal_jax_with_the_module_swapped():
    jexps, texps = jrun._setup_main_experiments(), trun._setup_main_experiments()
    assert len(texps) == len(jexps) == 78
    for t, j in zip(texps, jexps):
        assert t.run_name == j.run_name and t.timesteps == j.timesteps
        want = [a.replace("clip_ppo_tpu.cli.", "clip_ppo_tpu_torch.cli.")
                for a in jrun.build_command(j)]
        assert trun.build_command(t) == want
    cfg = trun.ExperimentConfig(
        run_name="x", seed=1, ablation_mode=trun.AblationMode.FROZEN_CLIP, clip_lambda=0.0,
        apply_disturbances=False, disturbance_severity=trun.DisturbanceSeverity.NONE,
        timesteps=10, environment="minigrid", env_id="MiniGrid-Empty-16x16-v0")
    assert "clip_ppo_tpu_torch.cli.clip_ppo_minigrid" in trun.build_command(cfg)


def test_grid_commands_parse_with_the_port_clis():
    from clip_ppo_tpu_torch.cli import clip_ppo_atari, clip_ppo_minigrid
    from clip_ppo_tpu_torch.utils import flags

    for exp in trun._setup_main_experiments():
        cmd = trun.build_command(exp)
        assert cmd[:3] == [sys.executable, "-m", "clip_ppo_tpu_torch.cli.clip_ppo_atari"]
        args = flags.parse(clip_ppo_atari.Args, cmd[3:])
        assert args.clip_config.clip_modality == "image" and args.save_freq == 250000
        assert args.clip_config.apply_disturbances == exp.apply_disturbances
    flags.parse(clip_ppo_minigrid.Args, trun.build_command(dataclasses.replace(
        exp, environment="minigrid", env_id="MiniGrid-Empty-16x16-v0"))[3:])


def test_grid_dry_run_filter_and_start_at(monkeypatch, capsys):
    trun.main(["--dry-run"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if " -m clip_ppo_tpu_torch." in ln]
    assert len(lines) == 78
    monkeypatch.setattr(sys, "argv", ["run_experiments", "--dry-run"])
    jrun.main()
    jlines = [ln for ln in capsys.readouterr().out.splitlines() if " -m clip_ppo_tpu." in ln]
    assert lines == [ln.replace("clip_ppo_tpu.cli.", "clip_ppo_tpu_torch.cli.") for ln in jlines]

    launched = []
    monkeypatch.setattr(trun.subprocess, "run", lambda cmd, check: launched.append(cmd))
    results = trun.main(["--yes", "--filter", "s42_atari_ALEPong-v5_CLIPPPO", "--start-at", "7"])
    names = [e.run_name for e in trun._setup_main_experiments()
             if "s42_atari_ALEPong-v5_CLIPPPO" in e.run_name]
    assert len(names) == 9 and list(results) == names[6:] and all(results.values())
    assert [c[c.index("--run-name") + 1] for c in launched] == names[6:]
    with pytest.raises(SystemExit, match="multi-GPU"):
        trun.main(["--dry-run", "--num-devices", "2"])
