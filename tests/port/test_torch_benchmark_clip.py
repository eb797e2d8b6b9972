"""The port's CLIP encoder benchmark (``clip_ppo_tpu_torch.cli.benchmark_clip``)
on the CPU: its flag surface against the JAX tool's, its output, the route
each call takes, and the options it rejects up front.

The tower is patched in, as ``tests/test_tp_cli.py`` does for the JAX tool:
ViT-L/14's vision width and heads at one layer on 2 x 2 patches, so "auto"
takes K4 (plain on the CPU), and a narrow text tower (K2's route).
"""

import re

import pytest
import torch

from clip_ppo_tpu.cli import benchmark_clip as jbench
from clip_ppo_tpu.utils import flags as jflags
from clip_ppo_tpu_torch.cli import benchmark_clip as tbench
from clip_ppo_tpu_torch.models.clip import model as tmodel
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig

WIDE = CLIPConfig(embed_dim=64, image_size=28, patch_size=14, vision_width=1024,
                  vision_layers=1, vision_heads=16, text_width=128, text_heads=2,
                  text_layers=1, vocab_size=512)


def _tiny_tower(name, device, **_):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return tmodel.init_clip_params(gen, WIDE, device), WIDE


def test_flag_surface_matches_jax():
    def flags_of(cls):
        return {path: f.default for path, f, _ in jflags._iter_flags(cls)}

    port, ref = flags_of(tbench.ClipBenchArgs), flags_of(jbench.ClipBenchArgs)
    assert port == {**ref, "cuda": True}


@pytest.mark.parametrize("impl,kernel", [("auto", "fused_qkv_attention"),
                                         ("pallas", "packed_attention")])
def test_main_runs_on_cpu(monkeypatch, capsys, impl, kernel):
    monkeypatch.setattr(tbench, "load_clip_model", _tiny_tower)
    calls = {"image": 0, "text": 0}
    for name, half in ((kernel, "image"), ("attn_block", "text")):
        real = getattr(tmodel, name)
        monkeypatch.setattr(tmodel, name,
                            lambda *a, real=real, half=half: calls.__setitem__(half, calls[half] + 1)
                            or real(*a))
    tbench.main(["--no-cuda", "--dtype", "float32", "--batch-sizes", "2", "3",
                 "--text-batch", "2", "--iterations", "2", "--attention-impl", impl])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "model=ViT-B/32 dtype=float32 device=cpu (cpu)"
    assert lines[1].split() == ["batch", "ms/batch", "frames/s/chip"]
    for line, b in zip(lines[2:4], (2, 3)):
        assert re.fullmatch(rf"\s+{b}\s+\d+\.\d\d\s+\d+", line), line
    assert re.fullmatch(r"text  batch=2: \d+\.\d\d ms/batch \(\d+ seqs/s/chip\)", lines[4])
    # One layer per tower; each batch size makes one warm-up and two timed calls.
    assert calls == {"image": 2 * 3, "text": 3}


@pytest.mark.parametrize("argv,match", [
    (["--dtype", "float32", "--tp", "2"], "multi-GPU slice"),
    (["--dtype", "float32", "--num-devices", "2"], "multi-GPU slice"),
])
def test_main_rejects_what_later_slices_bring(monkeypatch, argv, match):
    monkeypatch.setattr(tbench, "resolve_device", lambda cuda: torch.device("cuda", 0))
    monkeypatch.setattr(tbench, "load_clip_model", lambda *a, **k: pytest.fail("tower built"))
    with pytest.raises(SystemExit, match=match):
        tbench.main(argv)


@pytest.mark.parametrize("impl,kernel", [("auto", "fused_qkv_attention"),
                                         ("fused", "fused_qkv_attention"),
                                         ("pallas", "packed_attention")])
def test_main_runs_vit_l14_width_at_its_default_bf16_on_cpu(monkeypatch, capsys, impl, kernel):
    """The default dtype, bfloat16, at ViT-L/14's vision width: the towers
    cast once and every call routed as on the GPU, where each of these
    wrappers launches its bf16 entry point."""
    monkeypatch.setattr(tbench, "load_clip_model", _tiny_tower)
    seen = {"image": [], "text": []}
    for name, half in ((kernel, "image"), ("attn_block", "text")):
        real = getattr(tmodel, name)
        monkeypatch.setattr(tmodel, name,
                            lambda x, *a, real=real, half=half: seen[half].append(x.dtype)
                            or real(x, *a))
    tbench.main(["--no-cuda", "--batch-sizes", "2", "--text-batch", "2", "--iterations", "1",
                 "--attention-impl", impl])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "model=ViT-B/32 dtype=bfloat16 device=cpu (cpu)"
    assert len(lines) == 4 and lines[3].startswith("text  batch=2: ")
    assert seen == {"image": [torch.bfloat16] * 2, "text": [torch.bfloat16] * 2}


@pytest.mark.parametrize("argv", [
    ["--model", "ViT-L/14"],  # the default dtype, bfloat16
    ["--model", "ViT-L/14", "--attention-impl", "fused"],
    ["--model", "ViT-B/32", "--attention-impl", "pallas"],
    ["--model", "ViT-B/16"],
    ["--model", "ViT-B/16", "--dtype", "float32"],
])
def test_main_takes_every_model_and_impl_on_the_gpu(monkeypatch, argv):
    """Nothing of these is refused on the GPU any more: the run goes on to
    build the tower."""
    monkeypatch.setattr(tbench, "resolve_device", lambda cuda: torch.device("cuda", 0))

    def built(name, device, **_):
        raise RuntimeError(f"tower {name} built on {device}")

    monkeypatch.setattr(tbench, "load_clip_model", built)
    with pytest.raises(RuntimeError, match=f"tower {argv[1]} built on cuda:0"):
        tbench.main(argv)


def test_main_needs_a_gpu_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbench, "load_clip_model", lambda *a, **k: pytest.fail("tower built"))
    with pytest.raises(RuntimeError, match="--no-cuda"):
        tbench.main(["--dtype", "float32"])
