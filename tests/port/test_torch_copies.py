"""The port's framework-free copies agree with the JAX package's, and the
port never imports JAX or the JAX package."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import pytest

from clip_ppo_tpu.models.clip import tokenizer as jax_tok
from clip_ppo_tpu.ops import severity as jax_sev
from clip_ppo_tpu.utils import flags as jax_flags
from clip_ppo_tpu_torch.models.clip import tokenizer as torch_tok
from clip_ppo_tpu_torch.ops import severity as torch_sev
from clip_ppo_tpu_torch.utils import flags as torch_flags

ROOT = Path(__file__).resolve().parent.parent.parent
PORT = ROOT / "clip_ppo_tpu_torch"


@dataclasses.dataclass
class _Inner:
    clip_lambda: float = 0.0
    apply_disturbances: bool = False
    disturbance_severity: str = "MODERATE"


@dataclasses.dataclass
class _Args:
    seed: int = 1
    cuda: bool = True
    target_kl: Optional[float] = None
    env_id: str = "MiniGrid-Empty-16x16-v0"
    clip_config: _Inner = dataclasses.field(default_factory=_Inner)


@pytest.mark.parametrize("argv", [
    [],
    ["--seed", "3", "--no-cuda", "--target-kl", "0.02"],
    ["--clip-config.clip-lambda", "1e-5", "--clip-config.apply-disturbances",
     "--clip-config.disturbance_severity", "HARD", "--env-id=MiniGrid-DoorKey-6x6-v0"],
])
def test_flags_parse_like_jax(argv):
    assert torch_flags.parse(_Args, argv) == jax_flags.parse(_Args, argv)


def test_port_cli_flag_surface_matches_jax():
    from clip_ppo_tpu.cli import clip_ppo_minigrid as jax_cli
    from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as torch_cli

    def names(cls):
        return [p for p, _f, _t in jax_flags._iter_flags(cls)]

    assert names(torch_cli.Args) == names(jax_cli.Args)


def test_severity_presets_equal():
    for sev in jax_sev.DisturbanceSeverity:
        if sev.name == "NONE":
            continue
        a = jax_sev.SEVERITY_CONFIGS[jax_sev.DisturbanceSeverity[sev.name]]
        b = torch_sev.SEVERITY_CONFIGS[torch_sev.DisturbanceSeverity[sev.name]]
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.blur_kernel_size == b.blur_kernel_size
    assert [s.name for s in torch_sev.DisturbanceSeverity] == [s.name for s in jax_sev.DisturbanceSeverity]


def test_tokenizer_copy_equal():
    texts = [f"agent at ({x},{y}) facing {d}, objects: wall at (0,0), wall at (0,1)"
             for x in range(3) for y in range(2) for d in ("up", "left")]
    texts += ["Hello, world's 42 foo_bar!!  &amp; tabs\tand   spaces"]
    assert (torch_tok.tokenize(texts) == jax_tok.tokenize(texts)).all()
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("o</w>", "w")]
    ours = torch_tok.BPETokenizer(merges)
    theirs = jax_tok.BPETokenizer(merges, use_native=False)
    assert (ours.tokenize(texts) == theirs.tokenize(texts)).all()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", *sorted(ROOT.glob("tools/*.py"))]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "optax", "flax", "clip_ppo_tpu")]
    assert bad == []


def _top_level_imports(path: Path):
    """The modules a file imports when it is imported: its imports outside
    any function."""
    tree = ast.parse(path.read_text(), filename=str(path))
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, funcs):
                continue
            if isinstance(child, ast.Import):
                yield from (a.name for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module and child.level == 0:
                yield child.module
            yield from walk(child)

    return list(walk(tree))


def test_port_needs_no_tensorboard_pandas_matplotlib_or_pil():
    """The card machine has none of the four: nothing of the port imports
    tensorboard or pandas, and matplotlib and PIL are imported only inside
    the functions that draw or save (the metrics' plots, the disturbance
    panels), never when a module is imported."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    never = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
             if m.split(".")[0] in ("tensorboard", "pandas")]
    assert never == []
    at_import = [(str(f.relative_to(ROOT)), m) for f in files for m in _top_level_imports(f)
                 if m.split(".")[0] in ("matplotlib", "PIL")]
    assert at_import == []
    inside = {str(f.relative_to(ROOT)) for f in files for m in _imports(f)
              if m.split(".")[0] in ("matplotlib", "PIL")}
    assert "clip_ppo_tpu_torch/metrics/_plotting.py" in inside
    assert "clip_ppo_tpu_torch/cli/disturbances_test.py" in inside


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'optax', 'clip_ppo_tpu', 'tensorboard', 'pandas',\n"
        "          'matplotlib', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import clip_ppo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(clip_ppo_tpu_torch.__path__, 'clip_ppo_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) > 20


def test_bpe_vocab_in_the_home_cache_like_jax(tmp_path, monkeypatch):
    """Both packages find a merge table under ~/.cache/clip_ppo_tpu and
    tokenize with it alike. The JAX package fixes its search paths when it
    is imported, so its tuple is set to what it reads under this HOME."""
    import gzip

    monkeypatch.delenv("CLIP_PPO_BPE_PATH", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    path = tmp_path / ".cache" / "clip_ppo_tpu" / "bpe_simple_vocab_16e6.txt.gz"
    monkeypatch.setattr(jax_tok, "_DEFAULT_BPE_PATHS", ("", str(path)))
    assert torch_tok.find_bpe_vocab() is None and jax_tok.find_bpe_vocab() is None
    path.parent.mkdir(parents=True)
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\nh e\nl l\nhe ll\no</w> w\na g\nag e\nw a\n")
    texts = ["hello agent", "agent at (1,2) facing up, wall at (0,0)"]
    torch_tok.get_tokenizer.cache_clear()
    jax_tok.get_tokenizer.cache_clear()
    try:
        assert torch_tok.find_bpe_vocab() == jax_tok.find_bpe_vocab() == str(path)
        ours, theirs = torch_tok.get_tokenizer(), jax_tok.get_tokenizer()
        assert isinstance(ours, torch_tok.BPETokenizer)
        assert (ours.tokenize(texts) == theirs.tokenize(texts)).all()
        assert not (ours.tokenize(texts) == torch_tok.HashTokenizer().tokenize(texts)).all()
    finally:
        torch_tok.get_tokenizer.cache_clear()
        jax_tok.get_tokenizer.cache_clear()
