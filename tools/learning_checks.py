"""Vanilla-PPO learning checks of the PyTorch/CUDA port, one JSON line a run.

A port of ``benchmarks/learning_checks.py`` through the port's
``cli/ppo_minigrid.train`` (the path ``python -m
clip_ppo_tpu_torch.cli.ppo_minigrid`` drives): a real training run per env
id and seed, reporting wall-clock SPS, the mean of the last 100 episodic
returns and, as the JAX tool reports them, the means of the first and of the
last k episodes (k = min(200, half the episodes)), so learning (or its
absence) shows in one line. The default is
``BASELINE.json`` config 1: MiniGrid-Empty-16x16-v0, 8 envs, 250k steps,
seeds 1, 2 and 3.

    python tools/learning_checks.py                       # on the GPU
    python tools/learning_checks.py MiniGrid-Empty-5x5-v0=4096 --no-cuda --seeds 1
    python tools/learning_checks.py MiniGrid-KeyCorridorS3R1-v0=1000000 --seeds 1
    python tools/learning_checks.py MiniGrid-GoToDoor-5x5-v0=1000000,mission --seeds 1

Each positional argument is ``env_id[=total_timesteps][,option...]``
(default 250k steps), the options those of ``benchmarks/learning_checks.py``
this port runs: ``mission`` (``--mission-conditioning``) and ``recurrent``
(``--recurrent``); a line names the options it ran with. Runs go one after
another in one process, each in a temporary working directory (no
checkpoints, videos or TensorBoard files are kept).
The last line is the mean over every run of its last-100 mean, with the
device's name (and, on a GPU, its power limit from nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

DEFAULT = ("MiniGrid-Empty-16x16-v0=250000",)


def _device(cuda: bool) -> str:
    """The CPU, or the GPU's name and power limit as nvidia-smi gives them."""
    if not cuda:
        return "cpu"
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    lines = smi.stdout.strip().splitlines() if smi.returncode == 0 else []
    return lines[0] if lines else f"{torch.cuda.get_device_name(0)}, power limit not read"


def main(argv: list[str] | None = None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("specs", nargs="*", default=list(DEFAULT))
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    parser.add_argument("--cuda", action=argparse.BooleanOptionalAction, default=True)
    opts = parser.parse_args(argv)

    from clip_ppo_tpu_torch.cli import ppo_minigrid

    lines = []
    cwd = os.getcwd()
    for spec in opts.specs:
        head, *options = spec.split(",")
        unknown = set(options) - {"mission", "recurrent"}
        if unknown:
            parser.error(f"{spec}: unknown options {sorted(unknown)} (mission, recurrent)")
        env_id, _, steps = head.partition("=")
        steps = int(steps or 250_000)
        switches = {"mission_conditioning": "mission" in options,
                    "recurrent": "recurrent" in options}
        for seed in opts.seeds:
            with tempfile.TemporaryDirectory() as tmp:
                os.chdir(tmp)
                try:
                    t0 = time.time()
                    out = ppo_minigrid.train(ppo_minigrid.Args(
                        env_id=env_id, seed=seed, total_timesteps=steps, cuda=opts.cuda,
                        capture_video=False, save_model=False, **switches,
                    ), run_name=f"lcheck_{env_id}_{seed}")
                    wall = time.time() - t0
                finally:
                    os.chdir(cwd)
            ret = out["recent_returns"]
            every = out["episode_returns"]
            k = min(200, max(len(every) // 2, 1))
            line = {
                "metric": "learning_check", "env_id": env_id, "seed": seed, "steps": steps,
                **{o: True for o in ("mission", "recurrent") if o in options},
                "global_step": out["global_step"], "sps": out["sps"], "wall_s": wall,
                "episodes": out["episodes"],
                "last100_mean": sum(ret) / max(len(ret), 1),
                "last100_min": min(ret, default=0.0),
                "first_mean": sum(every[:k]) / max(len(every[:k]), 1),
                "last_mean": sum(every[-k:]) / max(len(every[-k:]), 1), "k": k,
                "device": _device(opts.cuda),
            }
            print(json.dumps(line), flush=True)
            lines.append(line)
    means = [line["last100_mean"] for line in lines]
    print(json.dumps({"metric": "learning_check_mean", "runs": len(lines),
                      "mean_of_last100_means": sum(means) / max(len(means), 1),
                      "device": _device(opts.cuda)}), flush=True)
    return lines


if __name__ == "__main__":
    main()
