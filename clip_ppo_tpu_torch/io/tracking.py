"""Optional Weights & Biases tracking and torch.profiler trace capture.

The reference inits W&B with ``sync_tensorboard=True`` behind ``--track``
(`ppo_minigrid.py:171-182`); this helper does the same and degrades with a
clear message when wandb is not installed. ``ProfilerWindow`` records a
``torch.profiler`` trace (host and, where present, CUDA activity) of a few
steady-state iterations as a Chrome trace in the profile directory.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional


def maybe_init_wandb(args: Any, run_name: str):
    """Start W&B tracking if ``args.track``; returns the run or None."""
    if not getattr(args, "track", False):
        return None
    try:
        import wandb
    except ImportError:
        print("WARNING: --track requested but wandb is not installed; "
              "continuing with TensorBoard only.")
        return None
    return wandb.init(
        project=args.wandb_project_name,
        entity=args.wandb_entity,
        sync_tensorboard=True,
        config=dataclasses.asdict(args) if dataclasses.is_dataclass(args) else vars(args),
        name=run_name,
        monitor_gym=True,
        save_code=True,
    )


class ProfilerWindow:
    """Trace iterations [start, stop) with torch.profiler into
    ``{profile_dir}/trace.json``."""

    def __init__(self, profile_dir: Optional[str], start: int = 3, stop: int = 6):
        self.profile_dir = profile_dir
        self.start = start
        self.stop = stop
        self._prof = None

    def step(self, iteration: int) -> None:
        if not self.profile_dir:
            return
        import torch

        if iteration == self.start and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            print(f"profiler: tracing iterations {self.start}..{self.stop - 1} "
                  f"→ {self.profile_dir}")
        elif iteration == self.stop and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.profile_dir, exist_ok=True)
            path = os.path.join(self.profile_dir, "trace.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            print(f"profiler: trace written to {path}")
