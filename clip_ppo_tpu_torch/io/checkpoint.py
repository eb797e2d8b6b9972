"""Checkpoint save/load with the reference's naming and payload schema.

Port of ``clip_ppo_tpu/io/checkpoint.py`` (`shared/checkpoint_utils.py:9-46`):
one pickle per checkpoint holding iteration, global_step, the agent and
optimizer state as numpy trees, the args dict, the last batch returns and a
``training_complete`` flag. Naming: ``{prefix}_step_{global_step}.ckpt``
plus a ``_latest.ckpt`` overwrite, and ``{prefix}_final.ckpt`` at the end
(``CLIP_PPO_CKPT_EXT=.pt`` gives the reference's extension). The port's
trees keep its own layouts (conv weights OIHW, Adam state
``{"mu", "nu", "count"}``).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from enum import Enum
from typing import Any, Optional

import numpy as np
import torch

from clip_ppo_tpu_torch.utils.tree import tree_map


def _to_numpy(tree):
    return tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                    else np.asarray(x), tree)


def _jsonable(value):
    if isinstance(value, Enum):
        return value.value
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _jsonable(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return type(value)(_jsonable(v) for v in value)
    return value


def _ext() -> str:
    return os.environ.get("CLIP_PPO_CKPT_EXT", ".ckpt")


def save_checkpoint(prefix: str, params: dict, opt_state: Any, iteration: int,
                    global_step: int, args: Any, b_returns: Optional[np.ndarray] = None,
                    final: bool = False) -> str:
    checkpoint = {
        "iteration": int(iteration),
        "global_step": int(global_step),
        "agent_state": _to_numpy(params),
        "optimizer_state": _to_numpy(opt_state),
        "args": _jsonable(dataclasses.asdict(args) if dataclasses.is_dataclass(args) else dict(args)),
        "returns": np.asarray(b_returns) if b_returns is not None else None,
        "training_complete": bool(final),
    }
    ext = _ext()
    if final:
        filename = f"{prefix}_final{ext}"
        print(f"Final model saved: {filename}")
    else:
        filename = f"{prefix}_step_{global_step}{ext}"
        print(f"Model saved at step {global_step}")
        with open(f"{prefix}_latest{ext}", "wb") as f:
            pickle.dump(checkpoint, f)
    with open(filename, "wb") as f:
        pickle.dump(checkpoint, f)
    return filename


def load_checkpoint(path: str, params_template: dict, opt_state_template: Any, device
                    ) -> tuple[dict, Any, int, int, dict]:
    """Restore (params, opt_state, iteration, global_step, raw_checkpoint)
    onto the templates' structure on ``device``. Loads a pickle: only open
    checkpoints this program wrote."""
    print(f"Loading checkpoint from {path}")
    with open(path, "rb") as f:
        checkpoint = pickle.load(f)
    as_tensor = lambda t, a: torch.as_tensor(a, device=device)  # noqa: E731
    params = tree_map(as_tensor, params_template, checkpoint["agent_state"])
    opt_state = tree_map(as_tensor, opt_state_template, checkpoint["optimizer_state"])
    iteration, global_step = checkpoint["iteration"], checkpoint["global_step"]
    print(f"Checkpoint loaded: iteration {iteration}, global_step {global_step}")
    if checkpoint.get("training_complete", False):
        print("Warning: This was a final checkpoint - training was marked as complete")
    return params, opt_state, iteration, global_step, checkpoint
