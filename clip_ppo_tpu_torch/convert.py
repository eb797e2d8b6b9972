"""Carry the JAX package's weights and state across to the port.

Inputs are the JAX trees with every leaf already a numpy array (for
example ``jax.tree_util.tree_map(np.asarray, tree)``); nothing here imports
jax. Outputs are the port's tensors on ``device``:

* :func:`agent_params` — conv kernels HWIO → OIHW; dense ``[in, out]``
  weights and biases unchanged (both packages compute ``x @ w + b``).
* :func:`clip_params` — both towers; the layouts already agree.
* :func:`adam_state` — optax's ``ScaleByAdamState`` inside the
  ``chain(clip_by_global_norm, inject_hyperparams(adam))`` state →
  ``{"mu", "nu", "count"}`` with ``mu``/``nu`` converted like the params.
* :func:`env_state` / :func:`vec_state` — MiniGrid ``EnvState`` /
  ``VecState`` (batched over envs). The JAX state's PRNG key and the
  mission fields of other families have no counterpart here and are
  dropped.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from clip_ppo_tpu_torch.envs.minigrid.core import EnvState
from clip_ppo_tpu_torch.envs.vector import VecState
from clip_ppo_tpu_torch.utils.tree import tree_map


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def agent_params(tree: dict, device="cpu") -> dict:
    """Agent params (trunk conv1-3 + fc, actor, critic)."""
    out = tree_map(lambda a: _t(a, device), tree)
    for name in ("conv1", "conv2", "conv3"):
        out["trunk"][name]["w"] = out["trunk"][name]["w"].permute(3, 2, 0, 1).contiguous()
    return out


def clip_params(tree: dict, device="cpu") -> dict:
    """CLIP params (both towers), float32."""
    return tree_map(lambda a: _t(a, device, torch.float32), tree)


def _find_adam(node: Any):
    if all(hasattr(node, k) for k in ("mu", "nu", "count")):
        return node
    if isinstance(node, (list, tuple)):
        for item in node:
            found = _find_adam(item)
            if found is not None:
                return found
    if hasattr(node, "inner_state"):
        return _find_adam(node.inner_state)
    return None


def adam_state(opt_state: Any, device="cpu") -> dict:
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in the given optimizer state")
    return {"mu": agent_params(adam.mu, device), "nu": agent_params(adam.nu, device),
            "count": _t(adam.count, device, torch.int32)}


def env_state(st: Any, device="cpu") -> EnvState:
    return EnvState(
        grid=_t(st.grid, device, torch.int8),
        agent_pos=_t(st.agent_pos, device, torch.int64),
        agent_dir=_t(st.agent_dir, device, torch.int64),
        carrying=_t(st.carrying, device, torch.int8),
        step_count=_t(st.step_count, device, torch.int32),
    )


def vec_state(vs: Any, device="cpu") -> VecState:
    return VecState(
        env=env_state(vs.env, device),
        episode_return=_t(vs.episode_return, device, torch.float32),
        episode_length=_t(vs.episode_length, device, torch.int32),
    )
