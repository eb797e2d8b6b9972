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

And back, for the checkpoints both packages read (``io/checkpoint.py``):

* :func:`jax_agent_params` — the port's agent params → numpy, conv kernels
  OIHW → HWIO.
* :func:`jax_adam_state` — ``{"mu", "nu", "count"}`` and the last update's
  learning rate → the optax chain state, built from stand-ins of optax's
  state classes (:data:`OPTAX_CLASSES`) with numpy leaves.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from clip_ppo_tpu_torch.envs.minigrid.core import EnvState
from clip_ppo_tpu_torch.envs.vector import VecState
from clip_ppo_tpu_torch.train.ppo import ADAM_B1, ADAM_B2, ADAM_EPS
from clip_ppo_tpu_torch.utils.tree import tree_map

_CONVS = ("conv1", "conv2", "conv3")


class EmptyState(NamedTuple):
    """Stand-in of ``optax.EmptyState``."""


class ScaleByAdamState(NamedTuple):
    """Stand-in of ``optax.ScaleByAdamState``."""
    count: Any
    mu: Any
    nu: Any


class InjectStatefulHyperparamsState(NamedTuple):
    """Stand-in of ``optax.InjectStatefulHyperparamsState``."""
    count: Any
    hyperparams: Any
    hyperparams_states: Any
    inner_state: Any


# Each stand-in and the module and name a pickle of the JAX package's
# optimizer state records for the optax class it stands for (optax 0.2).
OPTAX_CLASSES = {
    EmptyState: ("optax._src.base", "EmptyState"),
    ScaleByAdamState: ("optax._src.transform", "ScaleByAdamState"),
    InjectStatefulHyperparamsState: ("optax.schedules._inject", "InjectStatefulHyperparamsState"),
}


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def agent_params(tree: dict, device="cpu") -> dict:
    """Agent params (trunk conv1-3 + fc, actor, critic)."""
    out = tree_map(lambda a: _t(a, device), tree)
    for name in _CONVS:
        out["trunk"][name]["w"] = out["trunk"][name]["w"].permute(3, 2, 0, 1).contiguous()
    return out


def jax_agent_params(params: dict) -> dict:
    """Inverse of :func:`agent_params`: numpy arrays, conv kernels HWIO."""
    out = tree_map(lambda t: t.detach().cpu().numpy(), params)
    for name in _CONVS:
        out["trunk"][name]["w"] = np.ascontiguousarray(out["trunk"][name]["w"].transpose(2, 3, 1, 0))
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


def jax_adam_state(state: dict, learning_rate: float) -> tuple:
    """Inverse of :func:`adam_state`: the state of the JAX package's
    ``chain(clip_by_global_norm, inject_hyperparams(adam)(eps=1e-5))`` after
    ``state["count"]`` updates, the last at ``learning_rate``."""
    count = np.asarray(state["count"].cpu().numpy(), np.int32)
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    hyperparams = {"learning_rate": f32(learning_rate), "b1": f32(ADAM_B1), "b2": f32(ADAM_B2),
                   "eps": f32(ADAM_EPS), "eps_root": f32(0.0)}
    adam = ScaleByAdamState(count, jax_agent_params(state["mu"]), jax_agent_params(state["nu"]))
    return (EmptyState(), InjectStatefulHyperparamsState(count, hyperparams, {},
                                                          (adam, EmptyState())))


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
