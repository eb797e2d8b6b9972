"""Mission-conditioned policy trunk: FiLM over the feature vector.

Port of ``clip_ppo_tpu/models/mission.py`` (``--mission-conditioning``), in
plain PyTorch. The reference drops the mission string through
ImgObsWrapper (`ppo_minigrid.py:110`), so its instruction-following levels
are learnable only to a mission-blind guess rate. Here the env's structured
instruction, the 64 int slots of ``TorchVectorEnv.mission_fn``
(``target`` [8] + ``instr`` [4·12] + ``instr_state`` [4·2]), is embedded on
the device: each slot gives a one-hot over the values −1..15 (clipped) and
the value scaled by 1/512, a two-layer MLP turns the features into
per-channel (γ, β), and the trunk's features h become

    h' = h · (1 + γ) + β.

The FiLM head is zero-initialized, so at init the conditioned agent is the
unconditioned one; conditioning is learned. The encoding includes the
verifier's positional match sets and done latches, more than the mission
text says: see the JAX module's note.
"""

from __future__ import annotations

from typing import Callable

import torch

from clip_ppo_tpu_torch.models import nature_cnn as cnn

FeatureFn = Callable[..., torch.Tensor]  # as models/agent.py's

ONE_HOT = 17          # values −1..15 of a slot, clipped
MISSION_DIM = 64      # target [8] + instr [48] + instr_state [8]
POS_SCALE = 1.0 / 512.0  # packed positions are at most 22·22 + 1


def featurize(mission: torch.Tensor) -> torch.Tensor:
    """[..., M] int → [..., M·18] float32: a one-hot and a scalar a slot."""
    m = mission.long()
    oh = torch.nn.functional.one_hot((m + 1).clamp(0, ONE_HOT - 1), ONE_HOT).float()
    scalar = (m.float() * POS_SCALE)[..., None]
    return torch.cat([oh, scalar], dim=-1).reshape(mission.shape[:-1]
                                                   + (mission.shape[-1] * (ONE_HOT + 1),))


def init_mission_params(gen: torch.Generator, device, mission_dim: int = MISSION_DIM,
                        mission_hidden: int = 128, hidden: int = 512) -> dict:
    """The FiLM generator: an orthogonal dense of the features, and a
    zero-initialized output layer (γ = β = 0 at init). ``gen`` is a CPU
    generator."""
    return {
        "fc": cnn.init_dense(gen, mission_dim * (ONE_HOT + 1), mission_hidden, device),
        "film": {"w": torch.zeros((mission_hidden, 2 * hidden), device=device),
                 "b": torch.zeros(2 * hidden, device=device)},
    }


def mission_film(params: dict, mission: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., M] int mission → (γ, β), [..., hidden] each."""
    x = torch.relu(cnn.dense(params["fc"], featurize(mission)))
    return cnn.dense(params["film"], x).chunk(2, dim=-1)


class MissionFeatures:
    """A FeatureFn over ``(obs, mission)`` pairs: the base trunk's features,
    FiLM-modulated by the mission. The rollout and the update carry the
    pair as one observation."""

    def __init__(self, base_fn: FeatureFn):
        self.base_fn = base_fn

    def _film(self, base_fn, params: dict, pair, frozen) -> torch.Tensor:
        obs, mission = pair
        h = base_fn(params, obs, frozen)
        gamma, beta = mission_film(params["mission"], mission)
        return h * (1.0 + gamma.to(h.dtype)) + beta.to(h.dtype)

    def __call__(self, params: dict, pair, frozen=None) -> torch.Tensor:
        return self._film(self.base_fn, params, pair, frozen)

    def fixed(self, params: dict) -> FeatureFn:
        """This FeatureFn for ``params`` held fixed, through the base
        trunk's own ``fixed`` where it has one (the view trunk's conv1
        pre-sum, computed once a rollout)."""
        fixed = getattr(self.base_fn, "fixed", None)
        base = fixed(params) if fixed is not None else self.base_fn
        return lambda p, pair, frozen=None: self._film(base, p, pair, frozen)
