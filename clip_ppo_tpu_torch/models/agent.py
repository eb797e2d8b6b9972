"""Actor-critic agent: policy/value heads over a feature trunk, as functions
over a params dict.

Port of ``clip_ppo_tpu/models/agent.py``: the reference ``Agent`` API —
``get_action_and_value``, ``get_value``, ``get_latent_representation``
(`ppo_minigrid.py:151-162`, `clip_ppo_minigrid.py:269-271`). Categorical
log-probabilities and entropy are computed from logits exactly as
``torch.distributions.Categorical`` does; sampling is Gumbel-max over a
Gumbel batch the caller supplies.
"""

from __future__ import annotations

from enum import Enum
from typing import Callable

import numpy as np
import torch

from clip_ppo_tpu_torch.models import nature_cnn as cnn


class AblationMode(Enum):
    """Ablation study modes (reference `clip_ppo_utils.py:13-18`)."""

    NONE = "NONE"
    FROZEN_CLIP = "FROZEN_CLIP"
    RANDOM_ENCODER = "RANDOM_ENCODER"


LATENT_DIM = 512  # the trunk's output, the latent the CLIP loss aligns


def init_agent_params(gen: torch.Generator, num_actions: int, device,
                      in_channels: int = 3, hidden: int = LATENT_DIM) -> dict:
    """Orthogonally initialized trunk and heads; ``gen`` is a CPU generator
    (the weights are drawn on the CPU, then moved to ``device``)."""
    return {
        "trunk": cnn.init_nature_cnn(gen, in_channels, device, hidden),
        "actor": cnn.init_dense(gen, hidden, num_actions, device, scale=0.01),
        "critic": cnn.init_dense(gen, hidden, 1, device, scale=1.0),
    }


# A feature trunk is ``fn(params, obs, frozen)``; ``frozen`` carries
# non-optimized weights (none on this slice's path).
FeatureFn = Callable[..., torch.Tensor]


def cnn_features(params: dict, obs: torch.Tensor, frozen=None) -> torch.Tensor:
    """uint8 [B,H,W,C] observations → [B, hidden] features (x/255 inside)."""
    del frozen
    return cnn.nature_cnn(params["trunk"], obs.float() / 255.0)


def heads(params: dict, hidden: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Actor logits and critic value as one [hidden, A+1] product."""
    w = torch.cat([params["actor"]["w"], params["critic"]["w"]], dim=1)
    b = torch.cat([params["actor"]["b"], params["critic"]["b"]])
    out = hidden @ w + b
    return out[..., :-1], out[..., -1]


def logprob_entropy(logits: torch.Tensor, action: torch.Tensor):
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, action.long()[..., None])[..., 0]
    entropy = -(logp_all.exp() * logp_all).sum(-1)
    return logp, entropy


def get_action_and_value_gumbel(params: dict, obs: torch.Tensor, gumbel: torch.Tensor,
                                features_fn: FeatureFn = cnn_features, frozen=None):
    """Sample with a supplied Gumbel draw ([..., num_actions]):
    ``argmax(logits + gumbel)`` is Gumbel-max categorical sampling. Returns
    (action, logprob, value)."""
    hidden = features_fn(params, obs, frozen)
    logits, value = heads(params, hidden)
    action = torch.argmax(logits + gumbel, dim=-1)
    logp, _ = logprob_entropy(logits, action)
    return action, logp, value


def evaluate_actions(params: dict, obs: torch.Tensor, action: torch.Tensor,
                     features_fn: FeatureFn = cnn_features, frozen=None):
    """Returns (logprob, entropy, value, hidden) for given actions."""
    hidden = features_fn(params, obs, frozen)
    logits, value = heads(params, hidden)
    logp, entropy = logprob_entropy(logits, action)
    return logp, entropy, value, hidden


def get_value(params: dict, obs: torch.Tensor, features_fn: FeatureFn = cnn_features,
              frozen=None) -> torch.Tensor:
    hidden = features_fn(params, obs, frozen)
    return cnn.dense(params["critic"], hidden)[..., 0]


def get_latent_representation(params: dict, obs: torch.Tensor,
                              features_fn: FeatureFn = cnn_features, frozen=None) -> torch.Tensor:
    """Detached latent for CLIP alignment (`clip_ppo_minigrid.py:269-271`)."""
    return features_fn(params, obs, frozen).detach()


def gumbel_like(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(U))`` with U in (tiny, 1)."""
    u = torch.rand(shape, generator=gen, device=device)
    u = u.clamp_min(float(np.finfo(np.float32).tiny))
    return -torch.log(-torch.log(u))
