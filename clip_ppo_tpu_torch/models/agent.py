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

from clip_ppo_tpu_torch.models import mission as mission_mod
from clip_ppo_tpu_torch.models import nature_cnn as cnn


class AblationMode(Enum):
    """Ablation study modes (reference `clip_ppo_utils.py:13-18`)."""

    NONE = "NONE"
    FROZEN_CLIP = "FROZEN_CLIP"
    RANDOM_ENCODER = "RANDOM_ENCODER"


LATENT_DIM = 512  # the trunk's output, the latent the CLIP loss aligns


def init_agent_params(gen: torch.Generator, num_actions: int, device,
                      in_channels: int = 3, hidden: int = LATENT_DIM,
                      with_temporal_projection: bool = False, mission_dim: int = 0) -> dict:
    """Orthogonally initialized trunk and heads; ``gen`` is a CPU generator
    (the weights are drawn on the CPU, then moved to ``device``).
    ``with_temporal_projection`` adds the 4·512 → 512 dense the Atari
    CLIP-PPO agent puts frame-stacked CLIP features through
    (`clip_ppo_atari.py:183-187`); ``mission_dim > 0`` adds the FiLM
    mission head ``params["mission"]`` (``models/mission.py``,
    zero-initialized, so the conditioned agent starts as the plain one)."""
    params = {
        "trunk": cnn.init_nature_cnn(gen, in_channels, device, hidden),
        "actor": cnn.init_dense(gen, hidden, num_actions, device, scale=0.01),
        "critic": cnn.init_dense(gen, hidden, 1, device, scale=1.0),
    }
    if with_temporal_projection:
        params["temporal_projection"] = cnn.init_dense(gen, 4 * hidden, hidden, device)
    if mission_dim > 0:
        params["mission"] = mission_mod.init_mission_params(gen, device, mission_dim,
                                                            hidden=hidden)
    return params


# A feature trunk is ``fn(params, obs, frozen)``; ``frozen`` carries
# non-optimized weights (the frozen CLIP tower of the FROZEN_CLIP trunks).
FeatureFn = Callable[..., torch.Tensor]


def cnn_features(params: dict, obs: torch.Tensor, frozen=None) -> torch.Tensor:
    """uint8 [B,H,W,C] observations → [B, hidden] features (x/255 inside)."""
    del frozen
    return cnn.nature_cnn(params["trunk"], obs.float() / 255.0)


class ViewFeatures:
    """FeatureFn over raw [B, 7, 7, 3] uint8 MiniGrid views
    (:func:`make_view_features`)."""

    def __init__(self, upscale: int):
        self.upscale = upscale

    def __call__(self, params: dict, view: torch.Tensor, frozen=None) -> torch.Tensor:
        del frozen
        # Raw integer codes go into the per-step contraction; the /255 is
        # folded into conv1's weight pre-sum, which stays inside autograd.
        return cnn.nature_cnn_view(params["trunk"], view.float(), self.upscale,
                                   v_scale=1.0 / 255.0)

    def fixed(self, params: dict) -> FeatureFn:
        """This FeatureFn for ``params`` held fixed (a rollout's): conv1's
        weight pre-sum is computed once here instead of at every step. The
        returned function must be called with these same params."""
        with torch.no_grad():
            w2 = cnn.view_conv1_weights(params["trunk"], self.upscale, 1.0 / 255.0)

        def view_features(p: dict, view: torch.Tensor, frozen=None) -> torch.Tensor:
            del frozen
            return cnn.nature_cnn_view(p["trunk"], view.float(), self.upscale, w2=w2)

        return view_features


def make_view_features(upscale: int) -> ViewFeatures:
    """FeatureFn over raw [B, 7, 7, 3] uint8 MiniGrid views: equal to
    :func:`cnn_features` on the ×``upscale`` nearest-upscaled 84×84 obs (see
    ``nature_cnn.nature_cnn_view``), with the same trunk parameters — the
    Trainer's view fast path swaps it in when observations are exact tile
    upscales (no disturbances, no image-CLIP consumer)."""
    return ViewFeatures(upscale)


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
