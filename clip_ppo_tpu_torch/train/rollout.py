"""On-device rollout collection.

Port of ``clip_ppo_tpu/train/rollout.py``'s ``collect_rollout``. Each of
the ``num_steps`` steps disturbs the observation (before it is stored or
acted on, as the CLIP scripts place it, `clip_ppo_minigrid.py:381-388`),
samples the policy, steps the envs and writes its records into [T, N]
storage on the device; no step waits for the host.

The random draws are explicit: the whole rollout's categorical noise is one
[T, N, A] Gumbel batch, and each step's disturbance takes its
:class:`~clip_ppo_tpu_torch.ops.disturbances.DisturbanceDraws`. Both are
drawn from the run's generator unless the caller passes them.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import torch

from clip_ppo_tpu_torch.models import agent as agent_mod
from clip_ppo_tpu_torch.ops.disturbances import DisturbanceDraws, disturb_auto
from clip_ppo_tpu_torch.ops.severity import DisturbanceParams


class RolloutBatch(NamedTuple):
    """Per-step storage, leading axes [num_steps, num_envs]."""

    obs: torch.Tensor             # uint8 [T, N, H, W, C] (disturbed)
    actions: torch.Tensor         # int64 [T, N]
    logprobs: torch.Tensor        # f32 [T, N]
    rewards: torch.Tensor         # f32 [T, N]
    dones: torch.Tensor           # f32 [T, N] (done flag entering the step)
    values: torch.Tensor          # f32 [T, N]
    done_mask: torch.Tensor       # bool [T, N]
    episode_return: torch.Tensor  # f32 [T, N] (value where done_mask)
    episode_length: torch.Tensor  # int32 [T, N]
    desc: dict                    # per-step {"agent_pos", "agent_dir"} or {}
    video: Any                    # env-0 RGB frames [T, H, W, 3] or None


def collect_rollout(
    params: dict,
    env,
    vec_state,
    obs: torch.Tensor,
    next_done: torch.Tensor,
    gen: torch.Generator,
    num_steps: int,
    disturbance: Optional[DisturbanceParams] = None,
    features_fn: agent_mod.FeatureFn = agent_mod.cnn_features,
    capture_video: bool = False,
    frozen=None,
    collect_desc: bool = True,
    gumbels: Optional[torch.Tensor] = None,
    disturb_draws: Optional[Sequence[DisturbanceDraws]] = None,
):
    """Run ``num_steps`` env steps. Returns (vec_state, obs, next_done,
    RolloutBatch). ``gumbels`` [T, N, A] and ``disturb_draws`` (one per
    step) default to draws from ``gen``."""
    device = obs.device
    n = obs.shape[0]
    if gumbels is None:
        gumbels = agent_mod.gumbel_like((num_steps, n, env.num_actions), gen, device)
    obs_t = torch.empty((num_steps,) + tuple(obs.shape), dtype=torch.uint8, device=device)
    packed = torch.empty((num_steps, n, 8), device=device)
    desc = {"agent_pos": [], "agent_dir": []} if collect_desc else {}
    video = [] if capture_video else None
    with torch.no_grad():
        for t in range(num_steps):
            if disturbance is not None:
                x = obs.float() / 255.0
                x = disturb_auto(x, disturbance, gen,
                                 None if disturb_draws is None else disturb_draws[t])
                obs = (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)
            action, logprob, value = agent_mod.get_action_and_value_gumbel(
                params, obs, gumbels[t], features_fn, frozen)
            if collect_desc:
                snap = env.rollout_desc(vec_state)
                desc["agent_pos"].append(snap["agent_pos"])
                desc["agent_dir"].append(snap["agent_dir"])
            if capture_video:
                video.append(env.render_env0(vec_state))
            new_state, new_obs, reward, term, trunc, info = env.step_fn(vec_state, action, gen)
            obs_t[t] = obs
            packed[t] = torch.stack([
                action.float(), logprob, reward.float(), next_done.float(), value,
                info["done_mask"].float(), info["episode_return"].float(),
                info["episode_length"].float(),
            ], dim=-1)
            vec_state, obs = new_state, new_obs
            next_done = (term | trunc).float()
    if collect_desc:
        desc = {k: torch.stack(v) for k, v in desc.items()}
    batch = RolloutBatch(
        obs=obs_t,
        actions=packed[..., 0].long(),
        logprobs=packed[..., 1],
        rewards=packed[..., 2],
        dones=packed[..., 3],
        values=packed[..., 4],
        done_mask=packed[..., 5].bool(),
        episode_return=packed[..., 6],
        episode_length=packed[..., 7].to(torch.int32),
        desc=desc,
        video=None if video is None else torch.stack(video),
    )
    return vec_state, obs, next_done, batch
