"""On-device rollout collection.

Port of ``clip_ppo_tpu/train/rollout.py``'s ``collect_rollout``. Each of
the ``num_steps`` steps disturbs the observation (before it is stored or
acted on, as the CLIP scripts place it, `clip_ppo_minigrid.py:381-388`),
samples the policy, steps the envs and writes its records into [T, N]
storage on the device; no step waits for the host.

The random draws are explicit: the whole rollout's categorical noise is one
[T, N, A] Gumbel batch, each step's disturbance takes its
:class:`~clip_ppo_tpu_torch.ops.disturbances.DisturbanceDraws` (a tuple of
one a frame under the Atari ``stack_frames`` semantics), and each env step
may take the env's own draws (the Atari games' serves and spawns,
Dynamic-Obstacles' ball moves). All are drawn from the run's generator
unless the caller passes them. An env with ``prepare_resets`` (MiniGrid)
makes the rollout's fresh states in one batched reset before its first
step. The rollout stores the disturbed observation and acts on it; the
env's own stack stays clean.

A feature trunk may offer ``fixed(params)``, a copy of itself for params
that do not change; the rollout calls it once, so the view fast path's
conv1 weight pre-sum (``agent.ViewFeatures``) is computed once a rollout
and not at each of its steps.

``collect_rollout_recurrent`` is the LSTM agent's rollout
(``--recurrent``): the same loop, with the cell between the trunk and the
heads and its (h, c) carried across the steps.

With ``mission_fn`` (``--mission-conditioning``, ``models/mission.py``) the
policy reads ``(obs, mission)`` pairs and the batch stores them: the
mission [T, N, M] int32 is computed from each step's env state, and the
carried observation stays plain.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import torch

from clip_ppo_tpu_torch.models import agent as agent_mod
from clip_ppo_tpu_torch.models import recurrent as rec
from clip_ppo_tpu_torch.ops.disturbances import DisturbanceDraws, disturb_auto
from clip_ppo_tpu_torch.ops.severity import DisturbanceParams


class RolloutBatch(NamedTuple):
    """Per-step storage, leading axes [num_steps, num_envs]."""

    obs: Any                      # uint8 [T, N, H, W, C] (disturbed), or the
                                  # raw [T, N, 7, 7, 3] views with small_obs;
                                  # with a mission_fn the pair (obs, mission
                                  # [T, N, M] int32)
    actions: torch.Tensor         # int64 [T, N]
    logprobs: torch.Tensor        # f32 [T, N]
    rewards: torch.Tensor         # f32 [T, N]
    dones: torch.Tensor           # f32 [T, N] (done flag entering the step)
    values: torch.Tensor          # f32 [T, N]
    done_mask: torch.Tensor       # bool [T, N]
    episode_return: torch.Tensor  # f32 [T, N] (value where done_mask)
    episode_length: torch.Tensor  # int32 [T, N]
    desc: dict                    # per-step snapshots ({"agent_pos", "agent_dir"}) or {}
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
    disturbance_semantics: str = "batched",
    features_fn: agent_mod.FeatureFn = agent_mod.cnn_features,
    capture_video: bool = False,
    frozen=None,
    collect_desc: bool = True,
    gumbels: Optional[torch.Tensor] = None,
    disturb_draws: Optional[Sequence[DisturbanceDraws]] = None,
    small_obs: bool = False,
    env_draws: Optional[Sequence[Any]] = None,
    mission_fn=None,
):
    """Run ``num_steps`` env steps. Returns (vec_state, obs, next_done,
    RolloutBatch). ``gumbels`` [T, N, A], ``disturb_draws`` (one per step)
    and ``env_draws`` (one per step, for an env whose ``step_fn`` takes
    ``draws``) default to draws from ``gen``. ``mission_fn(vec_state)`` →
    [N, M] int32, where given, makes the policy's input and the stored
    observation ``(obs, mission)`` pairs; ``features_fn`` must then be a
    mission trunk (``mission.MissionFeatures``).

    ``small_obs``: the view fast path — ``obs`` (carry and storage) are the
    raw [N, 7, 7, 3] views instead of their ×12 upscale, and
    ``features_fn`` must be the matching view trunk
    (``agent.make_view_features``). A disturbed 84×84 image is no longer a
    tile replication, so it excludes ``disturbance``."""
    fixed = getattr(features_fn, "fixed", None)
    if fixed is not None:
        features_fn = fixed(params)

    def act(obs, next_done, gumbel):
        return agent_mod.get_action_and_value_gumbel(params, obs, gumbel, features_fn, frozen)

    return _collect(act, env, vec_state, obs, next_done, gen, num_steps, disturbance,
                    disturbance_semantics, capture_video, collect_desc, gumbels, disturb_draws,
                    small_obs, env_draws, mission_fn)


def collect_rollout_recurrent(
    params: dict,
    env,
    vec_state,
    obs: torch.Tensor,
    next_done: torch.Tensor,
    lstm_state: tuple[torch.Tensor, torch.Tensor],
    gen: torch.Generator,
    num_steps: int,
    disturbance: Optional[DisturbanceParams] = None,
    disturbance_semantics: str = "batched",
    features_fn: agent_mod.FeatureFn = agent_mod.cnn_features,
    capture_video: bool = False,
    frozen=None,
    gumbels: Optional[torch.Tensor] = None,
    disturb_draws: Optional[Sequence[DisturbanceDraws]] = None,
    small_obs: bool = False,
    env_draws: Optional[Sequence[Any]] = None,
    mission_fn=None,
):
    """:func:`collect_rollout` for the LSTM agent (``models/recurrent.py``):
    each step's trunk features go through the cell, whose (h, c) is zeroed
    where ``next_done`` marks an episode boundary entering the step, and the
    heads read ``concat(features, h)``. Returns (vec_state, obs, next_done,
    lstm_state, RolloutBatch): the carried state after the last step. The
    update replays from the state the rollout started with, which the
    caller keeps. With ``mission_fn`` the FiLM modulates the trunk's
    features before the cell."""
    fixed = getattr(features_fn, "fixed", None)
    if fixed is not None:
        features_fn = fixed(params)
    carry = [lstm_state]

    def act(obs, next_done, gumbel):
        feats = features_fn(params, obs, frozen)
        h, carry[0] = rec.masked_lstm_step(params["lstm"], feats, carry[0], next_done)
        logits, value = agent_mod.heads(params, rec.latent(feats, h))
        action = torch.argmax(logits + gumbel, dim=-1)
        logp, _ = agent_mod.logprob_entropy(logits, action)
        return action, logp, value

    vec_state, obs, next_done, batch = _collect(
        act, env, vec_state, obs, next_done, gen, num_steps, disturbance, disturbance_semantics,
        capture_video, False, gumbels, disturb_draws, small_obs, env_draws, mission_fn)
    return vec_state, obs, next_done, carry[0], batch


def _collect(act, env, vec_state, obs, next_done, gen, num_steps, disturbance,
             disturbance_semantics, capture_video, collect_desc, gumbels, disturb_draws,
             small_obs, env_draws, mission_fn=None):
    """The rollout loop; ``act(obs, next_done, gumbel)`` → (action,
    logprob, value) is the policy's step, ``obs`` the pair (obs, mission)
    with a ``mission_fn``."""
    if small_obs and disturbance is not None:
        raise ValueError("the view fast path cannot apply image-space disturbances")
    device = obs.device
    n = obs.shape[0]
    if gumbels is None:
        gumbels = agent_mod.gumbel_like((num_steps, n, env.num_actions), gen, device)
    prepare = getattr(env, "prepare_resets", None)
    if prepare is not None:  # the rollout's fresh env states, made in bulk
        vec_state = prepare(vec_state, num_steps, gen)
    obs_t = torch.empty((num_steps,) + tuple(obs.shape), dtype=torch.uint8, device=device)
    mission_t = None
    if mission_fn is not None:
        mission_t = torch.empty((num_steps, n, env.mission_dim), dtype=torch.int32, device=device)
    packed = torch.empty((num_steps, n, 8), device=device)
    desc: dict = {}
    video = [] if capture_video else None
    with torch.no_grad():
        for t in range(num_steps):
            if disturbance is not None:
                x = obs.float() / 255.0
                x = disturb_auto(x, disturbance, gen,
                                 None if disturb_draws is None else disturb_draws[t],
                                 disturbance_semantics)
                obs = (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)
            if mission_t is None:
                action, logprob, value = act(obs, next_done, gumbels[t])
            else:
                mission_t[t] = mission_fn(vec_state)
                action, logprob, value = act((obs, mission_t[t]), next_done, gumbels[t])
            if collect_desc:
                for k, v in env.rollout_desc(vec_state).items():
                    desc.setdefault(k, []).append(v)
            if capture_video:
                video.append(env.render_env0(vec_state))
            step_kwargs = {} if env_draws is None else {"draws": env_draws[t]}
            new_state, new_obs, reward, term, trunc, info = env.step_fn(
                vec_state, action, gen, small_obs=small_obs, **step_kwargs)
            obs_t[t] = obs
            packed[t] = torch.stack([
                action.float(), logprob, reward.float(), next_done.float(), value,
                info["done_mask"].float(), info["episode_return"].float(),
                info["episode_length"].float(),
            ], dim=-1)
            vec_state, obs = new_state, new_obs
            next_done = (term | trunc).float()
    desc = {k: torch.stack(v) for k, v in desc.items()}
    batch = RolloutBatch(
        obs=obs_t if mission_t is None else (obs_t, mission_t),
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
