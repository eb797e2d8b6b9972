"""Batched on-device vector environments with same-step autoreset.

Port of ``clip_ppo_tpu/envs/vector.py``'s ``JaxVectorEnv``. The whole batch
is a :class:`VecState` of tensors on one device, and ``reset_fn`` /
``step_fn`` are batched functions of it, so the rollout never copies an
observation to the host.

Autoreset is *same-step*: the post-done observation is the next episode's
first observation, and the final return/length surface through the info
tensors (RecordEpisodeStatistics semantics). Fresh states are drawn for
every env on every step and selected where an episode ended, so the step
never asks the host whether any episode ended.
"""

from __future__ import annotations

import dataclasses

import torch

from clip_ppo_tpu_torch.envs.minigrid import core as minigrid_core
from clip_ppo_tpu_torch.ops.resize import upscale_nearest


@dataclasses.dataclass
class VecState:
    """Batched env state plus episode-statistics accumulators."""

    env: minigrid_core.EnvState
    episode_return: torch.Tensor  # [N] float32 running return
    episode_length: torch.Tensor  # [N] int32 running length


class TorchVectorEnv:
    """Vectorized MiniGrid environments on ``device``: ``reset_fn`` /
    ``step_fn`` / ``observe_fn`` over :class:`VecState`, with random draws
    from an explicit generator. (The JAX package's numpy host API comes
    with the host/gym slice.)"""

    def __init__(self, env_id: str, num_envs: int, device, obs_size: int = 84):
        self.env_id = env_id
        self.num_envs = num_envs
        self.device = torch.device(device)
        self.params = minigrid_core.parse_env_id(env_id)
        if obs_size % minigrid_core.VIEW_SIZE != 0:
            raise ValueError("obs_size must be a multiple of the 7-cell view")
        self.obs_size = obs_size
        self._upscale = obs_size // minigrid_core.VIEW_SIZE
        self.num_actions = self.params.num_actions

    # -- functional API ------------------------------------------------------

    def observe_fn(self, state: VecState) -> torch.Tensor:
        """[N, obs, obs, 3] uint8: nearest ×12 upscale of the 7×7 view
        (gymnasium ResizeObservation INTER_AREA at integer zoom)."""
        return upscale_nearest(self.observe_view_fn(state), self._upscale)

    def observe_view_fn(self, state: VecState) -> torch.Tensor:
        """[N, 7, 7, 3] uint8 raw symbolic views, the pre-upscale form of
        :meth:`observe_fn` (the Trainer's view fast path consumes it)."""
        return minigrid_core.observe(self.params, state.env)

    @property
    def supports_view_obs(self) -> bool:
        """True when observations are exact integer nearest-upscales of the view."""
        return self.obs_size % minigrid_core.VIEW_SIZE == 0

    @property
    def view_upscale(self) -> int:
        return self._upscale

    def reset_fn(self, gen: torch.Generator) -> tuple[VecState, torch.Tensor]:
        env = minigrid_core.reset(self.params, self.num_envs, gen, self.device)
        state = VecState(
            env=env,
            episode_return=torch.zeros(self.num_envs, device=self.device),
            episode_length=torch.zeros(self.num_envs, dtype=torch.int32, device=self.device),
        )
        return state, self.observe_fn(state)

    def step_fn(self, state: VecState, actions: torch.Tensor, gen: torch.Generator,
                small_obs: bool = False):
        """Returns (state, obs, reward, terminated, truncated, info) with
        ``info`` holding done_mask / episode_return / episode_length; with
        ``small_obs`` the obs are the raw [N, 7, 7, 3] views."""
        env, reward, terminated, truncated = minigrid_core.step(self.params, state.env, actions)
        done = terminated | truncated
        ep_return = state.episode_return + reward
        ep_length = state.episode_length + 1
        fresh = minigrid_core.reset(self.params, self.num_envs, gen, self.device)
        env = minigrid_core.select(done, fresh, env)
        zero_f = torch.zeros_like(ep_return)
        zero_i = torch.zeros_like(ep_length)
        new_state = VecState(
            env=env,
            episode_return=torch.where(done, zero_f, ep_return),
            episode_length=torch.where(done, zero_i, ep_length),
        )
        info = {
            "done_mask": done,
            "episode_return": torch.where(done, ep_return, zero_f),
            "episode_length": torch.where(done, ep_length, zero_i),
        }
        obs = self.observe_view_fn(new_state) if small_obs else self.observe_fn(new_state)
        return new_state, obs, reward, terminated, truncated, info

    def render_env0(self, state: VecState) -> torch.Tensor:
        """RGB render of env 0 for video capture ([H, W, 3] uint8)."""
        e = state.env
        return minigrid_core.render_rgb(self.params, e.grid[0], e.agent_pos[0], e.agent_dir[0])

    def rollout_desc(self, state: VecState) -> dict:
        """Per-step state snapshot the rollout records for text
        descriptions (`clip_ppo_minigrid.py:393-403`)."""
        return {"agent_pos": state.env.agent_pos, "agent_dir": state.env.agent_dir}
