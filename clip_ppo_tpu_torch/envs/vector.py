"""Batched on-device vector environments with same-step autoreset.

Port of ``clip_ppo_tpu/envs/vector.py``'s ``JaxVectorEnv``. The whole batch
is a :class:`VecState` of tensors on one device, and ``reset_fn`` /
``step_fn`` are batched functions of it, so the rollout never copies an
observation to the host.

Autoreset is *same-step*: the post-done observation is the next episode's
first observation, and the final return/length surface through the info
tensors (RecordEpisodeStatistics semantics). A fresh state is ready for
every env on every step and selected where an episode ended, so the step
never asks the host whether any episode ended. The rollout makes them in
bulk: :meth:`TorchVectorEnv.prepare_resets` resets T·N envs in one batched
call before a rollout of T steps, and step t takes its N fresh states from
that bank by a view. A reset costs the same launches at any batch size, so
the layouts whose generators run many launches (MultiRoom's trials,
KeyCorridor's connect loop) cost them once a rollout and not once a step.
A step of a state with no bank draws its N fresh states itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from clip_ppo_tpu_torch.envs.minigrid import core as minigrid_core
from clip_ppo_tpu_torch.models import mission as mission_mod
from clip_ppo_tpu_torch.ops.resize import upscale_nearest


@dataclasses.dataclass
class VecState:
    """Batched env state plus episode-statistics accumulators."""

    env: minigrid_core.EnvState
    episode_return: torch.Tensor  # [N] float32 running return
    episode_length: torch.Tensor  # [N] int32 running length
    # Fresh states for the steps ahead (:meth:`TorchVectorEnv.prepare_resets`):
    # [K·N] states, step k of the K taking envs k·N .. (k+1)·N; None once used.
    reset_bank: Optional[minigrid_core.EnvState] = None
    reset_step: int = 0


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

    def prepare_resets(self, state: VecState, num_steps: int, gen: torch.Generator) -> VecState:
        """``state`` with a bank of fresh states for its next ``num_steps``
        steps, made by one batched reset of num_steps·N envs."""
        bank = minigrid_core.reset(self.params, num_steps * self.num_envs, gen, self.device)
        return dataclasses.replace(state, reset_bank=bank, reset_step=0)

    def _fresh(self, state: VecState, gen: torch.Generator):
        """This step's N fresh states and the bank left for the next."""
        bank, n = state.reset_bank, self.num_envs
        if bank is None:
            return minigrid_core.reset(self.params, n, gen, self.device), None
        k = state.reset_step
        fresh = minigrid_core.take(bank, k * n, (k + 1) * n)
        return fresh, (bank if (k + 2) * n <= bank.grid.shape[0] else None)

    def step_fn(self, state: VecState, actions: torch.Tensor, gen: torch.Generator,
                small_obs: bool = False, draws: Optional[torch.Tensor] = None):
        """Returns (state, obs, reward, terminated, truncated, info) with
        ``info`` holding done_mask / episode_return / episode_length; with
        ``small_obs`` the obs are the raw [N, 7, 7, 3] views. Dynamic-Obstacles
        moves its balls by ``draws``, the step's [N, n_obstacles, 9] Gumbel
        noise (``minigrid_core.obstacle_gumbels``), drawn from ``gen`` when
        not given."""
        env, reward, terminated, truncated = minigrid_core.step(
            self.params, state.env, actions, gumbels=draws, gen=gen)
        done = terminated | truncated
        ep_return = state.episode_return + reward
        ep_length = state.episode_length + 1
        fresh, bank = self._fresh(state, gen)
        env = minigrid_core.select(done, fresh, env)
        zero_f = torch.zeros_like(ep_return)
        zero_i = torch.zeros_like(ep_length)
        new_state = VecState(
            env=env,
            episode_return=torch.where(done, zero_f, ep_return),
            episode_length=torch.where(done, zero_i, ep_length),
            reset_bank=bank,
            reset_step=state.reset_step + 1 if bank is not None else 0,
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

    # -- mission conditioning (models/mission.py) -----------------------------

    @property
    def mission_dim(self) -> int:
        """Width of the per-env structured instruction vector."""
        return mission_mod.MISSION_DIM

    def mission_fn(self, state: VecState) -> torch.Tensor:
        """[N, mission_dim] int32 structured instruction of the current
        state: the mission ``target``, the composite-instruction slots
        ``instr`` and the verifier's per-slot ``instr_state``, flattened and
        joined (the JAX package's ``mission_fn``)."""
        e = state.env
        n = e.target.shape[0]
        return torch.cat([e.target, e.instr.reshape(n, -1), e.instr_state.reshape(n, -1)],
                         dim=-1).to(torch.int32)

    def rollout_desc(self, state: VecState) -> dict:
        """Per-step state snapshot the rollout records for text
        descriptions (`clip_ppo_minigrid.py:393-403`)."""
        return {"agent_pos": state.env.agent_pos, "agent_dir": state.env.agent_dir}
