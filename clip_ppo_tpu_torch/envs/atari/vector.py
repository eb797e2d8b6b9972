"""Batched on-device Atari vector env: frame stack, episodic life, stats.

Port of ``clip_ppo_tpu/envs/atari/vector.py``, the counterpart of
:class:`clip_ppo_tpu_torch.envs.vector.TorchVectorEnv` for the native
games, folding the reference's wrapper stack (`clip_ppo_atari.py:149-168`)
into batched tensor ops:

* a 4-frame grayscale stack kept in the vector state
  (``FrameStackObservation``), NHWC ``[N, 84, 84, 4]`` uint8 — the newest
  frame is channel 3, the oldest channel 0;
* reward clipping to sign() for training (``ClipRewardEnv``), raw scores
  accumulated separately;
* EpisodicLife: ``terminated`` surfaces on a life loss so GAE bootstraps
  correctly, but a game resets only at game over, and its stack restarts
  from the fresh game's first frame;
* episode statistics as ``RecordEpisodeStatistics`` *below* the wrapper
  stack records them: the raw return of a whole game, its length counted
  in inner steps (4 per agent step, MaxAndSkip's inner loop).

A step's draws are an optional input of :meth:`AtariVectorEnv.step_fn`
(see ``core.step``), drawn from the generator otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from clip_ppo_tpu_torch.envs.atari import core


@dataclasses.dataclass
class AtariVecState:
    env: Any                      # batched game state, leading axis = num_envs
    frames: torch.Tensor          # [N, 84, 84, 4] uint8 stack
    episode_return: torch.Tensor  # [N] f32 raw-score return (whole game)
    episode_length: torch.Tensor  # [N] i32 inner steps (4 per agent step)


class AtariVectorEnv:
    """Vectorized native Atari games (Breakout | Pong | Seaquest) on
    ``device``, with the functional API the Trainer drives:
    ``reset_fn`` / ``step_fn`` over :class:`AtariVecState`."""

    def __init__(self, env_id: str, num_envs: int, device):
        self.env_id = env_id
        self.num_envs = num_envs
        self.device = torch.device(device)
        self.params = core.parse_atari_id(env_id)
        self.num_actions = self.params.num_actions
        self.obs_size = core.OBS_SIZE
        # A reset draws nothing, so every autoreset selects from this one
        # fresh batch (no step writes into a state's tensors).
        self._fresh = core.reset(self.params, num_envs, self.device)

    # -- functional API ------------------------------------------------------

    def reset_fn(self, gen: torch.Generator = None) -> tuple[AtariVecState, torch.Tensor]:
        """Fresh games and their stacks (``gen`` is unused: a reset draws
        nothing; it is taken for the Trainer's env interface)."""
        del gen
        env = self._fresh
        frames = core.render(self.params, env)[..., None].repeat(1, 1, 1, 4)  # FrameStack reset
        state = AtariVecState(
            env=env, frames=frames,
            episode_return=torch.zeros(self.num_envs, device=self.device),
            episode_length=torch.zeros(self.num_envs, dtype=torch.int32, device=self.device),
        )
        return state, frames

    def step_fn(self, state: AtariVecState, actions: torch.Tensor, gen: torch.Generator = None,
                small_obs: bool = False, draws=None):
        """Returns (state, obs, reward, terminated, truncated, info) with
        ``info`` holding done_mask (game over) / episode_return /
        episode_length. ``draws`` (``core.draw``) default to draws from
        ``gen``."""
        if small_obs:
            raise ValueError("Atari observations have no view fast path")
        env, raw_reward, episodic_done, game_over = core.step(
            self.params, state.env, actions, draws, gen)
        ep_return = state.episode_return + raw_reward
        ep_length = state.episode_length + core.SUBSTEPS

        # True reset only at game over (EpisodicLife).
        env = core.select(game_over, self._fresh, env)
        frame = core.render(self.params, env)[..., None]
        frames = torch.cat([state.frames[..., 1:], frame], dim=-1)
        # Fresh games restart the stack from their first frame.
        frames = torch.where(game_over.reshape(-1, 1, 1, 1), frame.expand_as(frames), frames)

        zero_f = torch.zeros_like(ep_return)
        zero_i = torch.zeros_like(ep_length)
        new_state = AtariVecState(
            env=env, frames=frames,
            episode_return=torch.where(game_over, zero_f, ep_return),
            episode_length=torch.where(game_over, zero_i, ep_length),
        )
        info = {
            "done_mask": game_over,
            "episode_return": torch.where(game_over, ep_return, zero_f),
            "episode_length": torch.where(game_over, ep_length, zero_i),
        }
        return (new_state, frames, torch.sign(raw_reward), episodic_done,
                torch.zeros_like(episodic_done), info)

    def render_env0(self, state: AtariVecState) -> torch.Tensor:
        """RGB render of env 0 for video capture: the newest stacked frame
        broadcast to RGB ([84, 84, 3] uint8)."""
        return state.frames[0, :, :, -1:].expand(core.OBS_SIZE, core.OBS_SIZE, 3)

    def rollout_desc(self, state: AtariVecState) -> dict:
        """Atari descriptions are generated once per iteration from the
        current state (`clip_ppo_atari.py:648` cycles the live envs), so
        the rollout records no per-step snapshot."""
        del state
        return {}

    def describe(self, state: AtariVecState) -> list[str]:
        """Per-env text of the games' current state (host strings)."""
        return core.describe_states(self.params, state.env)
