"""Generalized Advantage Estimation (`ppo_minigrid.py:275-288`):

    delta_t = r_t + gamma * V_{t+1} * nonterminal_{t+1} - V_t
    A_t     = delta_t + gamma * lambda * nonterminal_{t+1} * A_{t+1}

A reverse loop over the T steps; each step is one [N]-wide update on the
device and none waits for the host.
"""

from __future__ import annotations

import torch


def compute_gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
                next_value: torch.Tensor, next_done: torch.Tensor,
                gamma: float, gae_lambda: float) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, N] rewards/values/dones (done flag entering step t), [N]
    bootstrap value and done → (advantages [T, N], returns [T, N])."""
    next_nonterminal = torch.cat([1.0 - dones[1:].float(), (1.0 - next_done.float())[None]])
    next_values = torch.cat([values[1:], next_value[None]])
    deltas = rewards + gamma * next_values * next_nonterminal - values
    advantages = torch.empty_like(deltas)
    last = torch.zeros_like(deltas[0])
    for t in reversed(range(rewards.shape[0])):
        last = deltas[t] + gamma * gae_lambda * next_nonterminal[t] * last
        advantages[t] = last
    return advantages, advantages + values
