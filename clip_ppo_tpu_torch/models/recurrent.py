"""LSTM policy trunk for recurrent PPO (``--recurrent``).

Port of ``clip_ppo_tpu/models/recurrent.py``. The reference's agents are all
feed-forward CNNs (`ppo_minigrid.py:128-162`), which cannot solve the
MiniGrid Memory family: the cue leaves the 7×7 view while the agent walks
the hallway, so a memoryless policy sits at the guess rate. ``--recurrent``
puts an LSTM between the feature trunk and the actor/critic heads, as
CleanRL's ``ppo_atari_lstm`` does: the hidden state is carried across env
steps on the device, zeroed where an episode ended, and the update replays
each minibatch's sequences from the iteration's initial state.

The heads read ``concat(trunk_features, lstm_hidden)`` rather than the LSTM
output alone, as the JAX package's agent does: the skip keeps reactive
learning at feed-forward speed while the cell carries what left the view.

The cell is plain PyTorch (``torch.matmul`` and pointwise ops): the JAX
package computes it outside any Pallas kernel. The gate order is i, f, g, o,
as ``torch.nn.LSTMCell`` uses; the weights are stored input-major (``w_ih``
[in, 4H], ``w_hh`` [H, 4H]) for ``x @ w``, with one bias ``b``, torch's
``b_ih + b_hh``. Init is CleanRL's: orthogonal gain-1 weights, zero bias.

In eager PyTorch each cell step is its own handful of kernel launches, so
the update's replay launches them once per time step of every minibatch,
forward and backward (the JAX package runs the replay as one ``lax.scan``).
"""

from __future__ import annotations

import torch

from clip_ppo_tpu_torch.models import mission as mission_mod
from clip_ppo_tpu_torch.models import nature_cnn as cnn

HC = tuple[torch.Tensor, torch.Tensor]


def init_lstm(gen: torch.Generator, input_dim: int, hidden_dim: int, device) -> dict:
    """Orthogonal(1.0) input and recurrent weights, zero bias."""
    return {
        "w_ih": cnn._orthogonal(gen, input_dim, 4 * hidden_dim, 1.0, device),
        "w_hh": cnn._orthogonal(gen, hidden_dim, 4 * hidden_dim, 1.0, device),
        "b": torch.zeros(4 * hidden_dim, device=device),
    }


def lstm_step(p: dict, x: torch.Tensor, hc: HC) -> tuple[torch.Tensor, HC]:
    """One cell step: x [B, in], hc ([B, H], [B, H]) → (h', (h', c')).
    Sigmoid on i, f, o, tanh on g; c' = f⊙c + i⊙g, h' = o⊙tanh(c')."""
    h, c = hc
    gates = x @ p["w_ih"] + h @ p["w_hh"] + p["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, (h2, c2)


def masked_lstm_step(p: dict, x: torch.Tensor, hc: HC, done: torch.Tensor
                     ) -> tuple[torch.Tensor, HC]:
    """A cell step with h and c zeroed where ``done`` (f32 [B]) marks an
    episode boundary entering this step (CleanRL's ``(1 - done)``)."""
    mask = (1.0 - done)[:, None]
    h, c = hc
    return lstm_step(p, x, (h * mask, c * mask))


def latent(feats: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The heads' input: trunk features ⊕ LSTM hidden."""
    return torch.cat([feats, h], dim=-1)


def init_zero_state(num_envs: int, hidden_dim: int, device) -> HC:
    return (torch.zeros((num_envs, hidden_dim), device=device),
            torch.zeros((num_envs, hidden_dim), device=device))


def init_agent_params_recurrent(gen: torch.Generator, num_actions: int, device,
                                in_channels: int = 3, hidden: int = 512,
                                lstm_hidden: int = 128, mission_dim: int = 0) -> dict:
    """Nature-CNN trunk → LSTM(hidden → lstm_hidden); the heads read
    ``concat(trunk, h)``, scaled as the reference's ``layer_init``: 0.01
    actor, 1.0 critic. ``mission_dim > 0`` adds the FiLM mission head
    (``models/mission.py``), which modulates the trunk's features before
    the cell. ``gen`` is a CPU generator."""
    head_in = hidden + lstm_hidden
    params = {
        "trunk": cnn.init_nature_cnn(gen, in_channels, device, hidden),
        "lstm": init_lstm(gen, hidden, lstm_hidden, device),
        "actor": cnn.init_dense(gen, head_in, num_actions, device, scale=0.01),
        "critic": cnn.init_dense(gen, head_in, 1, device, scale=1.0),
    }
    if mission_dim > 0:
        params["mission"] = mission_mod.init_mission_params(gen, device, mission_dim,
                                                            hidden=hidden)
    return params


def unroll(p_lstm: dict, x: torch.Tensor, dones: torch.Tensor, hc0: HC
           ) -> tuple[torch.Tensor, HC]:
    """Replay the cell over a [T, B, in] feature sequence with the
    episode-boundary resets of ``dones`` (f32 [T, B], the flag entering each
    step, as the rollout stores it). Returns (hidden states [T, B, H], final
    (h, c))."""
    hc, hs = hc0, []
    for t in range(x.shape[0]):
        h, hc = masked_lstm_step(p_lstm, x[t], hc, dones[t])
        hs.append(h)
    return torch.stack(hs), hc
