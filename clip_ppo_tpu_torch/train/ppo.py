"""Clipped-PPO update: losses, optimizer and the epoch/minibatch loops.

Port of ``clip_ppo_tpu/train/ppo.py`` (reference `ppo_minigrid.py:298-350`):
ratio clipping, per-minibatch advantage normalization, clipped value loss,
entropy bonus, approx-KL diagnostics, global-norm gradient clipping,
Adam(eps=1e-5), a per-iteration learning rate, and optional target-KL
early stopping at epoch granularity. The LSTM agent's update
(``update_epochs_recurrent``) minibatches over envs and replays each
slice's sequences through the cell.

The optimizer is written out in optax's form, the one the JAX package uses:
``clip_by_global_norm`` scales a gradient by ``max_norm / ‖g‖`` (divide, then
multiply) only when ``‖g‖ >= max_norm`` — not torch's
``max_norm / (‖g‖ + 1e-6)`` — and Adam adds ``eps`` outside the square root
of the bias-corrected second moment. Its state is ``{"mu", "nu", "count"}``.

The CLIP alignment loss (`clip_ppo_minigrid.py:533-559`) joins every 4th
minibatch with its exact gradient topology: the latent is detached, so with
precomputed embeddings (``clip_mode="precomputed"``) it is a pure monitor.
With ``clip_mode="projected"`` (the Atari image modality,
`clip_ppo_atari.py:726-731`) the [mb, 4·512] multi-frame embeddings go
through the trainable ``temporal_projection`` inside the loss, the only
parameters the CLIP gradient reaches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from clip_ppo_tpu_torch.models import agent as agent_mod
from clip_ppo_tpu_torch.models import nature_cnn as cnn
from clip_ppo_tpu_torch.models import recurrent as rec
from clip_ppo_tpu_torch.models.clip_utils import CLIP_LOSS_FREQUENCY, compute_cosine_embedding_loss
from clip_ppo_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-5


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters of the PPO update."""

    learning_rate: float = 2.5e-4
    num_envs: int = 8
    num_steps: int = 128
    anneal_lr: bool = True
    gamma: float = 0.99
    gae_lambda: float = 0.95
    num_minibatches: int = 4
    update_epochs: int = 4
    norm_adv: bool = True
    clip_coef: float = 0.1
    clip_vloss: bool = True
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    target_kl: Optional[float] = None
    # CLIP alignment: "none" | "precomputed" | "projected" (the embeddings
    # through params["temporal_projection"] inside the loss).
    clip_mode: str = "none"

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.num_steps

    @property
    def minibatch_size(self) -> int:
        return self.batch_size // self.num_minibatches


# ---------------------------------------------------------------------------
# Optimizer (optax's clip_by_global_norm → adam → scale by -lr)
# ---------------------------------------------------------------------------


def init_adam_state(params: dict) -> dict:
    zeros = lambda p: torch.zeros_like(p)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum((g * g).sum() for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    return tree_map(lambda g: torch.where(trigger, g, (g / g_norm) * max_norm), grads)


def adam_step(params: dict, grads: dict, state: dict, lr: float, max_grad_norm: float):
    """One optax ``chain(clip_by_global_norm, adam(lr, eps=1e-5))`` step.
    Returns (params, state)."""
    return adam_update(params, clip_by_global_norm(grads, max_grad_norm), state, lr)


def adam_update(params: dict, grads: dict, state: dict, lr: float, eps: float = ADAM_EPS):
    """One optax ``adam(lr, eps=eps)`` step (b1 0.9, b2 0.999) on the
    gradients as given. Returns (params, state)."""
    mu = tree_map(lambda g, m: (1 - ADAM_B1) * g + ADAM_B1 * m, grads, state["mu"])
    nu = tree_map(lambda g, v: (1 - ADAM_B2) * (g * g) + ADAM_B2 * v, grads, state["nu"])
    count = state["count"] + 1
    c = count.float()
    corr1 = 1 - torch.tensor(ADAM_B1, device=c.device) ** c
    corr2 = 1 - torch.tensor(ADAM_B2, device=c.device) ** c
    new_params = tree_map(
        lambda p, m, v: p + (-lr) * ((m / corr1) / (torch.sqrt(v / corr2) + eps)),
        params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "count": count}


def anneal_lr(cfg: PPOConfig, iteration: int, num_iterations: int) -> float:
    """lr = (1 - (it-1)/N) * lr0 in float32, held within an iteration."""
    f32 = np.float32
    frac = f32(1.0) - (f32(iteration) - f32(1.0)) / f32(num_iterations)
    return float(frac * f32(cfg.learning_rate))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def ppo_loss(params: dict, mb: dict, cfg: PPOConfig, features_fn, clip_embeddings,
             clip_lambda_eff: float, use_clip_this_mb: bool, frozen=None):
    """Full minibatch loss; returns (loss, aux dict of 0-d tensors)."""
    newlogprob, entropy, newvalue, hidden = agent_mod.evaluate_actions(
        params, mb["obs"], mb["actions"], features_fn, frozen)
    return _ppo_from_eval(params, mb, cfg, newlogprob, entropy, newvalue, hidden,
                          clip_embeddings, clip_lambda_eff, use_clip_this_mb)


CLIP_MODES = ("none", "precomputed", "projected")


def _ppo_from_eval(params, mb, cfg, newlogprob, entropy, newvalue, hidden,
                   clip_embeddings, clip_lambda_eff, use_clip_this_mb):
    logratio = newlogprob - mb["logprobs"]
    ratio = torch.exp(logratio)
    old_approx_kl = (-logratio).mean()
    approx_kl = ((ratio - 1.0) - logratio).mean()
    clipfrac = ((ratio - 1.0).abs() > cfg.clip_coef).float().mean()

    adv = mb["advantages"]
    if cfg.norm_adv:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg_loss1 = -adv * ratio
    pg_loss2 = -adv * torch.clamp(ratio, 1.0 - cfg.clip_coef, 1.0 + cfg.clip_coef)
    pg_loss = torch.maximum(pg_loss1, pg_loss2).mean()

    if cfg.clip_vloss:
        v_unclipped = (newvalue - mb["returns"]) ** 2
        v_clipped_pred = mb["values"] + torch.clamp(newvalue - mb["values"], -cfg.clip_coef,
                                                    cfg.clip_coef)
        v_clipped = (v_clipped_pred - mb["returns"]) ** 2
        v_loss = 0.5 * torch.maximum(v_unclipped, v_clipped).mean()
    else:
        v_loss = 0.5 * ((newvalue - mb["returns"]) ** 2).mean()

    entropy_loss = entropy.mean()
    loss = pg_loss - cfg.ent_coef * entropy_loss + cfg.vf_coef * v_loss

    clip_loss = torch.zeros((), device=loss.device)
    if cfg.clip_mode not in CLIP_MODES:
        raise ValueError(f"unknown clip_mode {cfg.clip_mode!r} (one of {', '.join(CLIP_MODES)})")
    if cfg.clip_mode != "none":
        if use_clip_this_mb:
            c = clip_embeddings
            if cfg.clip_mode == "projected":
                c = cnn.dense(params["temporal_projection"], c)
            # the latent is detached (`clip_ppo_minigrid.py:269-271`)
            clip_loss = compute_cosine_embedding_loss(hidden.detach(), c)
        loss = loss + clip_lambda_eff * clip_loss

    aux = {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": entropy_loss,
           "old_approx_kl": old_approx_kl, "approx_kl": approx_kl,
           "clipfrac": clipfrac, "clip_loss": clip_loss}
    return loss, aux


# ---------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------


def draw_permutations(cfg: PPOConfig, gen: torch.Generator, device,
                      size: Optional[int] = None) -> torch.Tensor:
    """[update_epochs, size] minibatch shuffles (``size`` defaults to the
    batch size; the recurrent update shuffles the ``num_envs`` envs)."""
    size = cfg.batch_size if size is None else size
    return torch.stack([torch.randperm(size, generator=gen, device=device)
                        for _ in range(cfg.update_epochs)])


def update_epochs(
    params: dict,
    opt_state: dict,
    batch: dict,
    cfg: PPOConfig,
    lr: float,
    features_fn: agent_mod.FeatureFn = agent_mod.cnn_features,
    clip_embeddings: Optional[torch.Tensor] = None,
    clip_lambda_eff: float = 0.0,
    permutations: Optional[torch.Tensor] = None,
    gen: Optional[torch.Generator] = None,
    frozen=None,
) -> tuple[dict, dict, dict]:
    """``update_epochs × num_minibatches`` PPO steps over the flat
    [batch_size, ...] ``batch`` (obs — or the (obs, mission) pair — actions,
    logprobs, advantages, returns, values). ``permutations`` [update_epochs, batch_size] (else
    drawn from ``gen``) shuffle each epoch. Returns (params, opt_state,
    metrics): losses of the LAST minibatch, clipfrac averaged over all
    minibatches, grad_norm of the last, and the first minibatch's losses
    (`ppo_minigrid.py:357-366`, `clip_ppo_minigrid.py:546-552`).

    With a target KL, the epoch that crosses it stops the update: later
    minibatches still compute their losses, and leave the parameters and
    the optimizer state as they were (no host synchronisation).
    """
    if permutations is None:
        permutations = draw_permutations(cfg, gen, batch["actions"].device)
    if clip_embeddings is not None:
        batch = dict(batch, clip_embeddings=clip_embeddings)

    def minibatch(epoch: int, i: int) -> dict:
        # leaf by leaf: the mission-conditioned obs is an (obs, mission) pair
        idx = permutations[epoch][i * cfg.minibatch_size:(i + 1) * cfg.minibatch_size]
        return tree_map(lambda v: v[idx], batch)

    def loss_fn(live_params, mb, mb_counter):
        use_clip = mb_counter % CLIP_LOSS_FREQUENCY == 0
        return ppo_loss(live_params, mb, cfg, features_fn, mb.get("clip_embeddings"),
                        clip_lambda_eff, use_clip, frozen)

    return _run_epochs(params, opt_state, cfg, lr, minibatch, loss_fn)


def recurrent_loss(params: dict, mb: dict, cfg: PPOConfig, features_fn, frozen=None):
    """Minibatch loss of the LSTM agent. ``mb`` holds [T, n, ...]
    sequences of a slice of n envs (obs, actions, logprobs, advantages,
    returns, values, dones) and their iteration-initial cell state h0/c0
    [n, H]. The trunk runs over the whole [T·n] batch at once; only the
    cell replays step by step, with the rollout's done-resets, so at
    unchanged parameters the latents are the rollout's."""
    t, n = mb["actions"].shape
    obs = tree_map(lambda v: v.reshape((t * n,) + tuple(v.shape[2:])), mb["obs"])
    feats = features_fn(params, obs, frozen)
    hs, _ = rec.unroll(params["lstm"], feats.reshape(t, n, -1), mb["dones"], (mb["h0"], mb["c0"]))
    latents = rec.latent(feats.reshape(t, n, -1), hs)
    logits, newvalue = agent_mod.heads(params, latents)
    newlogprob, entropy = agent_mod.logprob_entropy(logits, mb["actions"])
    return _ppo_from_eval(params, mb, cfg, newlogprob, entropy, newvalue, latents,
                          None, 0.0, False)


def update_epochs_recurrent(
    params: dict,
    opt_state: dict,
    batch: dict,
    initial_lstm_state: tuple[torch.Tensor, torch.Tensor],
    cfg: PPOConfig,
    lr: float,
    features_fn: agent_mod.FeatureFn = agent_mod.cnn_features,
    permutations: Optional[torch.Tensor] = None,
    gen: Optional[torch.Generator] = None,
    frozen=None,
) -> tuple[dict, dict, dict]:
    """PPO epochs of the LSTM agent: the minibatches are slices of envs
    (CleanRL ``ppo_atari_lstm``), so each replays its envs' whole [T]
    sequences from the iteration's initial (h, c). ``batch`` stays in
    rollout layout [T, N, ...] and holds ``dones``; ``permutations``
    [update_epochs, num_envs] (else drawn from ``gen``) shuffle the envs.
    Returns what :func:`update_epochs` returns."""
    if cfg.num_envs % cfg.num_minibatches:
        raise ValueError(f"recurrent PPO minibatches over envs: num_envs={cfg.num_envs} not "
                         f"divisible by num_minibatches={cfg.num_minibatches}")
    epm = cfg.num_envs // cfg.num_minibatches
    if permutations is None:
        permutations = draw_permutations(cfg, gen, batch["actions"].device, cfg.num_envs)
    h0, c0 = initial_lstm_state

    def minibatch(epoch: int, i: int) -> dict:
        idx = permutations[epoch][i * epm:(i + 1) * epm]
        mb = tree_map(lambda v: v[:, idx], batch)
        mb["h0"], mb["c0"] = h0[idx], c0[idx]
        return mb

    def loss_fn(live_params, mb, mb_counter):
        return recurrent_loss(live_params, mb, cfg, features_fn, frozen)

    return _run_epochs(params, opt_state, cfg, lr, minibatch, loss_fn)


def _run_epochs(params: dict, opt_state: dict, cfg: PPOConfig, lr: float, minibatch, loss_fn):
    """The epoch and minibatch loops: ``minibatch(epoch, i)`` gives a
    minibatch, ``loss_fn(params, mb, counter)`` its (loss, aux)."""
    leaves = tree_leaves(params)
    stop = torch.zeros((), dtype=torch.bool, device=leaves[0].device)
    mb_counter = 0
    auxes = []
    for epoch in range(cfg.update_epochs):
        for i in range(cfg.num_minibatches):
            mb = minibatch(epoch, i)
            live = [p.detach().requires_grad_(True) for p in leaves]
            live_params = tree_unflatten(params, live)
            with torch.enable_grad():
                loss, aux = loss_fn(live_params, mb, mb_counter)
                # A parameter the loss does not reach (the conv trunk under
                # FROZEN_CLIP) gets a zero gradient, as jax.grad gives it;
                # Adam then leaves it and its moments at rest.
                grads = torch.autograd.grad(loss, live, allow_unused=True,
                                            materialize_grads=True)
            aux = {k: v.detach() for k, v in aux.items()}
            grads_tree = tree_unflatten(params, list(grads))
            aux["grad_norm"] = global_norm(grads_tree)
            with torch.no_grad():
                new_params, new_state = adam_step(params, grads_tree, opt_state, lr,
                                                  cfg.max_grad_norm)
                if cfg.target_kl is not None:
                    keep = lambda new, old: torch.where(stop, old, new)  # noqa: E731
                    new_params = tree_map(keep, new_params, params)
                    new_state = tree_map(keep, new_state, opt_state)
            params, opt_state = new_params, new_state
            leaves = tree_leaves(params)
            auxes.append(aux)
            mb_counter += 1
        if cfg.target_kl is not None:
            # the last minibatch's approx_kl per epoch (`ppo_minigrid.py:349-350`)
            stop = stop | (auxes[-1]["approx_kl"] > cfg.target_kl)

    last, first = auxes[-1], auxes[0]
    metrics = {
        "pg_loss": last["pg_loss"], "v_loss": last["v_loss"], "entropy": last["entropy"],
        "old_approx_kl": last["old_approx_kl"], "approx_kl": last["approx_kl"],
        "clipfrac": torch.stack([a["clipfrac"] for a in auxes]).mean(),
        "clip_loss": last["clip_loss"], "grad_norm": last["grad_norm"],
        "first_pg_loss": first["pg_loss"], "first_v_loss": first["v_loss"],
        "first_entropy": first["entropy"], "first_clip_loss": first["clip_loss"],
    }
    return params, opt_state, metrics


def explained_variance(values: torch.Tensor, returns: torch.Tensor) -> torch.Tensor:
    """1 - Var[y - pred]/Var[y], NaN when Var[y]==0 (`ppo_minigrid.py:352-354`)."""
    var_y = returns.var(correction=0)
    ev = 1.0 - (returns - values).var(correction=0) / var_y
    return torch.where(var_y == 0, torch.full_like(ev, float("nan")), ev)
