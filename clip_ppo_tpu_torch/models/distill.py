"""Structured frozen-tower initialization by pixel-PCA distillation.

Port of ``clip_ppo_tpu/models/distill.py``. The reference's FROZEN_CLIP
ablation swaps the agent trunk for a *pretrained* ``clip.visual``
(`clip_ppo_minigrid.py:219-227`). Without pretrained weights a randomly
initialized ViT makes frozen features that barely separate states, and the
ablation's actor and critic heads cannot learn. This module distills the
CLIP visual tower, on the device, to reproduce a pixel-PCA teacher computed
from random-policy observations: PCA features are linear in the image, so
they keep the state information that varies across observations (agent
position and direction, door and key layout), and after a few hundred Adam
steps the frozen ViT carries it to the linear heads. The tower stays frozen
during PPO; only its initialization is structured.

The distillation differentiates through the tower as the JAX package does:
``encode_image(..., attention_impl="xla")`` in bf16 on float32 leaves that
require grad, each weight cast to bf16 inside the graph, so the plain
attention and MLP run and autograd gives the backward (no kernel is on this
route). Every random input is explicit and optional: the random policy's
actions and the minibatch indices, drawn from a ``torch.Generator`` unless
given, so a test can hand over the JAX package's own draws.
"""

from __future__ import annotations

import torch

from clip_ppo_tpu_torch.models.clip import model as clip_model_mod
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig
from clip_ppo_tpu_torch.ops.resize import preprocess_for_clip
from clip_ppo_tpu_torch.train.ppo import adam_update, init_adam_state
from clip_ppo_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

ADAM_EPS = 1e-8  # optax.adam's default


def _downsampled(obs_uint8: torch.Tensor, downsample: int) -> torch.Tensor:
    x = obs_uint8[:, ::downsample, ::downsample].float() / 255.0
    return x.reshape(x.shape[0], -1)


def pca_features(stats: dict, obs_uint8: torch.Tensor, downsample: int = 2) -> torch.Tensor:
    """[B, out_dim] whitened PCA features of ``obs_uint8`` under ``stats``."""
    y = _downsampled(obs_uint8, downsample) - stats["mean"]
    return (y @ stats["components"].T) / (stats["scale"] + 1e-6)


def pixel_pca_teacher(obs_uint8: torch.Tensor, out_dim: int, downsample: int = 2):
    """A pixel-PCA feature teacher from sample observations.

    Args:
        obs_uint8: [N, H, W, C] uint8 sample observations.
        out_dim: number of principal components (the frozen feature width).
        downsample: spatial stride before flattening (keeps the SVD cheap
            without losing the low-frequency structure PCA captures).

    Returns ``(teacher_fn, stats)``: ``teacher_fn(obs_uint8) -> [B,
    out_dim]`` whitened PCA features, and the PCA statistics ``mean``,
    ``components`` (rows: principal directions) and ``scale`` (per-component
    std). A component's sign is the SVD's choice, as in the JAX package.
    """
    flat = _downsampled(obs_uint8, downsample)
    n = flat.shape[0]
    mean = flat.mean(dim=0)
    _, s, vt = torch.linalg.svd(flat - mean, full_matrices=False)
    k = min(out_dim, vt.shape[0])
    components = vt[:k]
    scale = s[:k] / torch.sqrt(torch.tensor(float(n), device=s.device))
    if k < out_dim:  # fewer samples than components
        components = torch.nn.functional.pad(components, (0, 0, 0, out_dim - k))
        scale = torch.nn.functional.pad(scale, (0, out_dim - k), value=1.0)
    stats = {"mean": mean, "components": components, "scale": scale}
    return (lambda obs: pca_features(stats, obs, downsample)), stats


def student_loss(clip_params: dict, cfg: CLIPConfig, obs_uint8: torch.Tensor,
                 targets: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16
                 ) -> torch.Tensor:
    """The distillation's loss: the mean squared error of the vision tower's
    features of ``obs_uint8`` (/255 → resize → CLIP normalization, the
    tower in ``compute_dtype`` on the plain ``"xla"`` route) against
    ``targets``."""
    x = preprocess_for_clip(obs_uint8.float() / 255.0, cfg.image_size)
    feats = clip_model_mod.encode_image(clip_params, cfg, x, compute_dtype, attention_impl="xla")
    return torch.mean((feats - targets) ** 2)


def distill_visual_tower(
    gen: torch.Generator | None,
    clip_params: dict,
    cfg: CLIPConfig,
    obs_uint8: torch.Tensor,
    steps: int = 300,
    batch_size: int = 64,
    learning_rate: float = 1e-3,
    compute_dtype: torch.dtype = torch.bfloat16,
    indices: torch.Tensor | None = None,
    stats: dict | None = None,
) -> tuple[dict, torch.Tensor]:
    """Distill ``clip_params['visual']`` toward the pixel-PCA teacher with
    ``steps`` Adam steps (optax's ``adam(learning_rate)``) on minibatches of
    ``batch_size`` observations.

    ``indices`` ([steps, batch_size] ints into ``obs_uint8``) are drawn from
    ``gen`` unless given; ``stats`` (the teacher's PCA statistics) are
    computed from ``obs_uint8`` unless given. Returns the new params (the
    text tower untouched, shared) and the [steps] float32 losses. The student
    sees observations through the preprocessing of the frozen-feature path
    (/255 → 224 resize → CLIP normalization), so the PPO-time features match
    what was distilled.
    """
    if stats is None:
        _, stats = pixel_pca_teacher(obs_uint8, cfg.embed_dim)
    targets = pca_features(stats, obs_uint8)  # [N, embed_dim]
    n = obs_uint8.shape[0]
    batch_size = min(batch_size, n)
    if indices is None:
        indices = torch.randint(0, n, (steps, batch_size), generator=gen, device=obs_uint8.device)
    indices = indices.to(obs_uint8.device)

    visual = tree_map(lambda t: t.detach().float().requires_grad_(True), clip_params["visual"])
    opt_state = init_adam_state(visual)
    losses = []
    for s in range(steps):
        idx = indices[s]
        with torch.enable_grad():
            loss = student_loss({**clip_params, "visual": visual}, cfg, obs_uint8[idx],
                                targets[idx], compute_dtype)
            leaves = tree_leaves(visual)
            grads = tree_unflatten(visual, list(torch.autograd.grad(loss, leaves)))
        with torch.no_grad():
            visual, opt_state = adam_update(visual, grads, opt_state, learning_rate, ADAM_EPS)
        visual = tree_map(lambda t: t.requires_grad_(True), visual)
        losses.append(loss.detach())
    losses = torch.stack(losses).float()
    print(f"Distilled frozen tower: MSE {float(losses[0]):.4f} → "
          f"{float(losses[-1]):.4f} over {steps} steps")
    return {**clip_params, "visual": tree_map(lambda t: t.detach(), visual)}, losses


def collect_random_observations(env, gen: torch.Generator | None, num_steps: int = 64,
                                actions: torch.Tensor | None = None,
                                start=None) -> torch.Tensor:
    """Roll a uniform-random policy in a :class:`TorchVectorEnv` and return
    the stacked [num_steps·N, H, W, C] uint8 observations, each step's before
    its action. ``actions`` ([num_steps, N]) are drawn from ``gen`` unless
    given; ``start`` = (VecState, obs) replaces the reset; the autoresets
    draw from ``gen``."""
    vec_state, obs = env.reset_fn(gen) if start is None else start
    if actions is None:
        actions = torch.randint(0, env.num_actions, (num_steps, env.num_envs), generator=gen,
                                device=env.device)
    frames = []
    for t in range(num_steps):
        frames.append(obs)
        vec_state, obs, *_ = env.step_fn(vec_state, actions[t].to(env.device), gen)
    return torch.stack(frames).reshape((-1,) + tuple(obs.shape[1:]))
