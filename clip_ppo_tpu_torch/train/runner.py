"""Training runner: rollout → GAE → PPO update per iteration, on one device.

Port of ``clip_ppo_tpu/train/runner.py``'s ``Trainer`` for the paths the
port runs: the feed-forward agent or the LSTM agent (``recurrent``,
vanilla PPO only) with the Nature-CNN trunk (on the raw
7×7 views when nothing needs the 84×84 image, the view fast path) or with
the frozen CLIP vision tower as its trunk (FROZEN_CLIP, a ``features_fn``
reading ``frozen["clip"]``), optional batched or per-image disturbances, the
FiLM mission conditioning over any of those trunks (``mission_conditioning``), the
text modality through a precomputed description-embedding table
(``embed_desc_fn``), the image modality, which encodes the iteration's
stored observations with the CLIP vision tower (``embed_images_fn``), and
RANDOM_ENCODER's fresh Gaussian embeddings each iteration
(``embed_random_fn``). Nothing in an iteration waits for the host;
logs are packed on the device and fetched one chunk behind
(:class:`LogPipeline`), so the fetch of chunk *k* overlaps the queued work
of chunk *k+1*. The text modalities that describe states on the host —
Atari's live games, and MiniGrid where the description table does not
apply (a suffix that varies across episodes, as MultiRoom's, or
``--no-text-embed-table``) — encode the descriptions between the rollout
and the update: they run the split path (:meth:`Trainer.run_rollout_half`,
:meth:`Trainer.run_update_half`, :meth:`Trainer.fetch_logs`), one iteration
at a time.

Every random draw comes from the ``torch.Generator`` in the
:class:`TrainState`, unless the caller passes them to :meth:`Trainer.iteration`
as a :class:`Draws` (the parity tests feed both packages the same ones).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from clip_ppo_tpu_torch.models import agent as agent_mod
from clip_ppo_tpu_torch.models import mission as mission_mod
from clip_ppo_tpu_torch.models import nature_cnn as cnn
from clip_ppo_tpu_torch.models import recurrent as rec
from clip_ppo_tpu_torch.models.clip_utils import get_clip_lambda_with_warmup
from clip_ppo_tpu_torch.ops.disturbances import DisturbanceDraws, check_semantics
from clip_ppo_tpu_torch.ops.severity import DisturbanceParams
from clip_ppo_tpu_torch.train import gae as gae_mod
from clip_ppo_tpu_torch.train import ppo as ppo_mod
from clip_ppo_tpu_torch.train import rollout as rollout_mod
from clip_ppo_tpu_torch.utils.tree import tree_map

# The fixed, sorted set of per-iteration log scalars (packing order).
SCALAR_KEYS = (
    "approx_kl", "clip_loss", "clipfrac", "entropy", "explained_variance",
    "first_clip_loss", "first_entropy", "first_pg_loss", "first_v_loss",
    "intrinsic_reward", "learning_rate", "old_approx_kl", "policy_loss",
    "value_loss",
)


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    vec_state: Any
    obs: torch.Tensor
    next_done: torch.Tensor
    gen: torch.Generator
    lstm_state: Optional[tuple] = None  # the LSTM agent's per-env (h, c), [N, H] each


class Draws(NamedTuple):
    """One iteration's random inputs, all optional: the rollout's [T, N, A]
    Gumbel batch, one DisturbanceDraws per step (a tuple of one a frame
    under ``stack_frames``), the update's [update_epochs, batch_size]
    permutations, RANDOM_ENCODER's [batch_size·frames, embed_dim] standard
    normals (drawn after the rollout and before the permutations, as the
    JAX package splits its key), and the env's own draws, one per step (the
    Atari games' serves and spawns, Dynamic-Obstacles' ball moves). The LSTM
    agent's update shuffles envs: its permutations are
    [update_epochs, num_envs]."""

    gumbels: Optional[torch.Tensor] = None
    disturb: Optional[Sequence[DisturbanceDraws]] = None
    permutations: Optional[torch.Tensor] = None
    random_embeddings: Optional[torch.Tensor] = None
    env: Optional[Sequence[Any]] = None


class Trainer:
    """Owns the training iteration; host code only logs and checkpoints.

    Args:
        cfg: PPO hyperparameters.
        env: TorchVectorEnv (MiniGrid) or envs.atari.vector.AtariVectorEnv.
        num_iterations: total iterations (LR anneal, λ warmup).
        disturbance: optional DisturbanceParams applied each rollout step.
        disturbance_semantics: ``"batched"`` (the MiniGrid CLIP scripts',
            K1 on the GPU), ``"per_image"`` (the vanilla script's) or
            ``"stack_frames"`` (the Atari scripts': K1 once a frame).
        features_fn: the agent's feature trunk. With the default
            ``cnn_features``, no disturbance, no ``embed_images_fn`` and an
            env whose observations are exact tile upscales of its views,
            the Trainer takes the view fast path (``view_mode``): the
            rollout stores raw [N, 7, 7, 3] views and the trunk is
            ``agent.make_view_features``, the JAX package's rule
            (`runner.py:204-211`).
        embed_images_fn: optional ``(obs_uint8 [T·N, H, W, C], frozen) ->
            [T·N, D]`` image-embedding function
            (``clip_utils.make_encode_images_fn``, or the Atari stacks'
            ``make_multiframe_embed_fn``), applied to the rollout's stored
            observations flattened t-major; takes precedence over
            ``embed_desc_fn`` as in the JAX package.
        embed_desc_fn: optional ``(rollout_desc, frozen) -> [T·N, D]``
            text-embedding function (the MiniGrid description table,
            ``clip_utils.make_text_table_embed_fn``).
        embed_random_fn: optional ``(gen, normals) -> [T·N, D]``
            RANDOM_ENCODER embeddings (``clip_utils.make_random_embed_fn``,
            ``frames=4`` for the Atari image modality),
            drawn once per iteration before the update; used where neither
            of the two above is given, as in the JAX package.
        clip_lambda: target λ of the alignment loss (linear warmup over
            ``clip_warmup_fraction`` of the iterations).
        frozen_params: non-optimized tensors the embedding fn reads
            (``{"text_table": ...}`` or ``{"clip": clip_params}``).
        recurrent: the LSTM agent (``models/recurrent.py``): the rollout
            carries the cell's (h, c) in ``TrainState.lstm_state``, and the
            update minibatches over envs, replaying each slice's sequences
            from the iteration's initial state. Vanilla PPO only (no CLIP
            modality), with ``num_envs`` divisible by ``num_minibatches``,
            as in the JAX package (`runner.py:148-166`).
        mission_conditioning: the policy reads ``(obs, mission)`` pairs, the
            mission the env's ``mission_fn`` of each step's state, through
            the FiLM trunk of ``models/mission.py`` wrapped around the
            trunk chosen above (the view trunk included); the params need
            ``params["mission"]``. Refused with the image modality, as in
            the JAX package (`runner.py:109-127`).
    """

    def __init__(
        self,
        cfg: ppo_mod.PPOConfig,
        env,
        num_iterations: int,
        disturbance: Optional[DisturbanceParams] = None,
        disturbance_semantics: str = "batched",
        features_fn: agent_mod.FeatureFn = agent_mod.cnn_features,
        embed_images_fn: Optional[Callable] = None,
        embed_desc_fn: Optional[Callable] = None,
        embed_random_fn: Optional[Callable] = None,
        clip_lambda: float = 0.0,
        clip_warmup_fraction: float = 0.2,
        capture_env0: bool = False,
        frozen_params: Any = None,
        mesh: Any = None,
        recurrent: bool = False,
        exploration_bonus: float = 0.0,
        episodic_bonus: float = 0.0,
        mission_conditioning: bool = False,
    ):
        later = {
            "mesh": (mesh is not None, "the multi-GPU slice"),
            "exploration_bonus": (exploration_bonus > 0.0 or episodic_bonus > 0.0,
                                  "the extensions slice"),
        }
        for name, (requested, slice_name) in later.items():
            if requested:
                raise NotImplementedError(f"Trainer: {name} comes with {slice_name} of the port")
        if recurrent:
            # LSTM minibatches are env slices; the CLIP embedding paths pair
            # flat minibatches with precomputed embeddings and are not wired
            # through the sequence replay (nor are they in the JAX package).
            if (embed_images_fn is not None or embed_desc_fn is not None
                    or embed_random_fn is not None or clip_lambda != 0.0):
                raise ValueError("--recurrent supports vanilla PPO only (no CLIP modality)")
            if cfg.num_envs % cfg.num_minibatches:
                raise ValueError(f"recurrent PPO minibatches over envs: num_envs={cfg.num_envs} "
                                 f"not divisible by num_minibatches={cfg.num_minibatches}")
        if mission_conditioning:
            if not hasattr(env, "mission_fn"):
                raise ValueError("--mission-conditioning needs an env with mission_fn (the "
                                 "MiniGrid and BabyAI families)")
            if embed_images_fn is not None:
                raise ValueError("--mission-conditioning composes with the text modality "
                                 "(embed_desc_fn), not the image modality, whose encode reads "
                                 "the stored image batches")
        self.mission_conditioning = mission_conditioning
        self.recurrent = recurrent
        self.cfg = cfg
        self.env = env
        self.num_iterations = num_iterations
        self.disturbance = disturbance
        check_semantics(disturbance_semantics)
        self.disturbance_semantics = disturbance_semantics
        self.view_mode = (
            disturbance is None
            and embed_images_fn is None
            and features_fn is agent_mod.cnn_features
            and getattr(env, "supports_view_obs", False)
        )
        if self.view_mode:
            features_fn = agent_mod.make_view_features(env.view_upscale)
        if mission_conditioning:
            # after the view decision, so missions compose with the view
            # trunk: the pair is (view, mission)
            features_fn = mission_mod.MissionFeatures(features_fn)
        self.features_fn = features_fn
        self.embed_images_fn = embed_images_fn
        self.embed_desc_fn = embed_desc_fn
        self.embed_random_fn = embed_random_fn
        self.clip_lambda = clip_lambda
        self.clip_warmup_fraction = clip_warmup_fraction
        self.capture_env0 = capture_env0
        self.frozen_params = frozen_params

    # -- initialization ------------------------------------------------------

    def init_state(self, params: dict, seed: int) -> TrainState:
        gen = torch.Generator(device=self.env.device)
        gen.manual_seed(seed)
        vec_state, obs = self.env.reset_fn(gen)
        if self.view_mode:
            obs = self.env.observe_view_fn(vec_state)
        lstm_state = None
        if self.recurrent:
            lstm_state = rec.init_zero_state(self.env.num_envs, params["lstm"]["w_hh"].shape[0],
                                             self.env.device)
        return TrainState(
            params=params,
            opt_state=ppo_mod.init_adam_state(params),
            vec_state=vec_state,
            obs=obs,
            next_done=torch.zeros(self.env.num_envs, device=self.env.device),
            gen=gen,
            lstm_state=lstm_state,
        )

    def clip_lambda_eff(self, iteration: int) -> float:
        """λ with linear warmup; ``iteration`` is 1-indexed."""
        return get_clip_lambda_with_warmup(self.clip_lambda, iteration - 1,
                                           self.num_iterations, self.clip_warmup_fraction)

    # -- one iteration -------------------------------------------------------

    def _rollout(self, state: TrainState, draws: Draws, collect_desc: bool = False):
        if self.recurrent:
            vec_state, obs, next_done, lstm_state, batch = rollout_mod.collect_rollout_recurrent(
                state.params, self.env, state.vec_state, state.obs, state.next_done,
                state.lstm_state, state.gen, self.cfg.num_steps, self.disturbance,
                self.disturbance_semantics, self.features_fn, self.capture_env0,
                self.frozen_params, gumbels=draws.gumbels, disturb_draws=draws.disturb,
                small_obs=self.view_mode, env_draws=draws.env, mission_fn=self._mission_fn,
            )
            state = dataclasses.replace(state, vec_state=vec_state, obs=obs, next_done=next_done,
                                        lstm_state=lstm_state)
            return state, batch
        vec_state, obs, next_done, batch = rollout_mod.collect_rollout(
            state.params, self.env, state.vec_state, state.obs, state.next_done, state.gen,
            self.cfg.num_steps, self.disturbance, self.disturbance_semantics, self.features_fn,
            self.capture_env0, self.frozen_params,
            collect_desc=collect_desc or self.embed_desc_fn is not None,
            gumbels=draws.gumbels, disturb_draws=draws.disturb, small_obs=self.view_mode,
            env_draws=draws.env, mission_fn=self._mission_fn,
        )
        state = dataclasses.replace(state, vec_state=vec_state, obs=obs, next_done=next_done)
        return state, batch

    @property
    def _mission_fn(self):
        return self.env.mission_fn if self.mission_conditioning else None

    def _policy_obs(self, state: TrainState):
        """The policy's input at ``state``: its observation, paired with the
        env state's mission under mission conditioning."""
        if self.mission_conditioning:
            return state.obs, self.env.mission_fn(state.vec_state)
        return state.obs

    def _data2d(self, state: TrainState, batch: rollout_mod.RolloutBatch) -> dict:
        """GAE and the update inputs in rollout layout [T, N, ...]; the LSTM
        agent's bootstrap value goes through the carried cell state with the
        done-reset the next rollout step would apply, and its update inputs
        hold the per-step ``dones`` its replay needs."""
        with torch.no_grad():
            if self.recurrent:
                feats = self.features_fn(state.params, self._policy_obs(state),
                                         self.frozen_params)
                h, _ = rec.masked_lstm_step(state.params["lstm"], feats, state.lstm_state,
                                            state.next_done)
                next_value = cnn.dense(state.params["critic"], rec.latent(feats, h))[..., 0]
            else:
                next_value = agent_mod.get_value(state.params, self._policy_obs(state),
                                                 self.features_fn, self.frozen_params)
            advantages, returns = gae_mod.compute_gae(
                batch.rewards, batch.values, batch.dones, next_value, state.next_done,
                self.cfg.gamma, self.cfg.gae_lambda)
        data = {"obs": batch.obs, "actions": batch.actions, "logprobs": batch.logprobs,
                "advantages": advantages, "returns": returns, "values": batch.values}
        if self.recurrent:
            data["dones"] = batch.dones
        return data

    @staticmethod
    def _flatten(data: dict) -> dict:
        """[T, N, ...] → t-major [T·N, ...] (the reference's b_* layout), leaf
        by leaf (the mission-conditioned (obs, mission) pair)."""
        return tree_map(lambda v: v.reshape((-1,) + tuple(v.shape[2:])), data)

    def learning_rate(self, iteration: int) -> float:
        """The learning rate of iteration ``iteration``'s update."""
        return (ppo_mod.anneal_lr(self.cfg, iteration, self.num_iterations)
                if self.cfg.anneal_lr else self.cfg.learning_rate)

    def _update(self, state: TrainState, data: dict, iteration: int,
                clip_embeddings: Optional[torch.Tensor], draws: Draws,
                initial_lstm_state: Optional[tuple] = None):
        lr = self.learning_rate(iteration)
        if self.recurrent:
            # data stays in rollout layout: the minibatches are env slices
            # whose [T] sequences replay from the iteration's initial state
            params, opt_state, metrics = ppo_mod.update_epochs_recurrent(
                state.params, state.opt_state, data, initial_lstm_state, self.cfg, lr,
                self.features_fn, permutations=draws.permutations, gen=state.gen,
                frozen=self.frozen_params,
            )
        else:
            params, opt_state, metrics = ppo_mod.update_epochs(
                state.params, state.opt_state, self._flatten(data), self.cfg, lr,
                self.features_fn, clip_embeddings, self.clip_lambda_eff(iteration),
                permutations=draws.permutations, gen=state.gen, frozen=self.frozen_params,
            )
        state = dataclasses.replace(state, params=params, opt_state=opt_state)
        device = data["values"].device
        scalars = {
            "learning_rate": torch.tensor(lr, device=device),
            "value_loss": metrics["v_loss"],
            "policy_loss": metrics["pg_loss"],
            "entropy": metrics["entropy"],
            "old_approx_kl": metrics["old_approx_kl"],
            "approx_kl": metrics["approx_kl"],
            "clipfrac": metrics["clipfrac"],
            "explained_variance": ppo_mod.explained_variance(data["values"], data["returns"]),
            "clip_loss": metrics["clip_loss"],
            "first_pg_loss": metrics["first_pg_loss"],
            "first_v_loss": metrics["first_v_loss"],
            "first_entropy": metrics["first_entropy"],
            "first_clip_loss": metrics["first_clip_loss"],
            "intrinsic_reward": torch.zeros((), device=device),
        }
        return state, scalars

    def embed(self, batch: rollout_mod.RolloutBatch, data: dict,
              gen: Optional[torch.Generator] = None,
              random_normals: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """The iteration's CLIP embeddings, [T·N, D] t-major, or None.
        RANDOM_ENCODER's draw their normals from ``gen`` unless
        ``random_normals`` are given."""
        if self.embed_images_fn is not None:
            obs = data["obs"]
            return self.embed_images_fn(obs.reshape((-1,) + tuple(obs.shape[2:])),
                                        self.frozen_params)
        if self.embed_desc_fn is not None:
            return self.embed_desc_fn(batch.desc, self.frozen_params)
        if self.embed_random_fn is not None:
            return self.embed_random_fn(gen, random_normals)
        return None

    def _stats(self, batch: rollout_mod.RolloutBatch, data: dict) -> dict:
        stats = {
            "done_mask": batch.done_mask,
            "episode_return": batch.episode_return,
            "episode_length": batch.episode_length,
            "returns": data["returns"],
        }
        if self.capture_env0:
            stats["env0_frames"] = batch.video
            stats["env0_dones"] = batch.done_mask[:, 0]
        return stats

    def iteration(self, state: TrainState, iteration: int, draws: Draws = Draws()):
        """One full iteration. Returns (state, scalars, episode_stats,
        batch, data): the RolloutBatch and the GAE'd update inputs, both in
        rollout layout [T, N, ...]."""
        # The LSTM agent's update replays from the iteration's INITIAL cell
        # state; the rollout carries state.lstm_state past the iteration.
        initial_lstm_state = state.lstm_state
        state, batch = self._rollout(state, draws)
        data = self._data2d(state, batch)
        clip_embeddings = self.embed(batch, data, state.gen, draws.random_embeddings)
        state, scalars = self._update(state, data, iteration, clip_embeddings, draws,
                                      initial_lstm_state)
        return state, scalars, self._stats(batch, data), batch, data

    @staticmethod
    def _pack(scalars: dict, stats: dict):
        sc = torch.stack([scalars[k].float() for k in SCALAR_KEYS])
        ep = torch.stack([stats["done_mask"].float(), stats["episode_return"].float(),
                          stats["episode_length"].float()])
        return sc, ep, stats.get("env0_frames"), stats.get("env0_dones")

    def run_iteration(self, state: TrainState, iteration: int):
        """One iteration; returns (state, packed logs) for
        :meth:`fetch_logs_chunk`."""
        return self.run_iterations(state, iteration, 1)

    def run_iterations(self, state: TrainState, start_iteration: int, k: int):
        """Iterations ``start_iteration .. start_iteration+k-1`` queued
        back to back. Returns (state, packed logs)."""
        packs = []
        for off in range(k):
            state, scalars, stats, _, _ = self.iteration(state, start_iteration + off)
            packs.append(self._pack(scalars, stats))
        return state, self._stack_packs(packs, stats["returns"])

    def _stack_packs(self, packs: list, returns: torch.Tensor):
        sc = torch.stack([p[0] for p in packs])
        ep = torch.stack([p[1] for p in packs])
        video = torch.stack([p[2] for p in packs]) if self.capture_env0 else None
        dones0 = torch.stack([p[3] for p in packs]) if self.capture_env0 else None
        return sc, ep, video, dones0, returns

    # -- split path (host text descriptions between the halves) ----------------

    def run_rollout_half(self, state: TrainState, draws: Draws = Draws()):
        """Rollout and GAE. Returns (state, data, episode_stats, desc):
        ``data`` is the update's payload for :meth:`run_update_half`
        (rollout layout [T, N, ...]) and ``desc`` the per-step state
        snapshots the host describes (MiniGrid's agent positions and
        directions; none for Atari)."""
        state, batch = self._rollout(state, draws, collect_desc=True)
        data = self._data2d(state, batch)
        return state, data, self._stats(batch, data), batch.desc

    def run_update_half(self, state: TrainState, data: dict, iteration: int,
                        clip_embeddings: Optional[torch.Tensor], draws: Draws = Draws()):
        """The update on :meth:`run_rollout_half`'s payload with the given
        [T·N, D] embeddings. Returns (state, scalars)."""
        return self._update(state, data, iteration, clip_embeddings, draws)

    def fetch_logs(self, scalars: dict, stats: dict) -> tuple[dict, dict]:
        """One iteration's ``(scalars_np, stats_np)`` in one device→host
        fetch, ``b_returns`` included."""
        return self.fetch_logs_chunk(self._stack_packs([self._pack(scalars, stats)],
                                                       stats["returns"]))[0]

    # -- host log fetch --------------------------------------------------------

    def fetch_logs_chunk(self, packed) -> list:
        """One device→host fetch for a chunk; a list of per-iteration
        ``(scalars_np, stats_np)``. ``b_returns`` (t-major GAE returns, the
        reference checkpoint payload) rides on the LAST entry."""
        sc, ep, video, dones0, last_returns = (
            None if x is None else x.cpu().numpy() for x in packed)
        out = []
        for i in range(sc.shape[0]):
            scalars_np = {name: sc[i, j] for j, name in enumerate(SCALAR_KEYS)}
            stats_np = {
                "done_mask": ep[i, 0].astype(bool),
                "episode_return": ep[i, 1],
                "episode_length": ep[i, 2].astype(np.int32),
            }
            if video is not None:
                stats_np["env0_frames"] = video[i]
                stats_np["env0_dones"] = dones0[i].astype(bool)
            out.append((scalars_np, stats_np))
        out[-1][1]["b_returns"] = last_returns.reshape(-1)
        return out


def chunk_length(k: int, iteration: int, num_iterations: int, global_step: int,
                 batch_size: int, save_freq: int, save_model: bool) -> int:
    """Cap a chunk so it never crosses a checkpoint boundary (the reference
    saves when ``global_step % save_freq == 0``, `clip_ppo_minigrid.py:589`,
    which only fires when save_freq is a multiple of batch_size)."""
    k = min(k, num_iterations - iteration + 1)
    if save_model and save_freq % batch_size == 0:
        per = save_freq // batch_size
        done = global_step // batch_size
        k = min(k, per - (done % per))
    return max(k, 1)


class LogPipeline:
    """Fetch chunk *k*'s packed logs after chunk *k+1* is queued, so the
    device→host copy waits behind queued device work instead of in front of
    it. ``handle(iteration, scalars_np, stats_np)`` runs once per
    iteration, in order, one chunk behind. Call :meth:`flush` before
    reading anything the handler produces and once after the loop."""

    def __init__(self, trainer: Trainer, handle: Callable[[int, dict, dict], None]):
        self.trainer = trainer
        self.handle = handle
        self._pending: Optional[tuple[int, Any]] = None

    def after_dispatch(self, iteration: int, packed) -> None:
        prev, self._pending = self._pending, (iteration, packed)
        if prev is not None:
            self._drain(prev)

    def flush(self) -> None:
        if self._pending is not None:
            prev, self._pending = self._pending, None
            self._drain(prev)

    def _drain(self, item: tuple[int, Any]) -> None:
        iteration, packed = item
        for off, (scalars, stats) in enumerate(self.trainer.fetch_logs_chunk(packed)):
            self.handle(iteration + off, scalars, stats)
