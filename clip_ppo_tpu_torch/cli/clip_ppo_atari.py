"""CLIP-PPO on Atari — the port's counterpart of
``clip_ppo_tpu/cli/clip_ppo_atari.py``, flag-compatible with the reference
`atari_experiments/clip_ppo/clip_ppo_atari.py`.

    python -m clip_ppo_tpu_torch.cli.clip_ppo_atari --env-id ALE/Breakout-v5 \\
        --clip-config.apply-disturbances --clip-config.disturbance-severity HARD

Runs on the GPU (``--cuda``, the default, raises without one) or on the CPU
with ``--no-cuda``, on the port's native Breakout, Pong and Seaquest
batched on the device. The gradient topology is the reference's: the PPO
latent is detached. In the image modality (the default) each iteration's
1,024 stored 4-frame stacks go through the CLIP vision tower as one call of
4,096 frames, cast once to bf16 (K2 and K3 in bf16 on the GPU), each
frame's features L2-normalized and concatenated to [B, 4·512]; the
minibatch loss puts them through the trainable ``temporal_projection``, the
only parameters the CLIP gradient reaches (`clip_ppo_atari.py:726-731`). In
the text modality the live games' descriptions are tokenized on the host
after each rollout, tiled across the steps as the reference cycles its
envs, and encoded with the text tower in float32 (K2 and K3 on the GPU);
the loss is then a monitor. ``stack_frames`` disturbances disturb each
frame of a stored stack with its own draws (one K1 launch a frame on the
GPU; `clip_ppo_atari.py:568-584`).

The ablations (``--clip-config.ablation-mode``): FROZEN_CLIP makes the
frozen vision tower, cast once to bf16, the trunk through
``temporal_projection`` (K2 and K3 in bf16 at every rollout step, the
bootstrap value and every minibatch), with no CLIP loss; RANDOM_ENCODER
aligns with fresh normalized Gaussian embeddings each iteration (4 a
sample in the image modality) and launches no tower kernel.

TensorBoard tags, the checkpoint payload (``temporal_projection`` inside
the agent params, as the JAX package carries it) and naming, and the CLI
surface match the JAX package. The host/ALE backend (``--env-backend
ale``), ``--distributed`` and more than one device are refused by name.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from clip_ppo_tpu_torch.cli._logging import IterationLogger
from clip_ppo_tpu_torch.cli.ppo_atari import reject_later_slices
from clip_ppo_tpu_torch.device import resolve_device
from clip_ppo_tpu_torch.envs.atari.vector import AtariVectorEnv
from clip_ppo_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from clip_ppo_tpu_torch.io.tb_writer import SummaryWriter, hyperparameters_table
from clip_ppo_tpu_torch.io.tracking import ProfilerWindow, maybe_init_wandb
from clip_ppo_tpu_torch.io.video import VideoRecorder
from clip_ppo_tpu_torch.models import clip_utils
from clip_ppo_tpu_torch.models.agent import (
    LATENT_DIM,
    AblationMode,
    cnn_features,
    init_agent_params,
)
from clip_ppo_tpu_torch.models.clip import model as clip_model_mod
from clip_ppo_tpu_torch.models.clip.config import CLIP_CONFIGS
from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity, resolve_params
from clip_ppo_tpu_torch.train.ppo import PPOConfig
from clip_ppo_tpu_torch.train.runner import LogPipeline, Trainer, chunk_length
from clip_ppo_tpu_torch.utils import flags


@dataclass
class AtariClipPPOConfig(clip_utils.ClipPPOConfig):
    """Atari-specific CLIP-PPO defaults (`clip_ppo_atari.py:46-62`)."""

    clip_lambda: float = 0.00001
    """coefficient for CLIP alignment loss"""
    clip_modality: str = "image"
    """CLIP modality to use for alignment (image better for Atari visual scenes)"""
    ablation_mode: AblationMode = AblationMode.NONE
    """ablation mode for controlled experiments"""
    apply_disturbances: bool = False
    """whether to apply visual disturbances during training"""
    disturbance_severity: str = "MODERATE"
    """disturbance severity level: MILD, MODERATE, HARD, SEVERE"""


@dataclass
class Args:
    exp_name: str = "clip_ppo_atari"
    """the name of this experiment"""
    seed: int = 1
    """seed of the experiment"""
    torch_deterministic: bool = True
    """if toggled, `torch.backends.cudnn.deterministic=True`"""
    cuda: bool = True
    """run on the GPU (raises without one); --no-cuda runs on the CPU"""
    track: bool = False
    """if toggled, this experiment will be tracked with Weights and Biases"""
    wandb_project_name: str = "cleanRL"
    """the wandb's project name"""
    wandb_entity: Optional[str] = None
    """the entity (team) of wandb's project"""
    capture_video: bool = True
    """whether to capture videos of the agent performances"""
    profile_dir: Optional[str] = None
    """capture a torch.profiler trace of steady-state iterations to this dir"""
    verbose: bool = True
    """enable verbose debug output for losses"""

    # Algorithm specific arguments
    env_id: str = "BreakoutNoFrameskip-v4"
    """the id of the environment"""
    total_timesteps: int = 100000
    """total timesteps of the experiments"""
    learning_rate: float = 2.5e-4
    """the learning rate of the optimizer"""
    num_envs: int = 8
    """the number of parallel game environments"""
    num_steps: int = 128
    """the number of steps to run in each environment per policy rollout"""
    anneal_lr: bool = True
    """Toggle learning rate annealing for policy and value networks"""
    gamma: float = 0.99
    """the discount factor gamma"""
    gae_lambda: float = 0.95
    """the lambda for the general advantage estimation"""
    num_minibatches: int = 4
    """the number of mini-batches"""
    update_epochs: int = 4
    """the K epochs to update the policy"""
    norm_adv: bool = True
    """Toggles advantages normalization"""
    clip_coef: float = 0.1
    """the surrogate clipping coefficient"""
    clip_vloss: bool = True
    """Toggles whether or not to use a clipped loss for the value function"""
    ent_coef: float = 0.01
    """coefficient of the entropy"""
    vf_coef: float = 0.5
    """coefficient of the value function"""
    max_grad_norm: float = 0.5
    """the maximum norm for the gradient clipping"""
    target_kl: Optional[float] = None
    """the target KL divergence threshold"""

    # CLIP-PPO configuration
    clip_config: AtariClipPPOConfig = field(default_factory=AtariClipPPOConfig)
    """Atari-specific CLIP-PPO configuration"""

    # Run naming arguments
    run_name: Optional[str] = None
    """custom run name (if empty, uses default format)"""

    # Model saving arguments
    save_model: bool = True
    """whether to save model checkpoints"""
    save_freq: int = 100000
    """save model every N timesteps"""
    model_path: str = "checkpoints"
    """directory to save model checkpoints"""
    resume_checkpoint: str = ""
    """path to checkpoint file to resume training from"""

    num_devices: int = 1
    """data-parallel device count (more than one comes with the multi-GPU slice)"""
    distributed: bool = False
    """multi-host data-parallel training (multi-GPU slice)"""
    iterations_per_dispatch: int = 8
    """training iterations queued back to back before their logs are read
    (the text modality runs one at a time around its host tokenization)"""
    env_backend: str = "jax"
    """'jax' = the native games batched on the device (the JAX package's
    name for them); 'ale' = the host-side emulator (comes with the host/ALE
    slice)"""
    rollout_groups: int = 2
    """ale backend only: env groups pipelined against the device policy"""

    # to be filled in runtime
    batch_size: int = 0
    """the batch size (computed in runtime)"""
    minibatch_size: int = 0
    """the mini-batch size (computed in runtime)"""
    num_iterations: int = 0
    """the number of iterations (computed in runtime)"""


def train(args: Args, run_name: Optional[str] = None) -> dict:
    """Run CLIP-PPO Atari training; returns summary stats."""
    args.batch_size = int(args.num_envs * args.num_steps)
    args.minibatch_size = int(args.batch_size // args.num_minibatches)
    args.num_iterations = args.total_timesteps // args.batch_size
    cc = args.clip_config
    reject_later_slices(args)
    compute_clip = clip_utils.should_compute_clip_loss(cc.ablation_mode, cc.clip_lambda)
    if compute_clip and cc.clip_modality not in ("image", "text"):
        raise SystemExit(f"Invalid modality: {cc.clip_modality}. Must be 'image' or 'text'")
    frozen_mode = cc.ablation_mode == AblationMode.FROZEN_CLIP
    random_mode = cc.ablation_mode == AblationMode.RANDOM_ENCODER
    if (compute_clip and not random_mode) or frozen_mode:
        # The latent and the temporal projection are 512 wide: the text
        # embeddings, and the 4 frames' features the projection takes, must
        # be too (ViT-L/14's are 768). RANDOM_ENCODER's are 512 whatever
        # the tower.
        clip_utils.check_embedding_width(LATENT_DIM, CLIP_CONFIGS[cc.clip_model].embed_dim)
    device = resolve_device(args.cuda)
    run_name = (run_name or args.run_name
                or f"{args.env_id}__{args.exp_name}__{args.seed}__{int(time.time())}")

    maybe_init_wandb(args, run_name)
    writer = SummaryWriter(f"runs/{run_name}")
    recorder = VideoRecorder(f"videos/atari/{run_name}") if args.capture_video else None
    profiler = ProfilerWindow(args.profile_dir)
    writer.add_text("hyperparameters", hyperparameters_table(dataclasses.asdict(args)))
    writer.add_text("config/disturbance_severity",
                    cc.disturbance_severity if cc.apply_disturbances else "CLEAN")

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    torch.backends.cudnn.deterministic = args.torch_deterministic

    env = AtariVectorEnv(args.env_id, args.num_envs, device)
    disturbance = None
    if cc.apply_disturbances:
        disturbance = resolve_params(DisturbanceSeverity[cc.disturbance_severity])
        print(f"Disturbances enabled with severity: {cc.disturbance_severity}")
    else:
        print("Disturbances disabled")

    # temporal_projection exists when frozen CLIP is the trunk or the image
    # modality projects the concatenated embeddings (`clip_ppo_atari.py:183-187`).
    image_modality = compute_clip and cc.clip_modality == "image"
    needs_projection = image_modality or frozen_mode
    clip_params = clip_cfg = None
    if (compute_clip and not random_mode) or frozen_mode:
        clip_params, clip_cfg = clip_utils.load_clip_model(cc.clip_model, device)
    frozen_params, features_fn = None, cnn_features
    embed_images_fn = embed_random_fn = text_params = None
    if frozen_mode or (image_modality and not random_mode):
        # The vision tower, cast once to bf16, is the trunk (FROZEN_CLIP) or
        # encodes each iteration's stacks (image modality).
        frozen_params = {"clip": clip_model_mod.cast_tower({"visual": clip_params["visual"]},
                                                           torch.bfloat16)}
        if frozen_mode:
            features_fn = clip_utils.make_frozen_clip_stack_features_fn(clip_cfg)
        else:
            embed_images_fn = clip_utils.make_multiframe_embed_fn(clip_cfg)
    elif compute_clip and random_mode:
        embed_random_fn = clip_utils.make_random_embed_fn(
            args.batch_size, frames=4 if cc.clip_modality == "image" else 1)
    elif compute_clip:  # text modality from the live games, float32 tower
        text_params = clip_params
    del clip_params  # the image paths keep only the tower's bf16 copy

    cfg = PPOConfig(
        learning_rate=args.learning_rate, num_envs=args.num_envs, num_steps=args.num_steps,
        anneal_lr=args.anneal_lr, gamma=args.gamma, gae_lambda=args.gae_lambda,
        num_minibatches=args.num_minibatches, update_epochs=args.update_epochs,
        norm_adv=args.norm_adv, clip_coef=args.clip_coef, clip_vloss=args.clip_vloss,
        ent_coef=args.ent_coef, vf_coef=args.vf_coef, max_grad_norm=args.max_grad_norm,
        target_kl=args.target_kl,
        clip_mode="projected" if image_modality else ("precomputed" if compute_clip else "none"),
    )
    trainer = Trainer(
        cfg, env, num_iterations=args.num_iterations, disturbance=disturbance,
        disturbance_semantics="stack_frames", features_fn=features_fn,
        embed_images_fn=embed_images_fn, embed_random_fn=embed_random_fn,
        clip_lambda=cc.clip_lambda, capture_env0=args.capture_video,
        frozen_params=frozen_params,
    )
    param_gen = torch.Generator()
    param_gen.manual_seed(args.seed)
    params = init_agent_params(param_gen, env.num_actions, device, in_channels=4,
                               with_temporal_projection=needs_projection)
    state = trainer.init_state(params, args.seed)

    checkpoint_path = None
    if args.save_model:
        os.makedirs(args.model_path, exist_ok=True)
        checkpoint_path = os.path.join(args.model_path, run_name)

    start_iteration, global_step = 1, 0
    if args.resume_checkpoint:
        params, opt_state, it, global_step, _ = load_checkpoint(
            args.resume_checkpoint, state.params, state.opt_state, device)
        state = dataclasses.replace(state, params=params, opt_state=opt_state)
        start_iteration = it + 1

    last_scalars: dict = {}

    def verbose(it: int, scalars: dict) -> None:
        last_scalars.update(scalars)
        if compute_clip and args.verbose:
            clip_utils.verbose_debug_print(it, cc.clip_lambda, args.ent_coef, args.vf_coef, scalars)

    logger = IterationLogger(
        writer, profiler, recorder, num_envs=args.num_envs, batch_size=args.batch_size,
        num_iterations=args.num_iterations, log_clip_loss=True, verbose_fn=verbose,
    )
    logger.global_step = global_step

    def save(iteration: int, final: bool = False) -> None:
        save_checkpoint(checkpoint_path, state.params, state.opt_state, iteration,
                        logger.global_step, args, b_returns=logger.b_returns, final=final,
                        learning_rate=trainer.learning_rate(iteration))

    pipeline = LogPipeline(trainer, logger.handle)
    iteration = start_iteration
    while iteration <= args.num_iterations:
        if text_params is not None:
            # Host tokenization sits between the rollout and the update, so
            # the text modality runs one iteration at a time.
            k = 1
            state, data, stats, _ = trainer.run_rollout_half(state)
            descs = env.describe(state.vec_state)
            descriptions = descs * args.num_steps  # index t·N+n → env n
            state, scalars = trainer.run_update_half(
                state, data, iteration, clip_utils.encode_texts(text_params, clip_cfg, descriptions))
            logger.handle(iteration, *trainer.fetch_logs(scalars, stats))
        else:
            k = chunk_length(args.iterations_per_dispatch, iteration, args.num_iterations,
                             (iteration - 1) * args.batch_size, args.batch_size,
                             args.save_freq, args.save_model)
            state, packed = trainer.run_iterations(state, iteration, k)
            pipeline.after_dispatch(iteration, packed)
        iteration += k
        if args.save_model and ((iteration - 1) * args.batch_size) % args.save_freq == 0:
            pipeline.flush()
            save(iteration - 1)
    pipeline.flush()

    if args.save_model:
        save(args.num_iterations, final=True)
    profiler.close()
    if recorder is not None:
        recorder.close()
    writer.close()
    return {
        "global_step": logger.global_step,
        "sps": logger.sps,
        "recent_returns": logger.last_returns[-100:],
        "run_name": run_name,
        "last_scalars": last_scalars,
    }


def main() -> None:
    train(flags.parse(Args))


if __name__ == "__main__":
    main()
