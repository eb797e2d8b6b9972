"""CLIP-PPO on MiniGrid — the port's counterpart of
``clip_ppo_tpu/cli/clip_ppo_minigrid.py``, flag-compatible with the
reference `minigrid_experiments/clip_ppo/clip_ppo_minigrid.py`.

    python -m clip_ppo_tpu_torch.cli.clip_ppo_minigrid \\
        --clip-config.clip-lambda 1e-5 --clip-config.clip-modality text \\
        --clip-config.apply-disturbances --clip-config.disturbance-severity HARD

Runs on the GPU (``--cuda``, the default, raises without one) or on the CPU
with ``--no-cuda``. The text modality encodes the W·H·4 possible MiniGrid
descriptions once at startup with the CLIP text tower (K2/K3 kernels on the
GPU) and gathers rows per step, where the descriptions' object suffix is the
same on 16 sampled resets (the static border wall of every bordered layout).
Where it varies (MultiRoom, whose grid has no border), or with
``--no-text-embed-table``, the text modality takes the split path of the
JAX CLI: each iteration's rollout, then its 1,024 descriptions built and
tokenized on the host and encoded by the text tower (K2/K3 once a layer),
then the update. The image modality
(``--clip-config.clip-modality image``) encodes each iteration's stored
observations with the CLIP vision tower (K2/K5 kernels on the GPU).
Batched disturbances (K1 on the GPU) apply to each observation before it is
stored or acted on (`clip_ppo_minigrid.py:381-388`). Embeddings enter the
update as data and latents are detached, so the CLIP loss is a monitor that
never perturbs the policy gradient.

The ablations (``--clip-config.ablation-mode``): FROZEN_CLIP makes the
frozen CLIP vision tower, cast once to bfloat16, the agent's trunk (K2 and
K3 in bf16 on the GPU, in every rollout step, the bootstrap value and every
minibatch of the update), with no CLIP loss; RANDOM_ENCODER aligns the
latent with fresh normalized Gaussian embeddings drawn each iteration
instead of CLIP's (λ > 0), and launches no tower kernel.

``--clip-config.structured-frozen-init`` first distills whatever CLIP tower
the run loads to pixel-PCA features of random-policy observations
(:mod:`clip_ppo_tpu_torch.models.distill`, plain PyTorch autograd), under
FROZEN_CLIP and in the image modality alike.

TensorBoard tags (including ``config/disturbance_severity``), checkpoint
payload and naming, derived batch sizes and the CLI surface match the
reference. ``--mission-conditioning`` FiLM-conditions the trunk on the
env's structured instruction (``models/mission.py``) in the text modality
and the ablations; with the image modality it is refused, as the JAX CLI
refuses it. Options that need later slices of the port are rejected with an
error naming the slice.
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
from clip_ppo_tpu_torch.device import resolve_device
from clip_ppo_tpu_torch.envs.minigrid import core as minigrid_core
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
from clip_ppo_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from clip_ppo_tpu_torch.io.tb_writer import SummaryWriter, hyperparameters_table
from clip_ppo_tpu_torch.io.tracking import ProfilerWindow, maybe_init_wandb
from clip_ppo_tpu_torch.io.video import VideoRecorder
from clip_ppo_tpu_torch.models import clip_utils, distill
from clip_ppo_tpu_torch.models.agent import (
    LATENT_DIM,
    AblationMode,
    cnn_features,
    init_agent_params,
)
from clip_ppo_tpu_torch.models.clip.config import CLIP_CONFIGS
from clip_ppo_tpu_torch.models.clip.model import cast_tower
from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity, resolve_params
from clip_ppo_tpu_torch.train.ppo import PPOConfig
from clip_ppo_tpu_torch.train.runner import LogPipeline, Trainer, chunk_length
from clip_ppo_tpu_torch.utils import flags


@dataclass
class MiniGridClipPPOConfig(clip_utils.ClipPPOConfig):
    """MiniGrid-specific CLIP-PPO defaults (`clip_ppo_minigrid.py:35-55`)."""

    clip_lambda: float = 0.0
    """coefficient for CLIP alignment loss - good default for MiniGrid"""
    clip_model: str = "ViT-B/32"
    """CLIP model variant - standard choice"""
    clip_modality: str = "text"
    """MiniGrid works well with symbolic text descriptions"""
    ablation_mode: AblationMode = AblationMode.NONE
    """Default ablation mode for MiniGrid experiments"""
    apply_disturbances: bool = False
    """start with clean environment by default"""
    disturbance_severity: str = "MODERATE"
    """moderate disturbances work well for MiniGrid"""
    structured_frozen_init: bool = False
    """no reference equivalent: distill the CLIP visual tower to pixel-PCA
    features of random-policy observations before training (FROZEN_CLIP
    learnability without pretrained weights; models/distill.py)"""


@dataclass
class Args:
    exp_name: str = "clip_ppo_minigrid"
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
    env_id: str = "MiniGrid-Empty-16x16-v0"
    """the id of the environment"""
    total_timesteps: int = 100_000
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
    clip_config: MiniGridClipPPOConfig = field(default_factory=MiniGridClipPPOConfig)
    """MiniGrid-specific CLIP-PPO configuration"""

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

    # Mission conditioning (no reference equivalent: the reference drops the
    # mission through ImgObsWrapper, `clip_ppo_minigrid.py:142-155`;
    # models/mission.py). Composes with the text modality; the image
    # modality's encode reads the stored image batches and is refused.
    mission_conditioning: bool = False
    """FiLM-condition the policy/value trunk on the env's structured
    instruction (EnvState.target/instr/instr_state)"""

    num_devices: int = 1
    """data-parallel device count (more than one comes with the multi-GPU slice)"""
    tp: int = 1
    """tensor-parallel degree of the CLIP image encode (multi-GPU slice)"""
    distributed: bool = False
    """multi-host data-parallel training (multi-GPU slice)"""
    iterations_per_dispatch: int = 8
    """training iterations queued back to back before their logs are read"""
    text_embed_table: bool = True
    """text modality: precompute the W·H·4 description-embedding table at
    startup and gather per step (falls back to the per-iteration host
    tokenization path when the description suffix varies across resets)"""

    # to be filled in runtime
    batch_size: int = 0
    """the batch size (computed in runtime)"""
    minibatch_size: int = 0
    """the mini-batch size (computed in runtime)"""
    num_iterations: int = 0
    """the number of iterations (computed in runtime)"""


def _reject_later_slices(args: Args, compute_clip: bool) -> None:
    cc = args.clip_config
    random_mode = cc.ablation_mode == AblationMode.RANDOM_ENCODER
    frozen_mode = cc.ablation_mode == AblationMode.FROZEN_CLIP
    later = [
        (args.num_devices > 1 or args.tp > 1 or args.distributed,
         "--num-devices/--tp > 1 and --distributed", "the multi-GPU slice"),
    ]
    for requested, what, slice_name in later:
        if requested:
            raise SystemExit(f"{what} is not ported yet: it comes with {slice_name} of "
                             "the PyTorch/CUDA port")
    if (args.mission_conditioning and compute_clip and not random_mode and not frozen_mode
            and cc.clip_modality == "image"):
        raise SystemExit("--mission-conditioning composes with the text modality, not the image "
                         "modality, whose encode reads the stored image batches")
    if compute_clip and cc.clip_modality not in ("image", "text"):
        raise SystemExit(f"Invalid modality: {cc.clip_modality}. Must be 'image' or 'text'")
    if (compute_clip and not random_mode) or frozen_mode:
        # The JAX package raises this at the loss (or, FROZEN_CLIP, at the
        # heads' product); here before any tower runs. RANDOM_ENCODER's
        # embeddings are 512 wide whatever the tower.
        clip_utils.check_embedding_width(LATENT_DIM, CLIP_CONFIGS[cc.clip_model].embed_dim)


def train(args: Args, run_name: Optional[str] = None) -> dict:
    """Run CLIP-PPO training; returns summary stats."""
    args.batch_size = int(args.num_envs * args.num_steps)
    args.minibatch_size = int(args.batch_size // args.num_minibatches)
    args.num_iterations = args.total_timesteps // args.batch_size
    cc = args.clip_config
    compute_clip = clip_utils.should_compute_clip_loss(cc.ablation_mode, cc.clip_lambda)
    device = resolve_device(args.cuda)
    _reject_later_slices(args, compute_clip)
    run_name = run_name or args.run_name or f"{args.env_id}__{args.exp_name}__{args.seed}__{int(time.time())}"

    maybe_init_wandb(args, run_name)
    writer = SummaryWriter(f"runs/{run_name}")
    recorder = VideoRecorder(f"videos/minigrid/clip_ppo/{run_name}") if args.capture_video else None
    profiler = ProfilerWindow(args.profile_dir)
    writer.add_text("hyperparameters", hyperparameters_table(dataclasses.asdict(args)))
    # Machine-read severity tag (`clip_ppo_minigrid.py:301-304`).
    writer.add_text("config/disturbance_severity",
                    cc.disturbance_severity if cc.apply_disturbances else "CLEAN")

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    torch.backends.cudnn.deterministic = args.torch_deterministic

    env = TorchVectorEnv(args.env_id, args.num_envs, device)

    disturbance = None
    if cc.apply_disturbances:
        disturbance = resolve_params(DisturbanceSeverity[cc.disturbance_severity])
        print(f"Disturbances enabled with severity: {cc.disturbance_severity}")
    else:
        print("Disturbances disabled")

    # The tower is needed when the alignment loss is active or the trunk is
    # frozen CLIP (`clip_ppo_minigrid.py:321-326`). FROZEN_CLIP: the tower,
    # cast once to bf16, in frozen["clip"] is the agent's trunk. Image
    # modality: the CLIP weights stay in frozen["clip"] and the vision tower
    # encodes each iteration's observations. Text modality: descriptions are
    # f(agent_x, agent_y, dir) + a suffix that is the static border wall on
    # bordered layouts (checked over 16 resets), so the W·H·4 description
    # table is encoded once; where the suffix varies, or without the table,
    # the split path keeps the text tower and encodes each iteration's
    # descriptions (`clip_ppo_minigrid.py:338-364, 425-428`). RANDOM_ENCODER:
    # fresh normalized Gaussians each iteration take the place of both.
    frozen_params, embed_images_fn, embed_desc_fn, table_seconds = None, None, None, 0.0
    text_params = None  # the split path's text tower
    embed_random_fn, features_fn = None, cnn_features
    frozen_mode = cc.ablation_mode == AblationMode.FROZEN_CLIP
    distill_losses, distill_seconds = None, 0.0
    if compute_clip or frozen_mode:
        clip_params, clip_cfg = clip_utils.load_clip_model(cc.clip_model, device)
        if cc.structured_frozen_init:
            # Whenever a tower is loaded, as the JAX CLI does; each draw from
            # a generator of its own, off the training stream.
            print("Distilling CLIP visual tower to pixel-PCA features...")
            t0 = time.time()
            obs_samples = distill.collect_random_observations(
                env, torch.Generator(device=device).manual_seed(args.seed + 2),
                num_steps=max(256 // args.num_envs, 8))
            clip_params, distill_losses = distill.distill_visual_tower(
                torch.Generator(device=device).manual_seed(args.seed + 3), clip_params,
                clip_cfg, obs_samples)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            distill_seconds = time.time() - t0
    if frozen_mode:
        frozen_params = {"clip": cast_tower(clip_params, torch.bfloat16)}
        features_fn = clip_utils.make_frozen_clip_features_fn(clip_cfg)
    elif compute_clip and cc.ablation_mode == AblationMode.RANDOM_ENCODER:
        embed_random_fn = clip_utils.make_random_embed_fn(args.batch_size)
    elif compute_clip and cc.clip_modality == "image":
        frozen_params = {"clip": clip_params}
        embed_images_fn = clip_utils.make_encode_images_fn(clip_cfg)
    elif compute_clip:
        gen = torch.Generator()
        gen.manual_seed(0)
        grids = minigrid_core.reset(env.params, 16, gen, "cpu").grid.numpy()
        suffixes = {minigrid_core._objects_suffix(g) for g in grids}
        if not args.text_embed_table or len(suffixes) != 1:
            text_params = clip_params
            print("Text modality on the split path: "
                  + ("--no-text-embed-table" if not args.text_embed_table else
                     f"the description suffix varies across resets of {args.env_id}"))
        else:
            t0 = time.time()
            table = clip_utils.build_minigrid_text_table(
                clip_params, clip_cfg, env.params.width, env.params.height, suffixes.pop())
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            table_seconds = time.time() - t0
            print(f"Text table: {table.shape[0]} descriptions encoded in {table_seconds:.2f} s")
            frozen_params = {"text_table": table}
            embed_desc_fn = clip_utils.make_text_table_embed_fn(env.params.height)
        del clip_params

    cfg = PPOConfig(
        learning_rate=args.learning_rate, num_envs=args.num_envs, num_steps=args.num_steps,
        anneal_lr=args.anneal_lr, gamma=args.gamma, gae_lambda=args.gae_lambda,
        num_minibatches=args.num_minibatches, update_epochs=args.update_epochs,
        norm_adv=args.norm_adv, clip_coef=args.clip_coef, clip_vloss=args.clip_vloss,
        ent_coef=args.ent_coef, vf_coef=args.vf_coef, max_grad_norm=args.max_grad_norm,
        target_kl=args.target_kl, clip_mode="precomputed" if compute_clip else "none",
    )
    trainer = Trainer(
        cfg, env, num_iterations=args.num_iterations, disturbance=disturbance,
        features_fn=features_fn, embed_images_fn=embed_images_fn, embed_desc_fn=embed_desc_fn,
        embed_random_fn=embed_random_fn, clip_lambda=cc.clip_lambda,
        capture_env0=args.capture_video, frozen_params=frozen_params,
        mission_conditioning=args.mission_conditioning,
    )
    param_gen = torch.Generator()
    param_gen.manual_seed(args.seed)
    params = init_agent_params(param_gen, env.num_actions, device, in_channels=3,
                               mission_dim=env.mission_dim if args.mission_conditioning else 0)
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

    pipeline = LogPipeline(trainer, logger.handle)
    iteration = start_iteration
    while iteration <= args.num_iterations:
        if text_params is not None:
            # Split path: the host describes and tokenizes between the
            # rollout and the update, so it runs one iteration at a time.
            k = 1
            state, data, stats, desc = trainer.run_rollout_half(state)
            descriptions = minigrid_core.describe_rollout(
                state.vec_state.env.grid.cpu().numpy(), desc["agent_pos"].cpu().numpy(),
                desc["agent_dir"].cpu().numpy())
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
            save_checkpoint(checkpoint_path, state.params, state.opt_state, iteration - 1,
                            logger.global_step, args, b_returns=logger.b_returns,
                            learning_rate=trainer.learning_rate(iteration - 1))
    pipeline.flush()

    if args.save_model:
        save_checkpoint(checkpoint_path, state.params, state.opt_state, args.num_iterations,
                        logger.global_step, args, b_returns=logger.b_returns, final=True,
                        learning_rate=trainer.learning_rate(args.num_iterations))
    profiler.close()
    if recorder is not None:
        recorder.close()
    writer.close()
    return {
        "global_step": logger.global_step,
        "sps": logger.sps,
        "recent_returns": logger.last_returns[-100:],
        "run_name": run_name,
        "table_seconds": table_seconds,
        "distill_losses": distill_losses,
        "distill_seconds": distill_seconds,
        "view_mode": trainer.view_mode,
        "split_path": text_params is not None,
        "last_scalars": last_scalars,
    }


def main() -> None:
    train(flags.parse(Args))


if __name__ == "__main__":
    main()
