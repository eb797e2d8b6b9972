"""Vanilla PPO on Atari — the port's counterpart of
``clip_ppo_tpu/cli/ppo_atari.py``, flag-compatible with the reference
`atari_experiments/ppo/ppo_atari.py`.

    python -m clip_ppo_tpu_torch.cli.ppo_atari --env-id ALE/Pong-v5

Runs on the GPU (``--cuda``, the default, raises without one) or on the CPU
with ``--no-cuda``. The games are the port's native Breakout, Pong and
Seaquest (``envs/atari``) batched on the device with the 4-frame stack, so
the rollout, GAE and the 4×4 minibatch update never leave it; no kernel of
the port runs on this path (the Nature CNN is cuDNN's). Like the reference
script: no disturbances, no checkpointing, the same hyperparameters and
TensorBoard tags, and CleanRL's per-episode print. The host/ALE backend
(``--env-backend ale``) and more than one device are refused by name.
"""

from __future__ import annotations

import dataclasses
import random
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from clip_ppo_tpu_torch.cli._logging import IterationLogger
from clip_ppo_tpu_torch.device import resolve_device
from clip_ppo_tpu_torch.envs.atari.vector import AtariVectorEnv
from clip_ppo_tpu_torch.io.tb_writer import SummaryWriter, hyperparameters_table
from clip_ppo_tpu_torch.io.tracking import ProfilerWindow, maybe_init_wandb
from clip_ppo_tpu_torch.io.video import VideoRecorder
from clip_ppo_tpu_torch.models.agent import init_agent_params
from clip_ppo_tpu_torch.train.ppo import PPOConfig
from clip_ppo_tpu_torch.train.runner import LogPipeline, Trainer, chunk_length
from clip_ppo_tpu_torch.utils import flags


@dataclass
class Args:
    exp_name: str = "ppo_atari"
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

    num_devices: int = 1
    """data-parallel device count (more than one comes with the multi-GPU slice)"""
    distributed: bool = False
    """multi-host data-parallel training (multi-GPU slice)"""
    iterations_per_dispatch: int = 8
    """training iterations queued back to back before their logs are read"""
    env_backend: str = "jax"
    """'jax' = the native games batched on the device (the JAX package's
    name for them); 'ale' = the host-side emulator (comes with the host/ALE
    slice)"""

    # to be filled in runtime
    batch_size: int = 0
    """the batch size (computed in runtime)"""
    minibatch_size: int = 0
    """the mini-batch size (computed in runtime)"""
    num_iterations: int = 0
    """the number of iterations (computed in runtime)"""


def reject_later_slices(args) -> None:
    """Refuse, by name and before any work, what the Atari CLIs take that
    later slices of the port bring."""
    later = [
        (args.env_backend == "ale", "--env-backend ale",
         "the host/ALE slice (ROADMAP.md Queue 1 item 9)"),
        (args.num_devices > 1 or (args.num_devices == 0 and torch.cuda.device_count() > 1),
         "--num-devices above 1", "the multi-GPU slice"),
        (args.distributed, "--distributed", "the multi-GPU slice"),
    ]
    for requested, what, slice_name in later:
        if requested:
            raise SystemExit(f"{what} is not ported yet: it comes with {slice_name} of "
                             "the PyTorch/CUDA port")
    if args.env_backend not in ("jax", "ale"):
        raise SystemExit(f"unknown --env-backend {args.env_backend!r} (jax or ale)")


def train(args: Args, run_name: Optional[str] = None) -> dict:
    """Run training; returns summary stats (for tests and benchmarks)."""
    args.batch_size = int(args.num_envs * args.num_steps)
    args.minibatch_size = int(args.batch_size // args.num_minibatches)
    args.num_iterations = args.total_timesteps // args.batch_size
    reject_later_slices(args)
    device = resolve_device(args.cuda)
    run_name = run_name or f"{args.env_id}__{args.exp_name}__{args.seed}__{int(time.time())}"

    maybe_init_wandb(args, run_name)
    writer = SummaryWriter(f"runs/{run_name}")
    recorder = VideoRecorder(f"videos/atari/{run_name}") if args.capture_video else None
    profiler = ProfilerWindow(args.profile_dir)
    writer.add_text("hyperparameters", hyperparameters_table(dataclasses.asdict(args)))

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    torch.backends.cudnn.deterministic = args.torch_deterministic

    cfg = PPOConfig(
        learning_rate=args.learning_rate, num_envs=args.num_envs, num_steps=args.num_steps,
        anneal_lr=args.anneal_lr, gamma=args.gamma, gae_lambda=args.gae_lambda,
        num_minibatches=args.num_minibatches, update_epochs=args.update_epochs,
        norm_adv=args.norm_adv, clip_coef=args.clip_coef, clip_vloss=args.clip_vloss,
        ent_coef=args.ent_coef, vf_coef=args.vf_coef, max_grad_norm=args.max_grad_norm,
        target_kl=args.target_kl,
    )
    env = AtariVectorEnv(args.env_id, args.num_envs, device)
    trainer = Trainer(cfg, env, num_iterations=args.num_iterations,
                      capture_env0=args.capture_video)
    param_gen = torch.Generator()
    param_gen.manual_seed(args.seed)
    params = init_agent_params(param_gen, env.num_actions, device, in_channels=4)
    state = trainer.init_state(params, args.seed)

    last_scalars: dict = {}
    logger = IterationLogger(
        writer, profiler, recorder, num_envs=args.num_envs, batch_size=args.batch_size,
        num_iterations=args.num_iterations,
        echo_episodes=True,  # CleanRL's vanilla-Atari per-episode print
        verbose_fn=lambda it, scalars: last_scalars.update(scalars),
    )

    # Iterations queued back to back, each chunk's logs fetched after the
    # next is queued. No checkpoints (like the reference), so chunks only
    # cap at the last iteration.
    pipeline = LogPipeline(trainer, logger.handle)
    iteration = 1
    while iteration <= args.num_iterations:
        k = chunk_length(args.iterations_per_dispatch, iteration, args.num_iterations,
                         (iteration - 1) * args.batch_size, args.batch_size,
                         save_freq=1, save_model=False)
        state, packed = trainer.run_iterations(state, iteration, k)
        pipeline.after_dispatch(iteration, packed)
        iteration += k
    pipeline.flush()

    profiler.close()
    if recorder is not None:
        recorder.close()
    writer.close()
    return {
        "global_step": logger.global_step,
        "sps": logger.sps,
        "recent_returns": logger.last_returns[-100:],
        "episodes": len(logger.last_returns),
        "run_name": run_name,
        "last_scalars": last_scalars,
    }


def main() -> None:
    train(flags.parse(Args))


if __name__ == "__main__":
    main()
