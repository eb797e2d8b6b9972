"""Vanilla PPO on MiniGrid — the port's counterpart of
``clip_ppo_tpu/cli/ppo_minigrid.py``, flag-compatible with the reference
`minigrid_experiments/ppo/ppo_minigrid.py`.

    python -m clip_ppo_tpu_torch.cli.ppo_minigrid --total-timesteps 250000

Runs on the GPU (``--cuda``, the default, raises without one) or on the CPU
with ``--no-cuda``. Without disturbances the Trainer takes the view fast
path (the Nature CNN on the raw 7×7 views, ``models/nature_cnn.py``);
``--apply-disturbances`` disturbs each observation with the reference's
per-image semantics (`ppo_minigrid.py:206-211,260-263`) in plain PyTorch,
which never reaches the batched K1 kernel.

TensorBoard tags, checkpoint payload and naming, derived batch sizes, the
save-frequency divisibility quirk and the CLI surface match the reference.
``--recurrent`` puts an LSTM between the trunk and the heads
(``models/recurrent.py``; ``--lstm-hidden`` wide), the agent the Memory
family needs; its update minibatches over envs, so ``--num-envs`` must be
divisible by ``--num-minibatches``. ``--mission-conditioning`` FiLM-conditions
the trunk on the env's structured instruction (``models/mission.py``), with
or without ``--recurrent``.

Checkpoints also carry the loop state (env state, observations,
``next_done`` and the generator's state) as ``torch_loop_state``, and under
``--recurrent`` the cell's carried (h, c) as ``lstm_carry_state``, the JAX
CLI's name, so ``--resume-checkpoint`` continues bit-identically with an
uninterrupted run. A JAX vanilla checkpoint resumes too: params, optimizer,
iteration, global step, the env state of its ``loop_state`` and its
``lstm_carry``, with the generator seeded from ``--seed`` (the JAX key has
no counterpart). The other way, checkpoints carry the env state in the
JAX CLI's ``loop_state`` as well, so the JAX CLI resumes them mid-episode;
its PRNG keys there are drawn from ``--seed`` and the global step. Options that need later slices of the port are refused by
name before any work.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.cli._logging import IterationLogger
from clip_ppo_tpu_torch.device import resolve_device
from clip_ppo_tpu_torch.envs.minigrid.core import EnvState
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv, VecState
from clip_ppo_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from clip_ppo_tpu_torch.io.tb_writer import SummaryWriter, hyperparameters_table
from clip_ppo_tpu_torch.io.tracking import ProfilerWindow, maybe_init_wandb
from clip_ppo_tpu_torch.io.video import VideoRecorder
from clip_ppo_tpu_torch.models.agent import init_agent_params
from clip_ppo_tpu_torch.models.recurrent import init_agent_params_recurrent
from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity, resolve_params
from clip_ppo_tpu_torch.train.ppo import PPOConfig
from clip_ppo_tpu_torch.train.runner import LogPipeline, Trainer, TrainState, chunk_length
from clip_ppo_tpu_torch.utils import flags


@dataclass
class Args:
    exp_name: str = "ppo_minigrid"
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
    env_id: str = "MiniGrid-Empty-16x16-v0"
    """the id of the environment"""
    total_timesteps: int = 5_000_000
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

    # Model saving arguments
    save_model: bool = True
    """whether to save model checkpoints"""
    save_freq: int = 100000
    """save model every N timesteps"""
    model_path: str = "checkpoints"
    """directory to save model checkpoints"""

    resume_checkpoint: str = ""
    """path to checkpoint file to resume training from; a checkpoint of this
    CLI restores params, optimizer and the loop state (env state,
    observations, next_done, generator), so the resumed run continues
    bit-identically with an uninterrupted one"""

    # Visual disturbance arguments
    apply_disturbances: bool = False
    """whether to apply visual disturbances during training"""
    disturbance_severity: str = "MILD"
    """disturbance severity level: MILD, MODERATE, SEVERE"""

    # Recurrent agent (no reference equivalent: its agents are all
    # feed-forward; the Memory family needs recurrence)
    recurrent: bool = False
    """insert an LSTM between the CNN trunk and the actor/critic heads
    (CleanRL ppo_atari_lstm-style; the agent MiniGrid-Memory needs)"""
    lstm_hidden: int = 128
    """LSTM hidden size for --recurrent"""

    # Mission conditioning (no reference equivalent: the reference drops the
    # mission through ImgObsWrapper, `ppo_minigrid.py:110`; models/mission.py)
    mission_conditioning: bool = False
    """FiLM-condition the policy/value trunk on the env's structured
    instruction (EnvState.target/instr/instr_state)"""

    # Options of the JAX package beyond the reference that come with a
    # later slice of the port and are refused until then.
    exploration_bonus: float = 0.0
    """β > 0 adds a SimHash count bonus (comes with the extensions slice)"""
    exploration_bits: int = 18
    """SimHash bucket bits for --exploration-bonus (table size 2^bits)"""
    episodic_bonus: float = 0.0
    """β_e > 0 adds an episodic first-visit bonus (comes with the extensions slice)"""
    bonus_decay: float = 0.0
    """> 0 anneals the total intrinsic reward to zero over that fraction of training"""
    num_devices: int = 1
    """data-parallel device count (more than one comes with the multi-GPU slice)"""
    distributed: bool = False
    """multi-host data-parallel training (multi-GPU slice)"""
    iterations_per_dispatch: int = 8
    """training iterations queued back to back before their logs are read"""

    # to be filled in runtime
    batch_size: int = 0
    """the batch size (computed in runtime)"""
    minibatch_size: int = 0
    """the mini-batch size (computed in runtime)"""
    num_iterations: int = 0
    """the number of iterations (computed in runtime)"""


def _reject_later_slices(args: Args) -> None:
    later = [
        (args.exploration_bonus > 0.0, "--exploration-bonus > 0", "the extensions slice"),
        (args.episodic_bonus > 0.0, "--episodic-bonus > 0", "the extensions slice"),
        (args.num_devices > 1 or (args.num_devices == 0 and torch.cuda.device_count() > 1),
         "--num-devices above 1", "the multi-GPU slice"),
        (args.distributed, "--distributed", "the multi-GPU slice"),
    ]
    for requested, what, slice_name in later:
        if requested:
            raise SystemExit(f"{what} is not ported yet: it comes with {slice_name} of "
                             "the PyTorch/CUDA port")
    if args.recurrent and args.num_envs % args.num_minibatches:
        raise SystemExit(f"--recurrent minibatches over envs: --num-envs {args.num_envs} is not "
                         f"divisible by --num-minibatches {args.num_minibatches}")


# -- the loop state a checkpoint carries (``torch_loop_state``) ---------------


def _loop_tree(state: TrainState) -> dict:
    vs = state.vec_state
    return {
        "vec_state": {
            "env": {f.name: getattr(vs.env, f.name) for f in dataclasses.fields(EnvState)},
            "episode_return": vs.episode_return,
            "episode_length": vs.episode_length,
        },
        "obs": state.obs,
        "next_done": state.next_done,
        "gen": state.gen.get_state(),
    }


def _jax_loop(state: TrainState, seed: int, global_step: int) -> dict:
    """The JAX vanilla CLI's ``loop`` payload of ``state``: its env state,
    observations and ``next_done``, with the per-env and the run's PRNG
    keys (which the port does not keep) drawn from ``seed`` and
    ``global_step``."""
    n = state.next_done.shape[0]
    keys = np.random.SeedSequence([seed, global_step]).generate_state(2 * (n + 1))
    return {"vec_state": convert.jax_vec_state(state.vec_state, keys[2:].reshape(n, 2)),
            "obs": state.obs.detach().cpu().numpy(),
            "next_done": state.next_done.detach().cpu().numpy().astype(np.float32),
            "key": keys[:2]}


def _with_loop(state: TrainState, loop: dict) -> TrainState:
    """The loop state of a checkpoint of this CLI; one written before the
    env state carried ``target``, ``instr`` or ``instr_state`` restores the
    zeros of every family without them."""
    vs = loop["vec_state"]
    env = dict(vs["env"])
    for name in ("target", "instr", "instr_state"):
        if name not in env:
            env[name] = torch.zeros_like(getattr(state.vec_state.env, name))
    state.gen.set_state(loop["gen"])
    return dataclasses.replace(
        state,
        vec_state=VecState(env=EnvState(**env), episode_return=vs["episode_return"],
                           episode_length=vs["episode_length"]),
        obs=loop["obs"], next_done=loop["next_done"],
    )


def _with_jax_loop(state: TrainState, loop: dict, trainer: Trainer, seed: int) -> TrainState:
    """The env state of a JAX vanilla checkpoint's ``loop_state``, with the
    observations observed anew; the generator keeps its ``--seed`` state."""
    vs = convert.vec_state(loop["vec_state"], trainer.env.device)
    if vs.env.grid.shape != state.vec_state.env.grid.shape:
        raise ValueError(f"the checkpoint's env state has grids {tuple(vs.env.grid.shape)} where "
                         f"this run has {tuple(state.vec_state.env.grid.shape)}")
    env = trainer.env
    obs = env.observe_view_fn(vs) if trainer.view_mode else env.observe_fn(vs)
    next_done = torch.as_tensor(np.array(loop["next_done"]), dtype=torch.float32,
                                device=env.device)
    print(f"Resumed the JAX package's env state; its PRNG key and per-env rng have no "
          f"counterpart here, so the generator is seeded from --seed {seed}")
    return dataclasses.replace(state, vec_state=vs, obs=obs, next_done=next_done)


def train(args: Args, run_name: Optional[str] = None) -> dict:
    """Run training; returns summary stats (for tests/benchmarks)."""
    args.batch_size = int(args.num_envs * args.num_steps)
    args.minibatch_size = int(args.batch_size // args.num_minibatches)
    args.num_iterations = args.total_timesteps // args.batch_size
    _reject_later_slices(args)
    device = resolve_device(args.cuda)
    run_name = run_name or f"{args.env_id}__{args.exp_name}__{args.seed}__{int(time.time())}"

    maybe_init_wandb(args, run_name)
    writer = SummaryWriter(f"runs/{run_name}")
    recorder = VideoRecorder(f"videos/minigrid/ppo/{run_name}") if args.capture_video else None
    profiler = ProfilerWindow(args.profile_dir)
    writer.add_text("hyperparameters", hyperparameters_table(dataclasses.asdict(args)))

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    torch.backends.cudnn.deterministic = args.torch_deterministic

    env = TorchVectorEnv(args.env_id, args.num_envs, device)
    cfg = PPOConfig(
        learning_rate=args.learning_rate, num_envs=args.num_envs, num_steps=args.num_steps,
        anneal_lr=args.anneal_lr, gamma=args.gamma, gae_lambda=args.gae_lambda,
        num_minibatches=args.num_minibatches, update_epochs=args.update_epochs,
        norm_adv=args.norm_adv, clip_coef=args.clip_coef, clip_vloss=args.clip_vloss,
        ent_coef=args.ent_coef, vf_coef=args.vf_coef, max_grad_norm=args.max_grad_norm,
        target_kl=args.target_kl,
    )

    disturbance = None
    if args.apply_disturbances:
        # The vanilla script uses the per-image pipeline
        # (`ppo_minigrid.py:206-211,260-263`).
        disturbance = resolve_params(DisturbanceSeverity[args.disturbance_severity])
        print(f"Disturbances enabled with severity: {args.disturbance_severity}")
    else:
        print("Disturbances disabled")

    trainer = Trainer(cfg, env, num_iterations=args.num_iterations, disturbance=disturbance,
                      disturbance_semantics="per_image", capture_env0=args.capture_video,
                      recurrent=args.recurrent, mission_conditioning=args.mission_conditioning)
    param_gen = torch.Generator()
    param_gen.manual_seed(args.seed)
    mission_dim = env.mission_dim if args.mission_conditioning else 0
    if args.recurrent:
        params = init_agent_params_recurrent(param_gen, env.num_actions, device, in_channels=3,
                                             lstm_hidden=args.lstm_hidden, mission_dim=mission_dim)
    else:
        params = init_agent_params(param_gen, env.num_actions, device, in_channels=3,
                                   mission_dim=mission_dim)
    state = trainer.init_state(params, args.seed)

    def extras(st: TrainState) -> dict:
        """The checkpoint's payload beyond params and optimizer: the loop
        state, and the LSTM agent's carried (h, c) under the JAX CLI's
        name ``lstm_carry``."""
        out = {"torch_loop": _loop_tree(st)}
        if st.lstm_state is not None:
            out["lstm_carry"] = st.lstm_state
        return out

    checkpoint_path = None
    if args.save_model:
        os.makedirs(args.model_path, exist_ok=True)
        checkpoint_path = os.path.join(args.model_path, run_name)

    start_iteration, global_step = 1, 0
    if args.resume_checkpoint:
        params, opt_state, it, global_step, raw = load_checkpoint(
            args.resume_checkpoint, state.params, state.opt_state, device,
            extra_templates=extras(state))
        state = dataclasses.replace(state, params=params, opt_state=opt_state)
        restored = raw.get("extras", {})
        if "torch_loop" in restored:
            state = _with_loop(state, restored["torch_loop"])
        elif raw.get("loop_state") is not None:
            state = _with_jax_loop(state, raw["loop_state"], trainer, args.seed)
        if "lstm_carry" in restored:
            state = dataclasses.replace(state, lstm_state=tuple(restored["lstm_carry"]))
        start_iteration = it + 1

    last_scalars: dict = {}
    logger = IterationLogger(
        writer, profiler, recorder, num_envs=args.num_envs, batch_size=args.batch_size,
        num_iterations=args.num_iterations,
        verbose_fn=lambda it, scalars: last_scalars.update(scalars),
    )
    logger.global_step = global_step  # 0 or the resumed checkpoint's

    def save(iteration: int, final: bool = False) -> None:
        save_checkpoint(checkpoint_path, state.params, state.opt_state, iteration,
                        logger.global_step, args, b_returns=logger.b_returns, final=final,
                        learning_rate=trainer.learning_rate(iteration),
                        extra_models=extras(state),
                        jax_loop=_jax_loop(state, args.seed, logger.global_step))

    # Iterations queued back to back in chunks that end at checkpoint
    # boundaries, each chunk's logs fetched after the next is queued.
    pipeline = LogPipeline(trainer, logger.handle)
    iteration = start_iteration
    while iteration <= args.num_iterations:
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
        "episodes": len(logger.last_returns),
        "episode_returns": list(logger.last_returns),
        "run_name": run_name,
        "view_mode": trainer.view_mode,
        "recurrent": trainer.recurrent,
        "mission_conditioning": trainer.mission_conditioning,
        "last_scalars": last_scalars,
    }


def main() -> None:
    train(flags.parse(Args))


if __name__ == "__main__":
    main()
