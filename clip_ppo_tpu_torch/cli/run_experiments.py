"""Experiment orchestrator: the reference's ablation grid, run as subprocesses.

Port of ``clip_ppo_tpu/cli/run_experiments.py`` (the reference's
`run_experiments.py:17-293`): the same grid — seeds (0, 42) × three ALE
games × {PPO clean / MODERATE / SEVERE, CLIP-PPO λ ∈ {1e-6, 1e-5, 1e-4} ×
{clean / MODERATE / SEVERE}, FROZEN_CLIP clean}, 78 runs, image modality
forced, save-freq 250k — the same flag translation, sequential subprocess
launches of the port's training CLIs (``clip_ppo_tpu_torch.cli.clip_ppo_atari``
or ``clip_ppo_minigrid``), rolling-average ETA and summary report, and the
same additions for unattended runs: ``--yes`` skips the confirmation,
``--dry-run`` prints the commands, ``--start-at`` resumes at a 1-based
index, ``--filter`` selects runs by substring. ``--num-devices`` above 1 is
refused by name, as the training CLIs refuse it.
"""

from __future__ import annotations

import subprocess
import sys
import time
from dataclasses import dataclass

from clip_ppo_tpu_torch.models.agent import AblationMode
from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity
from clip_ppo_tpu_torch.utils import flags


@dataclass
class ExperimentConfig:
    """Configuration for a single experiment."""

    run_name: str
    seed: int
    ablation_mode: AblationMode
    clip_lambda: float
    apply_disturbances: bool
    disturbance_severity: DisturbanceSeverity
    timesteps: int
    environment: str = "minigrid"  # "minigrid" or "atari"
    env_id: str = "BreakoutNoFrameskip-v4"


@dataclass
class RunnerArgs:
    yes: bool = False
    """skip the interactive confirmation"""
    dry_run: bool = False
    """print the commands without running anything"""
    start_at: int = 0
    """skip experiments before this 1-based index (crash recovery)"""
    filter: str = ""
    """only run experiments whose run_name contains this substring"""
    num_devices: int = 1
    """forwarded to every training CLI: data-parallel device count (more
    than one comes with the multi-GPU slice)"""


def build_command(config: ExperimentConfig, runner: RunnerArgs | None = None) -> list[str]:
    """Translate an ExperimentConfig into a training-CLI invocation
    (image modality forced like `run_experiments.py:37`)."""
    module = ("clip_ppo_tpu_torch.cli.clip_ppo_atari" if config.environment == "atari"
              else "clip_ppo_tpu_torch.cli.clip_ppo_minigrid")
    cmd = [
        sys.executable, "-m", module,
        "--env-id", config.env_id,
        "--run-name", config.run_name,
        "--seed", str(config.seed),
        "--clip-config.ablation-mode", config.ablation_mode.value.upper(),
        "--clip-config.clip-lambda", str(config.clip_lambda),
        "--clip-config.disturbance-severity", config.disturbance_severity.value.upper(),
        "--total-timesteps", str(config.timesteps),
        "--save-model",
        "--save-freq", "250000",
        "--clip-config.clip_modality", "image",
    ]
    if config.apply_disturbances:
        cmd.append("--clip-config.apply-disturbances")
    if runner is not None and runner.num_devices != 1:
        cmd += ["--num-devices", str(runner.num_devices)]
    return cmd


def run_experiment(config: ExperimentConfig, runner: RunnerArgs | None = None) -> bool:
    print(f"\n{'=' * 60}")
    print(f"Running: {config.run_name}")
    print(f"{'=' * 60}")
    cmd = build_command(config, runner)
    print(f"Command: {' '.join(cmd)}")
    print(f"Starting at: {time.strftime('%Y-%m-%d %H:%M:%S')}")
    start = time.time()
    try:
        subprocess.run(cmd, check=True)
        print(f"\n[ok] {config.run_name} completed in {(time.time() - start) / 60:.1f} min")
        return True
    except subprocess.CalledProcessError as e:
        print(f"\n[fail] {config.run_name} failed after {(time.time() - start) / 60:.1f} min: {e}")
        return False
    except KeyboardInterrupt:
        print(f"\n[interrupted] {config.run_name}")
        return False


def _setup_main_experiments() -> list[ExperimentConfig]:
    """The reference grid (`run_experiments.py:82-208`)."""
    experiments: list[ExperimentConfig] = []
    seeds = (0, 42)
    timesteps = {"minigrid": 1_000_000, "atari": 100_000}
    lambdas = (1e-06, 1e-05, 1e-04)
    environment = "atari"
    environment_ids = ["ALE/Breakout-v5", "ALE/Pong-v5", "ALE/Seaquest-v5"]
    none, moderate, severe = (DisturbanceSeverity.NONE, DisturbanceSeverity.MODERATE,
                              DisturbanceSeverity.SEVERE)

    def add(run_name, seed, env_id, ablation, lam, disturbed, severity):
        experiments.append(ExperimentConfig(
            run_name=run_name, seed=seed, ablation_mode=ablation, clip_lambda=lam,
            apply_disturbances=disturbed, disturbance_severity=severity,
            environment=environment, env_id=env_id, timesteps=timesteps[environment]))

    for seed in seeds:
        for env_id in environment_ids:
            base = f"s{seed}_{environment}_{env_id.replace('/', '')}"
            add(f"{base}_PPO_CLEAN", seed, env_id, AblationMode.NONE, 0.0, False, none)
            add(f"{base}_PPO_MODERATE", seed, env_id, AblationMode.NONE, 0.0, True, moderate)
            add(f"{base}_PPO_SEVERE", seed, env_id, AblationMode.NONE, 0.0, True, severe)
            for lam in lambdas:
                add(f"{base}_CLIPPPO_CLEAN_image_l{lam}", seed, env_id, AblationMode.NONE, lam,
                    False, none)
                add(f"{base}_CLIPPPO_MODERATE_image_l{lam}", seed, env_id, AblationMode.NONE,
                    lam, True, moderate)
                add(f"{base}_CLIPPPO_SEVERE_image_l{lam}", seed, env_id, AblationMode.NONE,
                    lam, True, severe)
            add(f"{base}_PPOFROZENCLIP_CLEAN", seed, env_id, AblationMode.FROZEN_CLIP,
                lambdas[-1], False, none)

    print(f"Generated {len(experiments)} total experiment combinations")
    return experiments


def main(argv=None) -> dict[str, bool] | None:
    args = flags.parse(RunnerArgs, argv)
    if args.num_devices != 1:
        raise SystemExit("--num-devices other than 1 is not ported yet: it comes with the "
                         "multi-GPU slice of the PyTorch/CUDA port")
    experiments = _setup_main_experiments()
    if args.filter:
        experiments = [e for e in experiments if args.filter in e.run_name]
        print(f"Filtered to {len(experiments)} experiments matching {args.filter!r}")

    print("Starting CLIP-PPO Experiments")
    print(f"Total experiments: {len(experiments)}")
    print("Estimated time per experiment: ~20 minutes")
    print(f"Total estimated time: ~{len(experiments) * 20:.0f} minutes")

    if args.dry_run:
        for config in experiments:
            print(" ".join(build_command(config, args)))
        return None

    if not args.yes:
        response = input("\nProceed with experiments? (y/N): ")
        if response.lower() != "y":
            print("Aborted.")
            return None

    results: dict[str, bool] = {}
    total_start = time.time()
    durations: list[float] = []

    for i, config in enumerate(experiments, 1):
        if i < args.start_at:
            continue
        print(f"\n>> Starting experiment {i}/{len(experiments)}")
        if durations:
            avg = sum(durations) / len(durations)
            remaining = avg * (len(experiments) - i)
            print(f"   Average per experiment: {avg / 60:.1f} minutes")
            print(f"   Estimated remaining: {remaining / 3600:.1f} hours")
            print("   Estimated completion: " + time.strftime(
                "%Y-%m-%d %H:%M:%S", time.localtime(time.time() + remaining)))
        t0 = time.time()
        success = run_experiment(config, args)
        durations.append(time.time() - t0)
        results[config.run_name] = success
        if not success and not args.yes:
            response = input(f"\nExperiment {config.run_name} failed. Continue with "
                             "remaining experiments? (y/N): ")
            if response.lower() != "y":
                print("Stopping experiments.")
                break

    print(f"\n{'=' * 60}")
    print("EXPERIMENT SUMMARY")
    print(f"{'=' * 60}")
    print(f"Total time: {(time.time() - total_start) / 60:.1f} minutes")
    print("\nResults:")
    successful = sum(bool(v) for v in results.values())
    for name, success in results.items():
        print(f"  {name}: {'SUCCESS' if success else 'FAILED'}")
    print(f"\nCompleted: {successful}/{len(results)} experiments")
    if results and successful == len(results):
        print("\nAll experiments completed successfully!")
        print("\nNext steps:")
        print("1. Run metrics analysis: python -m clip_ppo_tpu_torch.metrics.compare_algorithms")
        print("2. Generated runs are in: runs/")
        print("3. TensorBoard logs available for visualization")
    elif results:
        print(f"\n{len(results) - successful} experiments failed. Check logs for details.")
    return results


if __name__ == "__main__":
    main()
