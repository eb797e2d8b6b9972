"""One-command pretrained-weights robustness experiment.

Port of ``clip_ppo_tpu/cli/run_pretrained_robustness.py``. The reference's
claim — CLIP alignment improves robustness to visual disturbances
(DoorKey-6x6, HARD, CLIP-PPO λ = 1e-5, text modality) — can only be tested
with real CLIP weights. With OpenAI's ``ViT-B-32.pt`` under
``$CLIP_PPO_CHECKPOINT_DIR`` (or ``~/.cache/clip``), one command runs the
DoorKey robustness pair (clean and disturbed CLIP-PPO, the port's
``cli/clip_ppo_minigrid.train``) with the pretrained towers and reports the
robustness index and each run's normalized AUC, read back from the pair's
TensorBoard logs by the port's metrics:

    python -m clip_ppo_tpu_torch.cli.run_pretrained_robustness

``--synthesize-checkpoint`` first writes a random-weight archive in OpenAI's
exact format: a full rehearsal of the loader path where no real weights
exist. Runs on the GPU (``--no-cuda`` for the CPU); ``--tp`` and
``--num-devices`` above 1 are refused by name, as the training CLI refuses
them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from clip_ppo_tpu_torch.utils import flags


@dataclass
class Args:
    env_id: str = "MiniGrid-DoorKey-6x6-v0"
    """environment for the robustness pair"""
    seed: int = 0
    """seed shared by both runs"""
    total_timesteps: int = 1500000
    """timesteps per run (the reference claim used 1.5M on DoorKey)"""
    clip_model: str = "ViT-B/32"
    """CLIP variant; its checkpoint must be discoverable"""
    clip_lambda: float = 0.00001
    """CLIP alignment coefficient (reference claim value)"""
    clip_modality: str = "text"
    """alignment modality (reference MiniGrid default)"""
    disturbance_severity: str = "HARD"
    """severity of the disturbed run"""
    num_envs: int = 8
    """parallel environments"""
    num_steps: int = 128
    """rollout steps per iteration"""
    run_prefix: str = "pretrained"
    """prefix for the two run names"""
    tp: int = 1
    """tensor-parallel degree of the CLIP encode (more than one comes with
    the multi-GPU slice)"""
    num_devices: int = 1
    """device count (more than one comes with the multi-GPU slice)"""
    synthesize_checkpoint: bool = False
    """write a random-weight OpenAI-format archive first (loader drill
    when no real checkpoint exists)"""
    checkpoint_dir: str = ""
    """where to synthesize (defaults to $CLIP_PPO_CHECKPOINT_DIR)"""
    cuda: bool = True
    """run on the GPU (raises without one); --no-cuda runs on the CPU"""


def main(args: Args | None = None) -> dict:
    args = args or flags.parse(Args)
    if args.tp > 1 or args.num_devices > 1:
        raise SystemExit("--num-devices/--tp > 1 is not ported yet: it comes with the "
                         "multi-GPU slice of the PyTorch/CUDA port")

    from clip_ppo_tpu_torch.models.clip.loader import find_checkpoint

    if args.synthesize_checkpoint:
        from clip_ppo_tpu_torch.models.clip.synth_checkpoint import write_fake_openai_checkpoint

        ckpt_dir = args.checkpoint_dir or os.environ.get("CLIP_PPO_CHECKPOINT_DIR", "")
        if not ckpt_dir:
            raise SystemExit("--synthesize-checkpoint needs --checkpoint-dir or "
                             "$CLIP_PPO_CHECKPOINT_DIR")
        os.makedirs(ckpt_dir, exist_ok=True)
        fname = args.clip_model.replace("/", "-") + ".pt"
        path = write_fake_openai_checkpoint(os.path.join(ckpt_dir, fname), args.clip_model,
                                            seed=args.seed)
        os.environ["CLIP_PPO_CHECKPOINT_DIR"] = ckpt_dir
        print(f"Synthesized OpenAI-format checkpoint: {path}")

    ckpt = find_checkpoint(args.clip_model)
    if ckpt is None:
        raise SystemExit(
            f"No {args.clip_model} checkpoint found. Place OpenAI's "
            f"{args.clip_model.replace('/', '-')}.pt under "
            "$CLIP_PPO_CHECKPOINT_DIR or ~/.cache/clip, or pass "
            "--synthesize-checkpoint for a loader drill with random weights."
        )
    print(f"Using CLIP checkpoint: {ckpt}")

    from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as cpm
    from clip_ppo_tpu_torch.metrics.calculate_metrics import (
        compute_auc_metric,
        compute_robustness_index_over_time,
        load_tensorboard_run,
    )

    def run(disturbed: bool) -> str:
        tag = "disturbed" if disturbed else "clean"
        run_name = f"{args.run_prefix}_{args.env_id}_{tag}_s{args.seed}"
        targs = cpm.Args(
            env_id=args.env_id, seed=args.seed, total_timesteps=args.total_timesteps,
            num_envs=args.num_envs, num_steps=args.num_steps, tp=args.tp,
            num_devices=args.num_devices, cuda=args.cuda, capture_video=False, verbose=False,
            clip_config=cpm.MiniGridClipPPOConfig(
                clip_lambda=args.clip_lambda,
                clip_model=args.clip_model,
                clip_modality=args.clip_modality,
                apply_disturbances=disturbed,
                disturbance_severity=args.disturbance_severity,
            ),
        )
        print(f"=== {tag} run: {run_name} ===")
        cpm.train(targs, run_name=run_name)
        return f"runs/{run_name}"

    clean_dir = run(disturbed=False)
    disturbed_dir = run(disturbed=True)

    frame = compute_robustness_index_over_time(clean_dir, disturbed_dir)
    result = {
        "clean_run": clean_dir,
        "disturbed_run": disturbed_dir,
        "final_ri": float(frame["robustness_index"][-1]),
        "mean_ri": float(frame["robustness_index"].mean()),
        "clean_auc": compute_auc_metric(*load_tensorboard_run(clean_dir)[:2]),
        "disturbed_auc": compute_auc_metric(*load_tensorboard_run(disturbed_dir)[:2]),
        "checkpoint": ckpt,
    }
    print(f"DoorKey robustness pair complete: final RI {result['final_ri']:.3f}, mean RI "
          f"{result['mean_ri']:.3f}, AUC clean {result['clean_auc']:.4f} disturbed "
          f"{result['disturbed_auc']:.4f}")
    return result


if __name__ == "__main__":
    main()
