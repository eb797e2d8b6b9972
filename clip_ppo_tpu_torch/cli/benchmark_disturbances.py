"""Disturbance-pipeline benchmark: per-image against batched semantics.

Port of ``clip_ppo_tpu/cli/benchmark_disturbances.py`` (the reference's
`shared/benchmark_disturbances.py:19-126`): over batch sizes {1, 4, 8, 16,
32, 64} at HARD on 84×84×3 images, the per-image pipeline (the vanilla PPO
path, plain PyTorch) against the batched one (the CLIP-PPO path, one launch
of K1, ``csrc/disturb.cu``, on the GPU), each timed over ``--iterations``
chained calls, each call's output the next one's input and its draws taken
in the chain from a ``torch.Generator`` on the device, as the JAX scan
chains them. On the GPU a pair of CUDA events brackets the chain (after one
untimed chain as warm-up); on the CPU the host clock does.

Usage:
    python -m clip_ppo_tpu_torch.cli.benchmark_disturbances [--no-cuda]
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from clip_ppo_tpu_torch import cuda_build
from clip_ppo_tpu_torch.device import resolve_device
from clip_ppo_tpu_torch.ops.disturbances import disturb_auto
from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity, resolve_params
from clip_ppo_tpu_torch.utils import flags


@dataclass
class BenchArgs:
    batch_sizes: tuple[int, ...] = (1, 4, 8, 16, 32, 64)
    """batch sizes to sweep"""
    iterations: int = 50
    """timed iterations per batch size"""
    severity: str = "HARD"
    """severity preset"""
    height: int = 84
    """image height"""
    width: int = 84
    """image width"""
    channels: int = 3
    """image channels"""
    seed: int = 0
    """PRNG seed"""
    cuda: bool = True
    """run on the GPU (raises without one); --no-cuda runs on the CPU"""


def _time(fn, x: torch.Tensor, iterations: int) -> float:
    """Seconds per call of ``fn`` over a chain of ``iterations`` calls, each
    fed the previous output, after one untimed chain."""
    def chain():
        y = x
        for _ in range(iterations):
            y = fn(y)
        return y

    chain()
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chain()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iterations
    t0 = time.perf_counter()
    chain()
    return (time.perf_counter() - t0) / iterations


def benchmark_disturbances(args: BenchArgs) -> list[dict]:
    """One row a batch size: per-image and batched seconds a call in ms,
    the speed-up, and the K1 launches of the batched chains."""
    device = resolve_device(args.cuda)
    params = resolve_params(DisturbanceSeverity[args.severity])
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)

    def per_image(x):
        return disturb_auto(x, params, gen, semantics="per_image")

    def batched(x):
        return disturb_auto(x, params, gen, semantics="batched")

    rows = []
    print(f"Benchmarking severity={args.severity} "
          f"{args.height}x{args.width}x{args.channels}, "
          f"{args.iterations} iterations on {device.type}")
    print(f"{'batch':>6} {'per-image ms':>14} {'batched ms':>12} {'speedup':>8}")
    for b in args.batch_sizes:
        x = torch.rand((b, args.height, args.width, args.channels), generator=gen, device=device)
        t_per_image = _time(per_image, x, args.iterations)
        before = cuda_build.LAUNCHES.get("disturb", 0)
        t_batched = _time(batched, x, args.iterations)
        launches = cuda_build.LAUNCHES.get("disturb", 0) - before
        speedup = t_per_image / t_batched if t_batched > 0 else float("inf")
        print(f"{b:>6} {t_per_image * 1e3:>14.3f} {t_batched * 1e3:>12.3f} {speedup:>7.2f}x")
        rows.append({"batch": b, "per_image_ms": t_per_image * 1e3,
                     "batched_ms": t_batched * 1e3, "speedup": speedup, "launches": launches})
    return rows


def main(argv=None) -> list[dict]:
    return benchmark_disturbances(flags.parse(BenchArgs, argv))


if __name__ == "__main__":
    main()
