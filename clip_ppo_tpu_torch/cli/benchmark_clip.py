"""CLIP encoder throughput: frames/sec/chip (and text sequences/sec) — the
port's counterpart of ``clip_ppo_tpu/cli/benchmark_clip.py``.

Times the image tower (preprocessing included — /255, antialiased resize to
the tower's input size, normalization, exactly the training path) and the
text tower at growing batch sizes. Flags and defaults are the JAX tool's,
plus ``--cuda``/``--no-cuda``:

    python -m clip_ppo_tpu_torch.cli.benchmark_clip --model ViT-L/14 \\
        --dtype float32 --batch-sizes 256

Runs on the GPU (``--cuda``, the default, raises without one) or on the CPU
with ``--no-cuda`` (the kernels' plain versions). ``--attention-impl``
routes the towers as ``models/clip/model.py`` describes: at ViT-L/14 "auto"
runs K4 and K5 in the vision tower and K2 and K5 in the text tower; "pallas"
runs K8 in the vision tower. As in the JAX tool, the text half always runs
"auto". Float32 only: ``--dtype bfloat16`` (the JAX tool's default),
``--tp``/``--num-devices`` above 1 and ViT-B/16 on the GPU are rejected,
each naming the slice of ``ROADMAP.md`` that brings it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from clip_ppo_tpu_torch.device import resolve_device
from clip_ppo_tpu_torch.models.clip.config import CLIP_CONFIGS
from clip_ppo_tpu_torch.models.clip.loader import load_clip_model
from clip_ppo_tpu_torch.models.clip.model import encode_image, encode_text
from clip_ppo_tpu_torch.ops.resize import preprocess_for_clip
from clip_ppo_tpu_torch.utils import flags


@dataclass
class ClipBenchArgs:
    model: str = "ViT-B/32"
    """CLIP variant: ViT-B/32, ViT-B/16, ViT-L/14"""
    batch_sizes: tuple[int, ...] = (64, 256, 1024, 4096)
    """image batch sizes to sweep"""
    text_batch: int = 1024
    """text batch size ([B, 77] tokens)"""
    iterations: int = 10
    """timed iterations"""
    source_size: int = 84
    """input frame size before the fused resize (the rollout frame size)"""
    dtype: str = "bfloat16"
    """compute dtype: bfloat16 | float32 (the port runs float32 only so far)"""
    attention_impl: str = "auto"
    """attention implementation: auto | fused | block | xla | packed2 |
    packed4 | pallas (see models/clip/model.py)"""
    seed: int = 0
    """seed of the random weights (when no checkpoint is found) and inputs"""
    tp: int = 1
    """tensor-parallel degree (multi-GPU: not ported yet, must be 1)"""
    num_devices: int = 0
    """devices for the (dp, tp) mesh (multi-GPU: not ported yet, 0 or 1)"""
    cuda: bool = True
    """run on the GPU (raises without one); --no-cuda runs on the CPU"""


_IMPLS = ("auto", "fused", "block", "xla", "pallas")


def _reject_unported(args: ClipBenchArgs, device: torch.device) -> None:
    """Options that need later slices of the port, by name, before any tower
    is built."""
    if args.dtype != "float32":
        raise SystemExit(
            f"--dtype {args.dtype}: the port runs float32 only so far; bfloat16 (the JAX "
            "tool's default) comes with the FROZEN_CLIP/bf16 slice (ROADMAP.md Queue 1 "
            "item 3). Pass --dtype float32.")
    if args.tp > 1 or args.num_devices > 1:
        raise SystemExit(
            f"--tp {args.tp} --num-devices {args.num_devices}: multi-GPU runs come with "
            "the multi-GPU slice (ROADMAP.md Queue 1 item 9); the port runs on one device.")
    if args.model == "ViT-B/16" and device.type == "cuda":
        raise SystemExit(
            "--model ViT-B/16 on the GPU needs K2 at T = 197 tokens, which comes with the "
            "ViT-B/16 slice (ROADMAP.md Queue 1 item 4); run it with --no-cuda.")
    if args.model not in CLIP_CONFIGS:
        raise SystemExit(f"--model {args.model}: one of {', '.join(CLIP_CONFIGS)}")
    impl = args.attention_impl
    if impl not in _IMPLS and not (impl.startswith("packed") and impl[6:] in ("", *"123456789")):
        raise SystemExit(f"--attention-impl {impl}: one of {', '.join(_IMPLS)}, packedN")


def _bench(fn, data: torch.Tensor, iterations: int) -> float:
    """Seconds per call of ``fn``: one warm-up call, then ``iterations``
    calls, each on its input perturbed by the previous output (so no call
    can be skipped or overlapped with its successor), ended by fetching one
    dependent scalar to the host."""
    carry = fn(data).flatten()[0]
    float(carry)
    t0 = time.perf_counter()
    for _ in range(iterations):
        carry = fn(data + (carry != 0.5).to(data.dtype)).flatten()[0]
    float(carry)
    return (time.perf_counter() - t0) / iterations


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = flags.parse(ClipBenchArgs, argv)
    device = resolve_device(args.cuda)
    _reject_unported(args, device)
    params, cfg = load_clip_model(args.model, device, pretrained="auto", seed=args.seed)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"model={args.model} dtype={args.dtype} device={device.type} ({kind})")

    def image_fwd(frames: torch.Tensor) -> torch.Tensor:
        x = preprocess_for_clip(frames.float() / 255.0, cfg.image_size)
        return encode_image(params, cfg, x, attention_impl=args.attention_impl)

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    print(f"{'batch':>6} {'ms/batch':>10} {'frames/s/chip':>14}")
    with torch.no_grad():
        for b in args.batch_sizes:
            frames = torch.randint(0, 255, (b, args.source_size, args.source_size, 3),
                                   generator=gen, device=device, dtype=torch.uint8)
            t = _bench(image_fwd, frames, args.iterations)
            print(f"{b:>6} {t * 1e3:>10.2f} {b / t:>14.0f}")

        toks = torch.randint(1, cfg.vocab_size - 2, (args.text_batch, cfg.context_length),
                             generator=gen, device=device)
        toks[:, 0] = cfg.vocab_size - 2
        toks[:, -1] = cfg.vocab_size - 1
        # The perturbation lifts the last token to vocab_size; the JAX tool's
        # gather clamps such an index, so the port clamps it explicitly.
        t = _bench(lambda z: encode_text(params, cfg, z.clamp(max=cfg.vocab_size - 1)), toks,
                   args.iterations)
    print(f"text  batch={args.text_batch}: {t * 1e3:.2f} ms/batch "
          f"({args.text_batch / t:.0f} seqs/s/chip)")


if __name__ == "__main__":
    main()
