#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``clip_ppo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its findings on its own lines; any failure exits
non-zero at once:

1. card — the GPU's name and power limit (nvidia-smi), and the build of
   every hand-written kernel from ``clip_ppo_tpu_torch/csrc/`` with each
   kernel's registers and spills; the tensor-core instructions (HMMA,
   HGMMA) of each kernel in the libraries that run on the tensor cores
   (``TENSOR_CORE_LIBS``: K4/K8, K2, K3, K5, K6, K7), which must hold some
   and spill nothing, each bf16 instantiation (``BF16_TENSOR_CORE``) its
   own;
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it (K2 and K3 at [1024,77,512] for the
   text tables and the split paths, and at a table's last batch of 1,024:
   [420,77,512] for FourRooms, [912,77,512] for BabyAI-GoTo and BossLevel, and
   MiniBossLevel's whole table, [324,77,512]; a row of
   ``BLOCK_CASES`` stands for one path or a tuple of them): K1 at every severity, at the shapes
   of ``K1_CASES`` (a ragged band, one channel, bands thinner than the
   halo, clusters of 8) and in the main path's mode, noise drawn in the
   kernel, against the plain version fed the kernel's own normals (the
   rollout's [8,84,84,3] and an Atari frame's [8,84,84,1]); timed with
   clusters of 16 and of 8 CTAs beside an empty kernel on the same grid,
   and its device time with fewer CTAs, without drawing the noise and at
   other tap counts, and at [8,84,84,1]. ``BLOCK_CASES``: K2, K3 and K5 with random
   LayerNorm affines and biases; K2 at the text, the vision and ViT-L/14's
   text tower's shapes, at ViT-B/16's T = 197 and at K6's [256, 257, 1024];
   K5 also at ViT-L/14's two widths and at a ragged row count; K3 at a
   ragged row count; K2, K3 and K5 at widths whose products end in a
   partial column tile. K4 at ViT-L/14's vision tower, at ViT-B/32's towers
   and at a ragged batch, and once with inputs x 4; K8 fed strided views of
   one qkv buffer. Each with its median time per call (CUDA events; K1, K4
   and K8 over back-to-back calls; K1, K2, K4, K5 and K8 beside their
   profiled device time, the resblock halves split by kernel and beside the
   SM clock and power draw sampled while they were timed), the plain
   version's time, the least time the card could take (for the tensor-core
   kernels, 3xTF32 work at the TF32 peak, the fp32 CUDA-core bound beside)
   and, for K4 and K8, the time of ``scaled_dot_product_attention`` on the
   same q/k/v; then K6 and K7 at ViT-L/14's shapes, at ragged ones and at
   widths whose products end in a partial column tile (``STREAM_CASES``),
   K6 timed beside K2 and beside the route it replaces, K7 beside K5 on the
   same inputs, and K6, K7 and K3 refusing a width their kernels do not
   take. Every resblock-half case prints the device memory its wrapper
   allocates besides the output (scratch), and K7's must not exceed one
   [B*T, D] chunk of the hidden plus the row statistics. Then every kernel
   but K1 in bfloat16 (its bf16 entry point) against its plain bf16 version
   at the FROZEN_CLIP trunk's, the bf16 encoder benchmarks' and odd shapes
   (``BF16_CASES``, the Atari image modality's [4096,50,768] and its
   FROZEN_CLIP rollout's [32,50,768] among them; tolerance (1/64) x
   max(1, max |ref|)), timed beside its device time, the plain (cuBLAS
   bf16) route and the float32 kernel on the same values, against the
   dense bf16 peak;
3. text slice — the CLIP-PPO MiniGrid CLI (text modality, HARD
   disturbances) for two iterations, with every launch count read from the
   run;
4. text profile — one steady iteration of the same configuration timed by
   part, and the device's busy share from a torch.profiler trace, with the
   device time of each ported kernel (``ENTRY_POINTS``);
5. image slice — the same CLI with the image modality (the ViT-B/32 vision
   tower encodes each iteration's 1,024 frames) for two iterations, with
   its launch counts, and the tower's embeddings of a few frames on the
   card against the plain versions on the CPU;
6. image profile — one steady image-modality iteration by part, and the
   device's busy share and time by ported kernel;
7. vanilla — vanilla PPO (``cli/ppo_minigrid.py``): the view trunk against
   the dense conv (features and gradients) and the per-image disturbance
   against the CPU on the same draws, on the card; the per-image
   disturbance's time per rollout step beside K1's batched call; the CLI
   for two iterations in view mode and two under per-image HARD
   disturbances, with no kernel launched (per-image never reaches K1), view
   mode on and off as expected and finite losses; one steady iteration of
   each by part, with the device's busy share;
8. encoder benchmark — the port's ``cli/benchmark_clip.py`` at ViT-L/14 in
   float32 (K4 + K5 in the vision tower, K2 + K5 in the text tower), then at
   ViT-B/32 with ``--attention-impl pallas`` (K8 in the vision tower), with
   the launches of every call counted; then at ViT-L/14 under each of the
   JAX package's weight-streaming switches (``CLIP_PPO_ATTN_STREAM=1``: K6;
   ``CLIP_PPO_MLP_CHUNKED=1``: K7; both; ``CLIP_PPO_MLP_STREAM=0``: the
   plain MLP), one batch size and 2 iterations each, launches checked, and
   the image call's time under each beside the default route's;
9. large tower — ViT-L/14's embeddings of two frames on the card, on the
   default route and under both switches, against the plain versions on the
   CPU, and where one batch-256 image call of each spends its device time,
   by kernel and by ported kernel;
10. ablations — the CLIP-PPO CLI with ``--clip-config.ablation-mode
    FROZEN_CLIP`` (the bf16 ViT-B/32 vision tower as the trunk) and
    ``RANDOM_ENCODER`` (λ = 1e-5), HARD disturbances, two iterations each,
    every launch count derived from the configuration (FROZEN_CLIP: K2 and
    K3 in bf16 once a layer for every rollout step, the bootstrap value and
    every minibatch; RANDOM_ENCODER: no tower kernel), finite losses; the
    bf16 tower's features of a few frames on the card against the plain
    bf16 route on the CPU; one steady FROZEN_CLIP iteration by part with the
    device's busy share; and ``benchmark_clip`` at its default bf16 at
    ViT-B/32 (both towers on K2 and K3 in bf16), launches of every call
    checked;
11. atari — ``cli/ppo_atari.py`` for two iterations on each of Breakout,
    Pong and Seaquest (no kernel launched, finite losses), then
    ``cli/clip_ppo_atari.py`` for two iterations in each mode of
    ``ATARI_RUNS`` (the image modality at its defaults: 1,024 stacks of 4
    frames through the bf16 ViT-B/32 tower, K2 and K3 in bf16 at
    [4096,50,768] 12 times an iteration; HARD ``stack_frames`` disturbances
    on Pong, K1 512 times an iteration; the text modality's split path, K2
    and K3 in fp32; FROZEN_CLIP, 1,740 of each in bf16; RANDOM_ENCODER in
    both modalities, none), launch counts from the configuration
    (:func:`atari_launches`), the CLIP loss > 0 (0 under FROZEN_CLIP), each
    run's second iteration clocked for its steady env-steps/s;
    ``stack_frames`` on the card against the CPU on the same noise, and the
    four frames' in-kernel noise shown to differ; the multi-frame bf16
    features of two stacks against the plain bf16 route on the CPU; one
    steady image-modality iteration by part, with the device's busy share,
    its kernels and its device time by ported kernel.

12. pipeline — the experiment pipeline: (a) ``run_pretrained_robustness
    --synthesize-checkpoint`` on DoorKey-6x6, text modality, 3 iterations a
    run: the full ViT-B/32 archive synthesized and taken by the loader, the
    clean and HARD runs' launches (K2 and K3 12 each at a run's start, K1 128
    an iteration in the disturbed run only), the severities read back from
    the logs, RI and AUC finite; (b) the CLI under FROZEN_CLIP with
    ``--clip-config.structured-frozen-init`` for two iterations: the
    distillation's MSE at its first and last step (it must fall), K2 and K3
    in bf16 as phase 10 counts them; (c) ``benchmark_disturbances`` at its
    defaults, per-image against batched at batch 1 to 64, K1's launches,
    and at each batch size K1 against its plain version, timed with its
    bound; (d) ``run_experiments --dry-run`` (78 commands on the port's
    modules), then the command ``build_command`` gives for CLIP-PPO SEVERE
    in the image modality on Breakout, cut to 3 iterations, as a subprocess,
    its log read by the port's metrics; (e) ``disturbances_test``'s panels on
    the card against the CPU. Nothing of it needs tensorboard, pandas,
    matplotlib or PIL.

13. families — the classic MiniGrid families (FourRooms, LavaGap, DistShift,
    MultiRoom, the crossings, Dynamic-Obstacles, Unlock and its variants,
    ObstructedMaze-1Dl, KeyCorridor, LockedRoom, RedBlueDoors): (a) the
    reset of each family's largest id (``FAMILY_RUNS``, and Unlock), drawn on
    the card and copied to the CPU, with crafted states facing each success
    target, stepped 24 times on
    the card and on the CPU with the same actions and ball draws: views,
    states and flags equal, rewards equal as float32, a success reached in
    each; (b) ``ppo_minigrid`` for 2 iterations on four of them
    (``FAMILY_VANILLA``), its steady
    env-steps/s, and the kernels a rollout step launches (the rollout's bulk
    reset included) from two short traces; (c) ``clip_ppo_minigrid``
    in the text modality under HARD on FourRooms (the 1,444-row table, K2
    and K3 24 times at startup, none an iteration) and on MultiRoom-N6 (the
    split path, K2 and K3 12 times an iteration), the host's describe and
    tokenize and the encode timed per iteration; (d) the image modality
    under HARD on LavaCrossingS9N1. K1 128 times an iteration in (c) and
    (d).

14. missions — the mission families (GoToDoor, Fetch, GoToObject,
    PutNear), Memory, Playground and the full ObstructedMaze, and
    ``--recurrent``: (a) as 13a on the largest id of each
    (``MISSION_RUNS``), the crafted states facing each mission's target
    (``done`` at GoToDoor's door and GoToObject's object, Fetch's pickup,
    PutNear's drop beside its near object, Memory's success cell) with
    ``EnvState.target`` carried, a success reached in each but Playground,
    which has none; (b) as 13b on three (``MISSION_VANILLA``); (c)
    ``ppo_minigrid --recurrent`` on MemoryS7 (the LSTM agent, no kernel) for
    2 iterations, and one steady iteration's rollout and update timed apart,
    with the kernels each
    launches (from traces of 4- and 8-step iterations, extrapolated to 128
    steps); (d) ``clip_ppo_minigrid`` in the text modality under HARD on
    GoToDoor-8x8, whose left-wall door varies the description's suffix:
    the split path, K2 and K3 at [1024,77,512] 12 times an iteration and K1
    128 times, each held against its plain version in phase 2 (path
    ``gotodoor``); (e) the image modality under HARD on
    ObstructedMaze-1Q (opaque walls).

15. babyai — the BabyAI levels that ``EnvState.target`` decides: (a) as
    13a on one id of each generator (``BABYAI_RUNS``), with crafted states
    for each of the six success modes (``done`` facing a GoTo target, a
    drop beside PutNext's fixed object, a matching pickup, a toggle of the
    mission's door — its key in hand where it is locked — and
    ActionObjDoor's verb on its object) and PickupDistDebug's strict
    failure, a success reached in each; (b) as 13b on the largest
    (``BABYAI_VANILLA``), the bulk reset's launches beside a step's;
    (c) ``clip_ppo_minigrid`` in the text modality under HARD on
    BabyAI-GoTo (22×22, whose x = 0 column is wall in every reset: the
    1,936-row table, K2 and K3 12 times each at [1024,77,512] and at
    [912,77,512] at startup, path ``babyai_text``)
    and (d) the image modality under HARD on BabyAI-OpenDoorLoc (K2 and K5
    12 times an iteration, path ``babyai_image``), K1 128 times an
    iteration in each; each kernel is held against its plain version at
    those shapes in phase 2.

16. seq — BabyAI's composite instructions and ``--mission-conditioning``:
    (a) as 13a on one id of each generator and size (``SEQ_RUNS``: BossLevel,
    MiniBossLevel, SynthSeq, GoToSeqS5R2, MoveTwoAcrossS8N9,
    OpenRedBlueDoorsDebug, OpenDoorsOrderN4Debug, PickupLoc), with
    ``instr`` and ``instr_state`` compared too and crafted states whose first
    action completes each composition (single, and, before, after: the
    reset's slot-0 instruction in the slot the composition verifies next,
    every other slot already done) and, on the strict levels, toggles of a
    door the strict slot does not name; each composition must succeed on
    the card, and each strict level fail without reward; (b) as 13b on
    BossLevel, MoveTwoAcrossS8N9 and OpenDoorsOrderN4, and on BossLevel with
    ``--mission-conditioning`` (``SEQ_VANILLA``); (c) as 14c with
    ``--recurrent --mission-conditioning`` on OpenTwoDoors; (d)
    ``clip_ppo_minigrid`` in the text modality under HARD on BossLevel with
    ``--mission-conditioning`` (the 1,936-row table: K2 and K3 12 times each
    at [1024,77,512] and [912,77,512] at startup, path ``boss_mission``) and
    on MiniBossLevel (the 324-row table: K2 and K3 12 times each at
    [324,77,512], path ``miniboss_text``), K1 128 times an iteration in each.

Besides, phase 2 holds K4–K8 in bf16 (their bf16 entry points) against
their plain bf16 versions (``BF16_CASES``), K4 and K8 timed beside
``scaled_dot_product_attention`` in bf16 and K7 beside K5; phase 5 also runs
the image modality at ViT-B/16 (T = 197) with its launch counts and checks
that tower's embeddings against the CPU; phase 8 also runs
``benchmark_clip`` at ViT-L/14 at its default bf16 (K4 + K5 in bf16 in the
vision tower, K2 + K3 in bf16 in the text tower), under each switch in bf16
(K6, K7), at ViT-B/32 in bf16 under ``fused`` (K4) and ``pallas`` (K8), and
at ViT-B/16 in bf16 and float32, launches of every call checked; phase 9
also checks ViT-L/14's bf16 features against the plain bf16 route on the
CPU on the default route and under both switches, and profiles one
batch-256 bf16 image call of each. Every kernel of the ``kernels`` line
must have been launched on each of its paths (``launches_by_path``;
``launches`` is their sum); on the ``clip_ppo_minigrid`` runs of phases
13-15 a row counts its kernel's launches at its own shape
(``cuda_build.LAUNCH_SHAPES``), elsewhere all of its kernel's launches.

The paths of phases 3 to 8 before the switch runs, and of phases 10 and
11, run with every switch unset, and their launch checks hold K6 and K7
at 0.

The last lines are the kernels' JSON summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result. Comparisons run with TF32 off
for both matmuls and cuDNN, so every plain version computes in full fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

# Published dense peaks of the H100 SXM at its full 700 W (NVIDIA data
# sheet): fp32 outside the tensor cores, TF32 on the tensor cores, and
# device-memory bandwidth.
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int, warmup: int = 2, calls: int = 1) -> float:
    """Median milliseconds per call of ``fn`` over ``reps`` runs, CUDA events.
    Each run times ``calls`` back-to-back calls between one pair of events,
    so a short kernel's time is its device time and not its host overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


# Each ported kernel's C entry point. cuda_build.launch opens a profiler
# range of that name around the call, which splits a trace's device time by
# ported kernel where kernels share one template (K2's and K5's GEMM, the
# LayerNorm statistics, the attention tile).
ENTRY_POINTS = {
    "disturb_launch": "K1 disturb", "attn_block_launch": "K2 attn_block",
    "mlp_block_launch": "K3 mlp_block", "fused_qkv_launch": "K4 fused_qkv",
    "mlp_stream_launch": "K5 mlp_stream", "attn_stream_launch": "K6 attn_stream",
    "mlp_chunked_launch": "K7 mlp_chunked", "packed_attention_launch": "K8 packed_attention",
    "attn_block_bf16_launch": "K2 attn_block bf16", "mlp_block_bf16_launch": "K3 mlp_block bf16",
    "fused_qkv_bf16_launch": "K4 fused_qkv bf16", "mlp_stream_bf16_launch": "K5 mlp_stream bf16",
    "attn_stream_bf16_launch": "K6 attn_stream bf16",
    "mlp_chunked_bf16_launch": "K7 mlp_chunked bf16",
    "packed_attention_bf16_launch": "K8 packed_attention bf16",
}


def _kernel_events(prof) -> list:
    """The device kernels of a trace, averaged by name, without the device
    side of the entry points' ranges."""
    import torch

    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.endswith("_launch")]


def by_ported_kernel(prof) -> dict:
    """Device ms and calls of each ported kernel in a trace that records
    both the CPU and the device: the device side of its entry point's
    ranges, each from the start of the call's first kernel to the end of
    its last."""
    import torch

    return {ENTRY_POINTS[e.key]: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.key in ENTRY_POINTS and e.device_type == torch.autograd.DeviceType.CUDA}


def _fmt_ported(rows: dict) -> str:
    return "; ".join(f"{k} {ms:.1f} ms x{n}" for k, (ms, n) in sorted(rows.items())) or "none"


@contextlib.contextmanager
def card_clocks(out: dict):
    """The card's SM clock (MHz) and power draw (W), sampled every 20 ms by
    nvidia-smi while the block runs: their median, least and largest go
    into ``out`` (nothing when nvidia-smi gives no sample)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "20"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    first = proc.stdout.readline()  # sampling has started
    try:
        yield
    finally:
        proc.terminate()
        text = first + proc.communicate(timeout=10)[0]
    samples = []
    for line in text.splitlines():
        with contextlib.suppress(ValueError):
            samples.append(tuple(float(v) for v in line.split(",")))
    if samples:
        mhz = sorted(c for c, _ in samples)
        out.update(sm_mhz=mhz[len(mhz) // 2], sm_mhz_min=mhz[0],
                   power_w=max(w for _, w in samples), samples=len(samples))


def device_split(fn, calls: int = 20, kernel: str = "") -> dict:
    """Device milliseconds per call of ``fn`` by kernel name, for the
    kernels whose names hold ``kernel`` (every kernel by default), from a
    torch.profiler trace of ``calls`` back-to-back calls. Unlike CUDA events
    around host calls, it leaves out the host's launch overhead."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.removeprefix("void ").split("(")[0]: e.self_device_time_total / 1e3 / calls
            for e in _kernel_events(prof) if kernel in e.key}


def device_ms(fn, calls: int = 20, kernel: str = "") -> float | None:
    """The sum of :func:`device_split` (None when the trace holds none)."""
    total = sum(device_split(fn, calls, kernel).values())
    return total if total else None


def _fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase_card() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    flops, bw = FP32_FLOPS, HBM_BYTES_PER_S
    print(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"bounds against the H100 SXM data sheet: fp32 {flops / 1e12:.0f} TFLOP/s, "
          f"TF32 {TF32_FLOPS / 1e12:.0f} TFLOP/s, {bw / 1e12:.2f} TB/s")
    from clip_ppo_tpu_torch import cuda_build

    t0 = time.time()
    cuda_build.build_all()
    print(f"[card] built {len(cuda_build.SOURCES)} kernel libraries in {time.time() - t0:.1f} s")
    spills = []
    for lib in cuda_build.SOURCES:
        kernel = ""
        for line in cuda_build.build_log(lib).splitlines():
            if "Function properties for" in line:
                kernel = _kernel_name(line)
            elif "registers" in line or "spill" in line:
                print(f"[card] ptxas {lib} {kernel}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores", line)
                if lib in TENSOR_CORE_LIBS and m and int(m[1]):
                    spills.append(f"{lib} {kernel}")
    # The tensor-core kernels' SASS, kept beside their nvcc logs in the build
    # directory: each library must hold tensor-core instructions.
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for lib in TENSOR_CORE_LIBS:
        sass = subprocess.run([cuobjdump, "-sass", str(cuda_build._lib_path(lib))],
                              capture_output=True, text=True, check=True).stdout
        (cuda_build.BUILD_DIR / f"{lib}.sass").write_text(sass)
        per_kernel = {}
        kernel = ""
        for line in sass.splitlines():
            if "Function :" in line:
                kernel = _kernel_name(line)
            elif re.search(r"\bH(?:G)?MMA[.\s]", line):
                per_kernel[kernel] = per_kernel.get(kernel, 0) + 1
        print(f"[card] tensor-core (HMMA/HGMMA) instructions in {lib}'s SASS (cuobjdump -sass, "
              f"in {cuda_build.BUILD_DIR.name}/{lib}.sass): {per_kernel}")
        if not per_kernel:
            fail(f"{lib} has no tensor-core instruction in its SASS")
        for kernel, op in BF16_TENSOR_CORE.get(lib, ()):
            n = sum(count for k, count in per_kernel.items() if k.startswith(kernel))
            print(f"[card] bf16 {lib} {kernel}: {n} {op} instructions")
            if not n:
                fail(f"{lib}'s bf16 {kernel} holds no {op} instruction")
    if spills:
        fail(f"ptxas spills registers in the tensor-core kernels: {spills}")
    return {"smi": smi, "name": name, "flops": flops, "tf32_flops": TF32_FLOPS,
            "bf16_flops": BF16_FLOPS, "bw": bw}


# The libraries whose kernels run their products on the tensor cores in
# 3xTF32: their SASS must hold tensor-core instructions, ptxas must spill
# nothing in them, and their bounds count three TF32 passes a product.
TENSOR_CORE_LIBS = ("fused_qkv", "attn_block", "mlp_block", "mlp_stream", "attn_stream",
                    "mlp_chunked")


# The bf16 instantiations of every kernel's bf16 entry point: each must hold
# tensor-core instructions of its kind, wgmma (HGMMA) in the GEMM and
# mma.sync (HMMA) in the attention tile; K7's fp32-sum epilogue
# (gemm_bf16_kernel<false,3>, kAccumulate) among them.
BF16_TENSOR_CORE = {
    "attn_block": (("gemm_bf16_kernel", "HGMMA"), ("attention_bf16_kernel", "HMMA")),
    "mlp_block": (("gemm_bf16_kernel", "HGMMA"),),
    "fused_qkv": (("attention_bf16_kernel", "HMMA"),),
    "mlp_stream": (("gemm_bf16_kernel", "HGMMA"),),
    "attn_stream": (("gemm_bf16_kernel", "HGMMA"), ("attention_bf16_kernel", "HMMA")),
    "mlp_chunked": (("gemm_bf16_kernel", "HGMMA"), ("gemm_bf16_kernel<false,3>", "HGMMA")),
}


def _kernel_name(line: str) -> str:
    """A readable kernel name from a mangled one in ptxas's or cuobjdump's
    output: ..._17mlp_stream_kernelILi768EEvPKf... -> mlp_stream_kernel<768>,
    ...11gemm_kernelILb1ELi1EEEvNS_6ParamsE -> gemm_kernel<true,1>,
    ...16gemm_bf16_kernelILb1ELi0EE... -> gemm_bf16_kernel<true,0>: the first
    length-prefixed name that ends in _kernel."""
    for m in re.finditer(r"(?=(\d+))", line):
        start = m.start() + len(m[1])
        name = line[start:start + int(m[1])]
        if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
            break
    else:  # an extern "C" kernel's name is not mangled
        m = re.search(r"\b([A-Za-z_]\w*_kernel)\b", line)
        return m[1] if m else ""
    t_args = re.match(r"I((?:L[a-z]+\d+E)+)E", line[start + len(name):])
    args = [("true" if v == "1" else "false") if t == "b" else v
            for t, v in re.findall(r"L([a-z]+)(\d+)E", t_args[1] if t_args else "")]
    return name + (f"<{','.join(args)}>" if args else "")


def _bound(nbytes: float, nflops: float, card: dict) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / card["bw"] * 1e3, nflops / card["flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bound_tf32x3(nbytes: float, nflops: float, card: dict) -> tuple[float, str]:
    """The bound of a kernel that runs every product as three TF32 passes:
    the bytes, or 3 x the flops at the TF32 tensor-core peak."""
    t_bytes, t_ops = nbytes / card["bw"] * 1e3, 3 * nflops / card["tf32_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "3xTF32 operations")


def _errors(got, ref) -> tuple[float, float]:
    """Max absolute error, and the same relative to max |ref|."""
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


# K1 at shapes its bands must get right: (shape, severity, CTAs an image,
# noise drawn in the kernel); with the noise drawn in the kernel (the main
# paths' mode) the plain version is fed the kernel's own normals, else both
# take the same noise as input.
K1_CASES = [
    ((3, 85, 83, 3), "HARD", 16, False),  # ragged: bands of 6, the 15th of 1, the 16th empty
    ((4, 84, 84, 1), "HARD", 16, False),  # one channel: the channel mean
    ((2, 9, 13, 3), "SEVERE", 16, False),  # bands of 1 row, thinner than the 3-row halo
    ((8, 84, 84, 3), "SEVERE", 8, False),  # the portable cluster size: bands of 11
    ((8, 84, 84, 1), "HARD", 16, True),  # one frame of the Atari rollout's stacks
]


def phase_kernels(card: dict) -> list[dict]:
    import torch

    from clip_ppo_tpu_torch.ops import disturb_kernel as dk
    from clip_ppo_tpu_torch.ops.disturbances import DisturbanceDraws, draw
    from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity, SEVERITY_CONFIGS

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = []

    # -- K1 at the rollout's [8, 84, 84, 3], every severity, and at the shapes
    # of K1_CASES, noise as input --
    x = torch.rand((8, 84, 84, 3), generator=gen, device=dev)
    worst, worst_rel = 0.0, 0.0

    def k1_check(label, xc, params, d, ctas=dk.CLUSTER_CTAS):
        nonlocal worst, worst_rel
        err, rel = _errors(dk.disturb_batched(xc, params, d, ctas=ctas),
                           dk.disturb_batched_plain(xc, params, d))
        print(f"[kernels] K1 {label}: ksize {params.blur_kernel_size}, {ctas} CTAs an image, "
              f"max_abs_err {err:.3e} max_rel_err {rel:.3e} (tolerance 1e-5 absolute on [0, 1] "
              f"values)")
        if not err <= 1e-5:
            fail(f"K1 {label} disagrees with its plain version: {err} > 1e-5")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)

    def noise_in(xc, params):
        d = draw(xc, params, gen)
        return DisturbanceDraws(torch.randn(xc.shape, generator=gen, device=dev), d.factor, d.origin)

    for sev in ("MILD", "MODERATE", "HARD", "SEVERE"):
        params = SEVERITY_CONFIGS[DisturbanceSeverity[sev]]
        k1_check(f"{sev} [8,84,84,3]", x, params, noise_in(x, params))
    for shape, sev, ctas, in_kernel in K1_CASES:
        params = SEVERITY_CONFIGS[DisturbanceSeverity[sev]]
        xc = torch.rand(shape, generator=gen, device=dev)
        label = f"{sev} [{','.join(map(str, shape))}]"
        if not in_kernel:
            k1_check(label, xc, params, noise_in(xc, params), ctas)
            continue
        d_seed = draw(xc, params, gen)
        err, rel = _errors(dk.disturb_batched(xc, params, d_seed, ctas=ctas),
                           dk.disturb_batched_plain(xc, params, _own_normals(xc, d_seed)))
        print(f"[kernels] K1 {label}, noise drawn in the kernel, {ctas} CTAs an image, against "
              f"the plain version fed the kernel's own normals: max_abs_err {err:.3e} "
              f"max_rel_err {rel:.3e} (tolerance 1e-5)")
        if not err <= 1e-5:
            fail(f"K1 {label} with in-kernel noise disagrees with its plain version: {err}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    z = dk.kernel_normals(1 << 22, 12345, 0, dev)
    z1 = dk.kernel_normals(1 << 16, 12345, 1, dev)
    mean, std = z.mean().item(), z.std().item()
    print(f"[kernels] K1 in-kernel Philox normals over {z.numel()} draws: mean {mean:.5f} std {std:.5f}")
    if abs(mean) > 0.003 or abs(std - 1.0) > 0.003 or torch.equal(z[: z1.numel()], z1):
        fail("K1's in-kernel noise is not standard normal (|mean|, |std-1| <= 0.003) or "
             "its streams do not differ per image")
    params = SEVERITY_CONFIGS[DisturbanceSeverity.HARD]
    d_seed = draw(x, params, gen)  # the main path's mode: noise drawn in the kernel
    seed = int(d_seed.seed.item())
    d_own = _own_normals(x, d_seed)
    for ctas in (dk.CLUSTER_CTAS, 8):
        err, rel = _errors(dk.disturb_batched(x, params, d_seed, ctas=ctas),
                           dk.disturb_batched_plain(x, params, d_own))
        print(f"[kernels] K1 HARD [8,84,84,3], noise drawn in the kernel (seed {seed}), {ctas} "
              f"CTAs an image, against the plain version fed the kernel's own normals: "
              f"max_abs_err {err:.3e} max_rel_err {rel:.3e} (tolerance 1e-5)")
        if not err <= 1e-5:
            fail(f"K1 with in-kernel noise disagrees with its plain version: {err} > 1e-5")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    timed = {}
    for ctas in (dk.CLUSTER_CTAS, 8):  # the main path's mode, and the portable cluster
        k1 = lambda: dk.disturb_batched(x, params, d_seed, ctas=ctas)  # noqa: E731
        empty = lambda: dk.empty_launch(x.shape[0], dev, ctas=ctas)  # noqa: E731
        timed[ctas] = (time_ms(k1, reps=20, calls=50),
                       device_ms(k1, calls=50, kernel="disturb_kernel"),  # one launch a call
                       time_ms(empty, reps=20, calls=50),
                       device_ms(empty, calls=50, kernel="empty_kernel"))
    ms, k1_device_ms, empty_ms, empty_device_ms = timed[dk.CLUSTER_CTAS]
    # Where K1's device time goes: fewer CTAs an image, the noise read from
    # memory instead of drawn, no noise at all, and the blur's taps
    # (SEVERE's 7 against MILD's 3).
    no_noise = dataclasses.replace(params, gaussian_noise_sigma=0.0)
    parts = [(f"{c} CTAs an image", lambda c=c: dk.disturb_batched(x, params, d_seed, ctas=c))
             for c in (1, 2, 4)]
    parts += [
        ("noise read from memory", lambda: dk.disturb_batched(x, params, d_own)),
        ("no noise (sigma 0)", lambda: dk.disturb_batched(x, no_noise, d_seed)),
        ("MILD, 3 taps", lambda: dk.disturb_batched(
            x, SEVERITY_CONFIGS[DisturbanceSeverity.MILD], d_seed)),
        ("SEVERE, 7 taps", lambda: dk.disturb_batched(
            x, SEVERITY_CONFIGS[DisturbanceSeverity.SEVERE], d_seed)),
    ]
    print("[kernels] K1 [8,84,84,3] torch.profiler device time per launch, HARD with the noise "
          f"drawn in the kernel and 16 CTAs an image unless said: {_fmt_ms(k1_device_ms)}; "
          + "; ".join(f"{label} {_fmt_ms(device_ms(call, calls=50, kernel='disturb_kernel'))}"
                      for label, call in parts))
    plain_ms = time_ms(lambda: dk.disturb_batched_plain(x, params, d_own), reps=20, calls=50)
    elems = x.numel()
    bound_ms, bound_by = _bound(2 * elems * 4, elems * (4 * params.blur_kernel_size + 7), card)
    for ctas, (t, t_dev, t_empty, t_empty_dev) in timed.items():
        print(f"[kernels] K1 HARD [8,84,84,3], {x.shape[0]} clusters x {ctas} CTAs = "
              f"{x.shape[0] * ctas} CTAs on {n_sm} SMs (bands of "
              f"{-(-x.shape[1] // ctas)} rows): {t:.4f} ms per call over 50 back-to-back calls "
              f"(torch.profiler device time {_fmt_ms(t_dev)} per launch); an empty kernel on the "
              f"same grid and clusters {t_empty:.4f} ms (device {_fmt_ms(t_empty_dev)}); plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    results.append({
        "name": "disturb", "route": "cuda", "source": "clip_ppo_tpu_torch/csrc/disturb.cu",
        "replaces": "clip_ppo_tpu/ops/pallas_disturb.py:76", "shape": "[8,84,84,3]",
        "path": ("text", *FAMILY_CLIP_PATHS), "max_abs_err": worst,
        "max_rel_err": worst_rel, "tolerance": 1e-5, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "device_ms": k1_device_ms, "ctas": dk.CLUSTER_CTAS,
        "empty_ms": empty_ms, "empty_device_ms": empty_device_ms,
        "ms_8_ctas": timed[8][0], "device_ms_8_ctas": timed[8][1],
    })
    # One frame of the Atari rollout's [8, 84, 84, 4] stacks under
    # stack_frames (4 launches a step), HARD, noise drawn in the kernel.
    x1 = torch.rand((8, 84, 84, 1), generator=gen, device=dev)
    d1 = draw(x1, params, gen)
    d1_own = _own_normals(x1, d1)
    err1, rel1 = _errors(dk.disturb_batched(x1, params, d1),
                         dk.disturb_batched_plain(x1, params, d1_own))
    k1 = lambda: dk.disturb_batched(x1, params, d1)  # noqa: E731
    ms1 = time_ms(k1, reps=20, calls=50)
    dev1 = device_ms(k1, calls=50, kernel="disturb_kernel")
    plain1 = time_ms(lambda: dk.disturb_batched_plain(x1, params, d1_own), reps=20, calls=50)
    bound1, by1 = _bound(2 * x1.numel() * 4, x1.numel() * (4 * params.blur_kernel_size + 7), card)
    print(f"[kernels] K1 HARD [8,84,84,1] (an Atari frame), noise drawn in the kernel: "
          f"{ms1:.4f} ms per call over 50 back-to-back calls (device {_fmt_ms(dev1)}), plain "
          f"{plain1:.4f} ms, bound {bound1:.5f} ms ({by1})")
    results.append({
        "name": "disturb", "route": "cuda", "source": "clip_ppo_tpu_torch/csrc/disturb.cu",
        "replaces": "clip_ppo_tpu/ops/pallas_disturb.py:76", "shape": "[8,84,84,1]",
        "path": "atari_hard", "max_abs_err": err1, "max_rel_err": rel1, "tolerance": 1e-5,
        "ms": ms1, "plain_ms": plain1, "bound_ms": bound1, "bound_by": by1, "library_ms": None,
        "device_ms": dev1, "ctas": dk.CLUSTER_CTAS,
    })

    # -- K2, K3 and K5 at the shapes of BLOCK_CASES ---------------------
    results += run_block_cases([(block_case(spec), spec[6]) for spec in BLOCK_CASES],
                               card, gen, dev)
    print("[kernels] " + json.dumps({"checked": [
        {k: r.get(k) for k in ("name", "shape", "max_abs_err", "max_rel_err", "tolerance")}
        | {"ok": True} for r in results]}))
    return results


def random_block(gen, dm: int, dev) -> dict:
    """A resblock of width ``dm`` whose LayerNorm affines and biases are
    drawn at random: init_block leaves every LayerNorm at scale 1 and bias 0
    and every bias at 0, so a kernel that dropped or misread one would pass."""
    import torch

    from clip_ppo_tpu_torch.models.clip.model import init_block

    p = init_block(gen, dm, dev)
    for ln in (p["ln_1"], p["ln_2"]):
        ln["scale"] = 1.0 + 0.1 * torch.randn(dm, generator=gen, device=dev)
        ln["bias"] = 0.1 * torch.randn(dm, generator=gen, device=dev)
    for part, key in (("attn", "in_proj_b"), ("attn", "out_proj_b"), ("mlp", "fc_b"),
                      ("mlp", "proj_b")):
        p[part][key] = 0.1 * torch.randn(p[part][key].shape, generator=gen, device=dev)
    return p


# kernel -> (source under clip_ppo_tpu_torch/csrc/, line of the TPU kernel in
# clip_ppo_tpu/models/clip/pallas_block.py)
BLOCK_KERNELS = {
    "attn_block": ("attn_block.cu", 110),
    "attn_stream": ("attn_stream.cu", 453),
    "mlp_block": ("mlp_block.cu", 170),
    "mlp_stream": ("mlp_stream.cu", 393),
    "mlp_chunked": ("mlp_chunked.cu", 134),
}


def _source(name: str) -> tuple[str, str]:
    src, line = BLOCK_KERNELS[name]
    return f"clip_ppo_tpu_torch/csrc/{src}", f"clip_ppo_tpu/models/clip/pallas_block.py:{line}"


# The family runs of phases 13-15 (FAMILY_CLIP_RUNS and after): each path's
# text or image shapes. A text table of R rows encodes in batches of 1,024, so
# its last batch has R mod 1,024 rows; a split path encodes 1,024 a step.
TEXT_1024 = ("text", "fourrooms", "split", "gotodoor", "babyai_text", "boss_mission")
IMAGE_1024 = ("image", "lavacrossing", "obstructedmaze", "babyai_image")
FAMILY_CLIP_PATHS = ("fourrooms", "split", "lavacrossing", "gotodoor", "obstructedmaze",
                     "babyai_text", "babyai_image", "boss_mission", "miniboss_text")

BLOCK_CASES = [  # (kernel, B, T, D, causal, path or paths, timed); rows of no path stay out of the kernels line
    ("attn_block", 1024, 77, 512, True, TEXT_1024, True),  # text tables, split paths
    ("mlp_block", 1024, 77, 512, False, TEXT_1024, True),
    ("attn_block", 420, 77, 512, True, "fourrooms", True),  # FourRooms' 1,444 rows: the last batch
    ("mlp_block", 420, 77, 512, False, "fourrooms", True),
    ("attn_block", 912, 77, 512, True, ("babyai_text", "boss_mission"), True),  # 22x22 tables:
    ("mlp_block", 912, 77, 512, False, ("babyai_text", "boss_mission"), True),  # last batch
    ("attn_block", 324, 77, 512, True, "miniboss_text", True),  # MiniBossLevel's 9x9 table
    ("mlp_block", 324, 77, 512, False, "miniboss_text", True),
    ("attn_block", 1024, 50, 768, False, IMAGE_1024, True),  # ViT-B/32 vision
    ("mlp_stream", 1024, 50, 768, False, IMAGE_1024, True),
    ("attn_block", 1024, 77, 768, True, "benchmark", True),  # ViT-L/14 text
    ("mlp_stream", 256, 257, 1024, False, "benchmark", True),  # ViT-L/14 vision
    ("mlp_stream", 1024, 77, 768, False, "benchmark", True),  # ViT-L/14 text
    ("mlp_block", 7, 77, 512, False, None, False),  # ragged row count
    ("mlp_block", 5, 77, 544, False, None, False),  # proj N = 544: a partial column tile
    ("mlp_stream", 7, 50, 768, False, None, False),  # ragged row count
    ("mlp_stream", 7, 50, 672, False, None, False),  # proj N = 672: a partial column tile
    ("attn_block", 64, 197, 768, False, None, False),  # ViT-B/16's length
    ("attn_block", 4, 77, 832, True, None, False),  # 13 heads: N = 2496 and 832, partial tiles
    ("attn_block", 256, 257, 1024, False, None, True),  # K6's shape
]


# K6 and K7, checked and timed in phase_stream_kernels (rows as BLOCK_CASES)
STREAM_CASES = [
    ("attn_stream", 256, 257, 1024, False, "both", True),  # ViT-L/14 vision, switch on
    ("attn_stream", 3, 257, 1024, False, None, False),  # ragged row count
    ("attn_stream", 4, 77, 1024, True, None, False),
    ("attn_stream", 4, 77, 832, True, None, False),  # 13 heads: N = 2496 and 832, partial tiles
    ("mlp_chunked", 256, 257, 1024, False, "both", True),  # ViT-L/14 vision, switch on
    ("mlp_chunked", 1024, 77, 768, False, "both", True),  # ViT-L/14 text, switch on
    ("mlp_chunked", 3, 257, 1024, False, None, False),  # ragged row count
    ("mlp_chunked", 7, 50, 672, False, None, False),  # fc N = ck = 672, proj N = 672: partial tiles
]


def block_case(spec: tuple, beside=None):
    """One ``BLOCK_CASES`` or ``STREAM_CASES`` row as :func:`attn_case` or
    :func:`mlp_case`; ``beside``, a list of (label, fn), other routes timed
    on the same inputs."""
    name, b, t, dm, causal, path, _ = spec
    if name.startswith("attn"):
        return attn_case(name, b, t, dm, causal, path, beside)
    return mlp_case(name, b, t, dm, path, beside)


def attn_case(name, b, t, dm, causal, path, beside=None):
    """K2 or K6 at [b, t, dm]: the kernel, its plain version, the work of
    the function (qkv and out-projections, then scores and weighted values
    over the causal triangle or the full T x T) and its weight bytes."""
    from clip_ppo_tpu_torch.models.clip import block_kernels as bk

    heads = dm // 64
    fn = getattr(bk, name)
    pairs = t * (t + 1) // 2 if causal else t * t
    return (name, path, (b, t, dm, causal),
            lambda x, p: fn(x, p["ln_1"], p["attn"], heads, causal=causal),
            lambda x, p: bk.attn_block_plain(x, p["ln_1"], p["attn"], heads, causal=causal),
            2 * b * t * dm * 4 * dm + 2 * 2 * b * pairs * dm, (4 * dm * dm + 6 * dm) * 4,
            *_source(name), beside)


def mlp_case(name, b, t, dm, path, beside=None):
    """K3, K5 or K7 at [b, t, dm]: two products of 2 * B*T * D * 4D flops."""
    from clip_ppo_tpu_torch.models.clip import block_kernels as bk

    fn = bk.mlp_block_resident if name == "mlp_block" else getattr(bk, name)
    return (name, path, (b, t, dm, False), lambda x, p: fn(x, p["ln_2"], p["mlp"]),
            lambda x, p: bk.mlp_block_plain(x, p["ln_2"], p["mlp"]),
            2 * 2 * b * t * dm * 4 * dm, (8 * dm * dm + 7 * dm) * 4, *_source(name), beside)


def run_block_cases(cases, card: dict, gen, dev) -> list[dict]:
    """Each resblock-half kernel against its plain version on random inputs
    (tolerance 1e-4 x max(1, max |ref|)), with the device memory its wrapper
    asks for besides the output (the allocator's peak of requested bytes
    during the call, less what was requested before and the output); the
    timed ones also get their median ms, the plain version's, the bound and,
    where a case names them, the times of other routes to the same function
    on the same inputs."""
    import torch

    from clip_ppo_tpu_torch.models.clip import block_kernels as bk

    results = []
    params = {}
    with torch.no_grad():
        for (name, path, (b, t, dm, causal), fn, plain, nflops, wbytes, src, line,
             beside), timed in cases:
            if dm not in params:
                params[dm] = random_block(gen, dm, dev)
            p = params[dm]
            xb = torch.randn((b, t, dm), generator=gen, device=dev)
            torch.cuda.synchronize()
            base = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
            torch.cuda.reset_peak_memory_stats(dev)
            got = fn(xb, p)
            peak = torch.cuda.memory_stats(dev)["requested_bytes.all.peak"]
            scratch = peak - base - xb.numel() * 4
            ref = plain(xb, p)
            torch.cuda.synchronize()
            err, rel = _errors(got, ref)
            scale = ref.abs().max().item()
            tol = 1e-4 * max(1.0, scale)
            del got, ref
            shape = f"[{b},{t},{dm}]" + (" causal" if causal else "")
            print(f"[kernels] {name} {shape}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                  f"(max |ref| {scale:.3f}; tolerance 1e-4 x max(1, max |ref|) = {tol:.1e}); "
                  f"scratch {scratch} bytes = {scratch / (xb.numel() * 4):.3f}x the activations")
            if not err <= tol:
                fail(f"{name} {shape} disagrees with its plain version: {err} > {tol}")
            # K7's hidden scratch is one chunk, [B*T, D] at 4D / MLP_CHUNKS = D
            if name == "mlp_chunked":
                m = b * t
                limit = m * (4 * dm // bk.MLP_CHUNKS) * 4 + m * 2 * 4
                if not scratch <= limit:
                    fail(f"mlp_chunked {shape} allocated {scratch} bytes of scratch, more than "
                         f"one chunk of the hidden and the row statistics ({limit})")
            if not timed:
                continue
            clocks = {}
            with card_clocks(clocks):
                ms = time_ms(lambda: fn(xb, p), reps=10)
            plain_ms = time_ms(lambda: plain(xb, p), reps=10)
            nbytes = 2 * xb.numel() * 4 + wbytes
            bound_ms, bound_by = _bound(nbytes, nflops, card)
            row = {
                "name": name, "route": "cuda", "source": src, "replaces": line, "shape": shape,
                "path": path, "max_abs_err": err, "max_rel_err": rel, "tolerance": tol, "ms": ms,
                "plain_ms": plain_ms, "library_ms": None, "scratch_bytes": scratch,
            }
            fp32 = dev_note = ""
            if name in TENSOR_CORE_LIBS:  # three TF32 passes a product
                row["bound_fp32_ms"] = bound_ms
                fp32 = f"; fp32 CUDA-core bound {bound_ms:.3f} ms"
                bound_ms, bound_by = _bound_tf32x3(nbytes, nflops, card)
                split = device_split(lambda: fn(xb, p), calls=10)
                row["device_ms"] = sum(split.values()) or None
                dev_note = (f" (torch.profiler device time {_fmt_ms(row['device_ms'])} per call: "
                            + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + ")")
            row["bound_ms"], row["bound_by"] = bound_ms, bound_by
            row["beside_ms"] = {label: time_ms(lambda: other_fn(xb, p), reps=10)
                                for label, other_fn in beside or []}
            other = "".join(f", {k} {v:.3f} ms" for k, v in row["beside_ms"].items())
            card_note = (f"; while timed: SM clock median {clocks['sm_mhz']:.0f} MHz, least "
                         f"{clocks['sm_mhz_min']:.0f}, power up to {clocks['power_w']:.0f} W over "
                         f"{clocks['samples']} samples" if clocks else "")
            print(f"[kernels] {name} {shape}: {ms:.3f} ms{dev_note}, plain {plain_ms:.3f} ms{other}, bound "
                  f"{bound_ms:.3f} ms ({bound_by}, {nflops / 1e9:.1f} GFLOP{fp32}; "
                  f"{ms / bound_ms:.2f}x it), {nflops / ms / 1e9:.2f} TFLOP/s{card_note}")
            results.append(row)
            del xb
    del params
    torch.cuda.empty_cache()
    return results


def phase_stream_kernels(card: dict) -> list[dict]:
    """K6 and K7 against their plain versions on the card at the shapes of
    ``STREAM_CASES``; at ViT-L/14's, K6 timed beside K2 and beside the route
    it replaces (LN1, the cuBLAS qkv projection, K4, the cuBLAS
    out-projection and the residual), K7 beside K5, on the same inputs."""
    import torch

    from clip_ppo_tpu_torch.models.clip import block_kernels as bk
    from clip_ppo_tpu_torch.models.clip import model as cm

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def fused_route(x, p):
        return x + cm.attention(p["attn"], bk.layer_norm(p["ln_1"], x), 16, False, "auto")

    beside = {
        "attn_stream": [
            ("K2 (attn_block)", lambda x, p: bk.attn_block(x, p["ln_1"], p["attn"], 16)),
            ("LN1 + cuBLAS qkv + K4 + cuBLAS out-proj + residual", fused_route)],
        "mlp_chunked": [("K5 (mlp_stream)", lambda x, p: bk.mlp_stream(x, p["ln_2"], p["mlp"]))],
    }
    cases = [(block_case(spec, beside[spec[0]] if spec[6] else None), spec[6])
             for spec in STREAM_CASES]
    results = run_block_cases(cases, card, gen, dev)
    # A width the kernels do not take (not a multiple of 32, nor of 64 for
    # the heads) is refused by name, not run.
    x, blk = torch.zeros((2, 3, 200), device=dev), random_block(gen, 200, dev)
    for name, call in (("attn_stream", lambda: bk.attn_stream(x, blk["ln_1"], blk["attn"], 3)),
                       ("mlp_chunked", lambda: bk.mlp_chunked(x, blk["ln_2"], blk["mlp"])),
                       ("mlp_block", lambda: bk.mlp_block_resident(x, blk["ln_2"], blk["mlp"]))):
        try:
            call()
        except ValueError as e:
            print(f"[kernels] {name} refuses D = 200: {e}")
        else:
            fail(f"{name} ran at D = 200, a width its kernel does not take")
    print("[kernels] " + json.dumps({"checked": [
        {k: r.get(k) for k in ("name", "shape", "max_abs_err", "max_rel_err", "tolerance")}
        | {"ok": True} for r in results]}))
    return results


# Every kernel in bf16 (its bf16 entry point), checked and timed in
# phase_bf16_kernels: (kernel, B, T, D, causal, path, timed); the attention
# kernels take [B, T, 3D] qkv (K8 its q, k, v as strided [B, T, D / 64, 64]
# views of it). The FROZEN_CLIP trunk runs K2 and K3 at [8, 50, 768] in the
# rollout and the bootstrap value, [256, 50, 768] in the update;
# benchmark_clip's bf16 runs ViT-B/32 at [1024, 50, 768] and its text tower
# at [1024, 77, 512] causal, ViT-L/14's vision tower (K4 and K5; K6 and K7
# under the switches) at [256, 257, 1024] and its text tower (K2 and K3) at
# [1024, 77, 768] causal, and ViT-B/32's vision tower under --attention-impl
# fused (K4) at [1024, 50, 768] and pallas (K8) at [64, 50, 768]. The Atari
# image modality encodes 1,024 stacks of 4 frames at [4096, 50, 768]; Atari
# FROZEN_CLIP runs [32, 50, 768] in the rollout and [1024, 50, 768] in the
# update.
BF16_CASES = [
    ("attn_block", 4096, 50, 768, False, "atari", True),  # Atari: 1,024 stacks x 4 frames
    ("mlp_block", 4096, 50, 768, False, "atari", True),
    ("attn_block", 32, 50, 768, False, "atari_frozen", True),  # Atari FROZEN_CLIP: 8 x 4
    ("mlp_block", 32, 50, 768, False, "atari_frozen", True),
    ("attn_block", 8, 50, 768, False, "frozen", True),
    ("mlp_block", 8, 50, 768, False, "frozen", True),
    ("attn_block", 256, 50, 768, False, "frozen", True),
    ("mlp_block", 256, 50, 768, False, "frozen", True),
    ("attn_block", 1024, 50, 768, False, "bench_bf16", True),
    ("mlp_block", 1024, 50, 768, False, "bench_bf16", True),
    ("attn_block", 1024, 77, 512, True, "bench_bf16", True),
    ("mlp_block", 1024, 77, 512, False, "bench_bf16", True),
    ("attn_block", 3, 197, 768, False, None, False),  # an odd T: 3 query tiles, a ragged key tile
    ("mlp_block", 3, 197, 768, False, None, False),  # ragged row count
    ("attn_block", 4, 77, 832, True, None, False),  # 13 heads: N = 2496 and 832, partial tiles
    ("attn_block", 1024, 77, 768, True, "l14_bf16", True),  # ViT-L/14 text
    ("mlp_block", 1024, 77, 768, False, "l14_bf16", True),
    ("fused_qkv", 256, 257, 1024, False, "l14_bf16", True),  # ViT-L/14 vision, 16 heads
    ("fused_qkv", 1024, 50, 768, False, "fused_bf16", True),  # ViT-B/32 vision under fused
    ("fused_qkv", 1024, 77, 768, True, None, True),  # ViT-L/14's text width, causal
    ("fused_qkv", 3, 257, 1024, False, None, False),  # ragged batch: a 1-row last query tile
    ("fused_qkv", 5, 197, 768, False, None, False),  # ViT-B/16's T
    ("packed_attention", 64, 50, 768, False, "pallas_bf16", True),  # ViT-B/32 under pallas
    ("packed_attention", 256, 257, 1024, False, None, True),  # ViT-L/14 under pallas
    ("mlp_stream", 256, 257, 1024, False, "l14_bf16", True),  # ViT-L/14 vision
    ("mlp_stream", 3, 257, 1024, False, None, False),  # ragged row count
    ("attn_stream", 256, 257, 1024, False, "attn_stream_bf16", True),  # ViT-L/14, switch on
    ("attn_stream", 3, 77, 832, True, None, False),  # 13 heads causal: partial tiles
    ("mlp_chunked", 256, 257, 1024, False, "mlp_chunked_bf16", True),  # ViT-L/14, switch on
    ("mlp_chunked", 3, 257, 1024, False, None, False),  # ragged row count
]
BF16_CALLS = 20  # back-to-back calls between one pair of CUDA events


def _bound_bf16(nbytes: float, nflops: float, card: dict) -> tuple[float, str]:
    """The bound of a bf16 tensor-core kernel: the bytes, or the flops at the
    dense bf16 peak."""
    t_bytes, t_ops = nbytes / card["bw"] * 1e3, nflops / card["bf16_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _attention_source(name: str) -> tuple[str, str]:
    return ("clip_ppo_tpu_torch/csrc/fused_qkv.cu", "clip_ppo_tpu/models/clip/pallas_attention.py:"
            + ("91" if name == "fused_qkv" else "391"))


def bf16_case(spec: tuple, blocks: dict, gen, dev) -> dict:
    """One ``BF16_CASES`` row on the card: the bf16 kernel's call, its plain
    bf16 version's, the float32 kernel's on the same values, the library
    call computing the same function (SDPA in bf16, for K4 and K8), other
    routes timed beside, the work the bound counts and the output's bytes."""
    import torch
    import torch.nn.functional as F

    from clip_ppo_tpu_torch.models.clip import attention_kernels as ak
    from clip_ppo_tpu_torch.models.clip import block_kernels as bk
    from clip_ppo_tpu_torch.models.clip.model import cast_tower

    name, b, t, dm, causal, _, _ = spec
    heads = dm // 64
    pairs = t * (t + 1) // 2 if causal else t * t
    case = {"beside": {}, "library": None}
    if name in ("fused_qkv", "packed_attention"):
        qkv = torch.randn((b, t, 3 * dm), generator=gen, device=dev).to(torch.bfloat16)
        qkv32 = qkv.float()
        views = [tuple(z.view(b, t, heads, 64) for z in buf.split(dm, dim=-1))
                 for buf in (qkv, qkv32)]
        if name == "fused_qkv":
            case.update(fn=lambda: ak.fused_qkv_attention(qkv, heads, causal),
                        plain=lambda: ak.fused_qkv_attention_plain(qkv, heads, causal),
                        f32=lambda: ak.fused_qkv_attention(qkv32, heads, causal),
                        shape=f"[{b},{t},{3 * dm}]")
        else:
            case.update(fn=lambda: ak.packed_attention(*views[0]),
                        plain=lambda: ak.packed_attention_plain(*views[0]),
                        f32=lambda: ak.packed_attention(*views[1]),
                        shape=f"[{b},{t},{heads},64] strided")
        qh, kh, vh = (z.transpose(1, 2) for z in views[0])
        case["library"] = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
        case.update(x=qkv, out_bytes=b * t * dm * 2, nflops=2 * 2 * b * pairs * dm,
                    nbytes=4 * b * t * dm * 2, source=_attention_source(name))
        return case
    if dm not in blocks:
        p32 = random_block(gen, dm, dev)
        blocks[dm] = (p32, cast_tower(p32, torch.bfloat16))
    p32, p = blocks[dm]
    x = torch.randn((b, t, dm), generator=gen, device=dev).to(torch.bfloat16)
    x32 = x.float()
    fn = bk.mlp_block_resident if name == "mlp_block" else getattr(bk, name)
    if name.startswith("attn"):
        case.update(fn=lambda: fn(x, p["ln_1"], p["attn"], heads, causal),
                    plain=lambda: bk.attn_block_plain(x, p["ln_1"], p["attn"], heads, causal),
                    f32=lambda: (bk.attn_block if name == "attn_block" else fn)(
                        x32, p32["ln_1"], p32["attn"], heads, causal),
                    nflops=2 * b * t * dm * 4 * dm + 2 * 2 * b * pairs * dm,
                    wbytes=(4 * dm * dm + 6 * dm) * 2)
    else:
        case.update(fn=lambda: fn(x, p["ln_2"], p["mlp"]),
                    plain=lambda: bk.mlp_block_plain(x, p["ln_2"], p["mlp"]),
                    # K3's function routes to K5 at D = 768 in fp32
                    f32=lambda: (bk.mlp_block if name == "mlp_block" else fn)(
                        x32, p32["ln_2"], p32["mlp"]),
                    nflops=2 * 2 * b * t * dm * 4 * dm, wbytes=(8 * dm * dm + 7 * dm) * 2)
        if name == "mlp_chunked":
            case["beside"]["K5 bf16 (mlp_stream)"] = lambda: bk.mlp_stream(x, p["ln_2"], p["mlp"])
    case.update(x=x, out_bytes=x.numel() * 2, nbytes=2 * x.numel() * 2 + case["wbytes"],
                shape=f"[{b},{t},{dm}]", source=_source(name))
    return case


def phase_bf16_kernels(card: dict) -> list[dict]:
    """Every kernel in bf16 against its plain version in bf16 on the card
    (the same rounding steps, every product a cuBLAS bf16 matmul) at the
    shapes of ``BF16_CASES``, tolerance (1/64) x max(1, max |ref|) compared in
    float32: about three bf16 ulps of the largest value, since the two round
    in other places (the plain version rounds the scores to bf16 before the
    softmax, as ``_attn_block_ref`` does, and each product before its bias;
    the kernels keep them fp32, as the TPU kernels do). Each case prints the
    device memory its wrapper asks for besides the output (scratch); K7's
    must not exceed one bf16 chunk of the hidden, the fp32 [B*T, D] sum of
    the chunks and the row statistics. Timed by CUDA events over
    ``BF16_CALLS`` back-to-back calls beside their device time, the plain
    (cuBLAS bf16) route, the float32 kernel on the same values and, for K4
    and K8, ``scaled_dot_product_attention`` in bf16 on the same q/k/v,
    against the larger of the bytes and the flops at the dense bf16 peak."""
    import torch

    from clip_ppo_tpu_torch.models.clip import block_kernels as bk

    t0 = time.time()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    blocks, results = {}, []
    with torch.no_grad():
        for spec in BF16_CASES:
            name, b, t, dm, causal, path, timed = spec
            case = bf16_case(spec, blocks, gen, dev)
            fn, plain = case["fn"], case["plain"]
            torch.cuda.synchronize()
            base = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
            torch.cuda.reset_peak_memory_stats(dev)
            got = fn()
            scratch = torch.cuda.memory_stats(dev)["requested_bytes.all.peak"] - base \
                - case["out_bytes"]
            ref = plain()
            torch.cuda.synchronize()
            if got.dtype != torch.bfloat16 or got.shape != ref.shape:
                fail(f"{name} bf16 returned {got.dtype} {tuple(got.shape)}")
            err, rel = _errors(got.float(), ref.float())
            scale = ref.float().abs().max().item()
            tol = max(1.0, scale) / 64
            del got, ref
            shape = case["shape"] + (" causal" if causal else "") + " bf16"
            print(f"[bf16 kernels] {name} {shape}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                  f"(max |ref| {scale:.3f}; tolerance (1/64) x max(1, max |ref|) = {tol:.2e}); "
                  f"scratch {scratch} bytes")
            if not err <= tol:
                fail(f"{name} {shape} disagrees with its plain bf16 version: {err} > {tol}")
            if name == "mlp_chunked":
                m = b * t
                limit = m * (4 * dm // bk.MLP_CHUNKS) * 2 + m * dm * 4 + m * 2 * 4
                if not scratch <= limit:
                    fail(f"mlp_chunked {shape} allocated {scratch} bytes of scratch, more than "
                         f"one bf16 chunk of the hidden, the fp32 sum and the statistics ({limit})")
            if not timed:
                continue
            n = BF16_CALLS
            ms = time_ms(fn, reps=10, calls=n)
            plain_ms = time_ms(plain, reps=10, calls=n)
            f32_ms = time_ms(case["f32"], reps=10, calls=n)
            library_ms = library_dev_ms = None
            if case["library"] is not None:
                library_ms = time_ms(case["library"], reps=10, calls=n)
                library_dev_ms = device_ms(case["library"], calls=n)
            beside = {k: time_ms(f, reps=10, calls=n) for k, f in case["beside"].items()}
            split = device_split(fn, calls=n)
            dev_ms = sum(split.values()) or None
            nflops, nbytes = case["nflops"], case["nbytes"]
            bound_ms, bound_by = _bound_bf16(nbytes, nflops, card)
            lib = (f", scaled_dot_product_attention in bf16 {library_ms:.4f} ms (device "
                   f"{_fmt_ms(library_dev_ms)})" if library_ms is not None else "")
            print(f"[bf16 kernels] {name} {shape}: {ms:.4f} ms per call over {n} back-to-back "
                  f"calls (torch.profiler device time {_fmt_ms(dev_ms)} per call: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                  + f"), plain (cuBLAS bf16) {plain_ms:.4f} ms, the float32 kernel on the same "
                  f"values {f32_ms:.4f} ms{lib}"
                  + "".join(f", {k} {v:.4f} ms" for k, v in beside.items())
                  + f", bound {bound_ms:.4f} ms ({bound_by}, {nflops / 1e9:.2f} GFLOP at "
                  f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, {nbytes / 1e6:.1f} MB; "
                  f"{ms / bound_ms:.2f}x it), {nflops / ms / 1e9:.2f} TFLOP/s on {card['smi']}")
            src, line = case["source"]
            results.append({
                "name": f"{name}_bf16", "route": "cuda", "source": src, "replaces": line,
                "shape": shape, "path": path, "max_abs_err": err, "max_rel_err": rel,
                "tolerance": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms, "device_ms": dev_ms,
                "library_device_ms": library_dev_ms, "f32_kernel_ms": f32_ms,
                "scratch_bytes": scratch, "beside_ms": beside,
            })
            del case, fn, plain
    del blocks
    torch.cuda.empty_cache()
    print(f"[bf16 kernels] phase took {time.time() - t0:.1f} s")
    return results


ATTENTION_CASES = [  # (kernel, path, (B, T, heads), causal, timed, input scale)
    ("fused_qkv", "benchmark", (256, 257, 16), False, True, 1),  # ViT-L/14 vision
    ("fused_qkv", None, (1024, 50, 12), False, True, 1),  # ViT-B/32 vision, impl="fused"
    ("fused_qkv", None, (1024, 77, 12), True, True, 1),  # ViT-L/14 text, impl="fused"
    ("fused_qkv", None, (3, 257, 16), False, False, 1),  # ragged: 1-row last tile
    ("packed_attention", "pallas", (64, 50, 12), False, True, 1),  # ViT-B/32, "pallas"
    ("packed_attention", None, (256, 257, 16), False, True, 1),  # ViT-L/14, "pallas"
    ("fused_qkv", None, (8, 257, 16), False, False, 4),  # large scores
]
ATTENTION_CALLS = 20  # back-to-back calls between one pair of CUDA events


def attention_case(case: tuple, gen):
    """The inputs of one ``ATTENTION_CASES`` row on the card: the kernel's
    call, its plain version's, ``scaled_dot_product_attention``'s on the same
    q/k/v viewed as [B, H, T, 64], a label, and the work the bounds count."""
    import torch
    import torch.nn.functional as F

    from clip_ppo_tpu_torch.models.clip import attention_kernels as ak

    name, _, (b, t, h), causal, _, mag = case
    d = h * 64
    qkv = mag * torch.randn((b, t, 3 * d), generator=gen, device=gen.device)
    q, k, v = (z.view(b, t, h, 64) for z in qkv.split(d, dim=-1))  # row stride 3D
    if name == "fused_qkv":
        fn = lambda: ak.fused_qkv_attention(qkv, h, causal)  # noqa: E731
        plain = lambda: ak.fused_qkv_attention_plain(qkv, h, causal)  # noqa: E731
        shape = f"[{b},{t},{3 * d}]" + (" causal" if causal else "")
        shape += f" x{mag}" if mag != 1 else ""
    else:
        fn = lambda: ak.packed_attention(q, k, v)  # noqa: E731
        plain = lambda: ak.packed_attention_plain(q, k, v)  # noqa: E731
        shape = f"[{b},{t},{h},64] strided"
    qh, kh, vh = (z.transpose(1, 2) for z in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)  # noqa: E731
    pairs = t * (t + 1) // 2 if causal else t * t
    nflops = 2 * 2 * b * pairs * d  # scores and weighted values
    nbytes = 4 * b * t * d * 4  # q, k, v read; out written
    return fn, plain, sdpa, shape, nflops, nbytes


def phase_attention(card: dict) -> list[dict]:
    """K4 and K8 against their plain versions on the card, timed beside
    ``scaled_dot_product_attention`` on the same q/k/v viewed as
    [B, H, T, 64] (the library yardstick; the port never calls it). Kernel,
    plain version and SDPA are timed alike, by CUDA events around
    ``ATTENTION_CALLS`` back-to-back calls, so the host's launch overhead
    is hidden wherever the device is the slower of the two; their device
    time per call from a profiler trace stands beside, as ``device_ms`` and
    ``library_device_ms``. The kernel runs both products in 3xTF32 (three
    TF32 passes per fp32 product), so its bound is the larger of the bytes
    and 3 x the flops at the TF32 peak; the fp32 CUDA-core bound stands
    beside it. A case with inputs x 4 (scores up to |s| ~ 30) shows that the
    three passes hold the full-fp32 tolerance where one TF32 pass would
    not."""
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src = "clip_ppo_tpu_torch/csrc/fused_qkv.cu"
    results = []
    with torch.no_grad():
        for case in ATTENTION_CASES:
            name, path, _, _, timed, _ = case
            fn, plain, sdpa, shape, nflops, nbytes = attention_case(case, gen)
            got, ref = fn(), plain()
            torch.cuda.synchronize()
            err, rel = _errors(got, ref)
            scale = ref.abs().max().item()
            tol = 1e-4 * max(1.0, scale)
            del got, ref
            print(f"[kernels] {name} {shape}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                  f"(max |ref| {scale:.3f}; tolerance 1e-4 x max(1, max |ref|) = {tol:.1e})")
            if not err <= tol:
                fail(f"{name} {shape} disagrees with its plain version: {err} > {tol}")
            if not timed:
                continue
            n = ATTENTION_CALLS
            ms, library_ms = time_ms(fn, reps=10, calls=n), time_ms(sdpa, reps=10, calls=n)
            plain_ms = time_ms(plain, reps=10, calls=n)
            dev_ms, library_dev_ms = device_ms(fn, calls=n), device_ms(sdpa, calls=n)
            bound_fp32_ms = _bound(nbytes, nflops, card)[0]
            bound_ms, bound_by = _bound_tf32x3(nbytes, nflops, card)
            print(f"[kernels] {name} {shape}: {ms:.4f} ms per call over {n} back-to-back calls "
                  f"(device time {_fmt_ms(dev_ms)}), plain {plain_ms:.3f} ms, "
                  f"scaled_dot_product_attention {library_ms:.4f} ms (device time "
                  f"{_fmt_ms(library_dev_ms)}; {library_ms / ms:.2f}x the kernel's time), "
                  f"bound {bound_ms:.3f} ms ({bound_by}; {ms / bound_ms:.2f}x it), fp32 "
                  f"CUDA-core bound {bound_fp32_ms:.3f} ms, {nflops / 1e9:.1f} GFLOP, "
                  f"{nflops / ms / 1e9:.2f} TFLOP/s")
            results.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": "clip_ppo_tpu/models/clip/pallas_attention.py:"
                            + ("91" if name == "fused_qkv" else "391"),
                "shape": shape, "path": path, "max_abs_err": err, "max_rel_err": rel,
                "tolerance": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_fp32_ms": bound_fp32_ms, "library_ms": library_ms,
                "device_ms": dev_ms, "library_device_ms": library_dev_ms,
            })
    torch.cuda.empty_cache()
    return results


SLICES = {
    # modality: launches expected on the CLI's main path, per iteration (every
    # other kernel none); ViT-B/16's image path launches ViT-B/32's kernels
    "text": {"disturb": 128},
    "image": {"attn_block": 12, "mlp_stream": 12, "disturb": 128},
}
STARTUP = {"text": {"attn_block": 12, "mlp_block": 12}, "image": {}}  # the text table


def phase_slice(results: list[dict], card: dict, modality: str,
                model: str = "ViT-B/32") -> None:
    """The CLIP-PPO MiniGrid CLI with ``modality`` at ``model`` for two
    iterations, every kernel's launches against ``SLICES`` (ViT-B/32's runs
    give the kernels line its launches)."""
    import math

    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as cli
    from clip_ppo_tpu_torch.utils import flags

    t_phase = time.time()
    argv = [
        "--clip-config.clip-lambda", "1e-5", "--clip-config.clip-modality", modality,
        "--clip-config.clip-model", model,
        "--clip-config.apply-disturbances", "--clip-config.disturbance-severity", "HARD",
        "--total-timesteps", "2048", "--no-capture-video", "--seed", "1",
    ]
    args = flags.parse(cli.Args, argv)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            args.model_path = os.path.join(tmp, "checkpoints")
            cuda_build.reset_launches()
            t0 = time.time()
            summary = cli.train(args, run_name="chip_smoke")
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = dict(cuda_build.LAUNCHES)
            events = [f for _, _, fs in os.walk(os.path.join(tmp, "runs")) for f in fs
                      if "tfevents" in f]
            ckpts = os.listdir(args.model_path)
        finally:
            os.chdir(cwd)
    iters = args.num_iterations
    tag = f"[{modality} slice]" if model == "ViT-B/32" else f"[{modality} slice {model}]"
    print(f"{tag} {iters} iterations of {args.num_envs}x{args.num_steps} on {args.env_id} "
          f"at {model} in {wall:.2f} s wall; launches {launches}")
    print(f"{tag} text table build {summary['table_seconds']:.3f} s; steady SPS "
          f"{summary['sps']:.1f}; first_clip_loss {float(summary['last_scalars']['first_clip_loss']):.6f} "
          f"on {card['smi']}")
    for name in launches:
        n = SLICES[modality].get(name, 0) * iters + STARTUP[modality].get(name, 0)
        if launches[name] != n:
            fail(f"{name} launched {launches[name]} times on the {modality} path at {model}, "
                 f"expected {n}")
    for key, v in summary["last_scalars"].items():
        if not math.isfinite(float(v)) and key != "explained_variance":
            fail(f"non-finite {key} = {v}")
    if not float(summary["last_scalars"]["first_clip_loss"]) > 0.0:
        fail("the CLIP loss did not run (first_clip_loss is not > 0)")
    if not events:
        fail("no TensorBoard event file written")
    if not any(c.endswith("_final.ckpt") for c in ckpts):
        fail(f"no final checkpoint among {ckpts}")
    if model == "ViT-B/32":
        record_launches(results, modality, launches)
    else:
        print(f"{tag} phase took {time.time() - t_phase:.1f} s")


def phase_image_encode(card: dict, model: str = "ViT-B/32") -> None:
    """The vision tower's embeddings of a few frames through the kernels on
    the card, against the plain versions on the CPU with the same weights."""
    import torch

    from clip_ppo_tpu_torch.models import clip_utils
    from clip_ppo_tpu_torch.utils.tree import tree_map

    dev = torch.device("cuda", 0)
    params, cfg = clip_utils.load_clip_model(model, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    frames = torch.randint(0, 256, (8, 84, 84, 3), generator=gen, device=dev, dtype=torch.uint8)
    got = clip_utils.encode_images(params, cfg, frames).cpu()
    ref = clip_utils.encode_images(tree_map(lambda t: t.cpu(), params), cfg, frames.cpu())
    err = (got - ref).abs().max().item()
    print(f"[image encode] 8 frames through the {model} tower (K2 + K5 on the card, T = "
          f"{cfg.num_patches + 1}) vs the plain versions on the CPU: shape {tuple(got.shape)}, "
          f"max_abs_err {err:.3e} on unit vectors (tolerance 1e-4)")
    if got.shape != (8, cfg.embed_dim) or not torch.isfinite(got).all() or not err <= 1e-4:
        fail(f"image embeddings on the card disagree with the CPU: {err}")


def phase_profile(card: dict, modality: str) -> None:
    """Where one steady iteration of a slice's configuration spends its
    time: host wall clock per part (synchronized), and the device's busy
    share from a torch.profiler trace of a whole iteration."""
    import torch

    from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
    from clip_ppo_tpu_torch.models import clip_utils
    from clip_ppo_tpu_torch.models.agent import init_agent_params
    from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity, SEVERITY_CONFIGS
    from clip_ppo_tpu_torch.train.ppo import PPOConfig
    from clip_ppo_tpu_torch.train.runner import Trainer

    dev = torch.device("cuda", 0)
    env = TorchVectorEnv("MiniGrid-Empty-16x16-v0", 8, dev)
    clip_params, clip_cfg = clip_utils.load_clip_model("ViT-B/32", dev)
    if modality == "image":
        embed = {"embed_images_fn": clip_utils.make_encode_images_fn(clip_cfg)}
        frozen = {"clip": clip_params}
    else:
        suffix = ", objects: wall at (0,0), wall at (0,1), wall at (0,2)"
        table = clip_utils.build_minigrid_text_table(clip_params, clip_cfg, 16, 16, suffix)
        del clip_params
        embed = {"embed_desc_fn": clip_utils.make_text_table_embed_fn(16)}
        frozen = {"text_table": table}
    cfg = PPOConfig(clip_mode="precomputed")
    trainer = Trainer(cfg, env, 2, disturbance=SEVERITY_CONFIGS[DisturbanceSeverity.HARD],
                      clip_lambda=1e-5, frozen_params=frozen, **embed)
    gen = torch.Generator()
    gen.manual_seed(1)
    state = trainer.init_state(init_agent_params(gen, env.num_actions, dev), 1)
    profile_iteration(trainer, state, f"[{modality} profile]",
                      f"8x128, Empty-16x16, HARD, {modality} modality", card,
                      "CLIP encode" if modality == "image" else "table gather")


def profile_iteration(trainer, state, tag: str, what: str, card: dict,
                      embed_part: str | None = None) -> dict:
    """One steady iteration by part, host wall clock with a device
    synchronize after each part, and the device's busy share from a
    torch.profiler trace of the next iteration against the untraced wall.
    Returns the parts in seconds, the total and the busy seconds."""
    import torch

    from clip_ppo_tpu_torch.train.runner import Draws

    state = trainer.iteration(state, 1)[0]  # warm-up
    torch.cuda.synchronize()
    parts = {}
    t0 = time.perf_counter()
    state, batch = trainer._rollout(state, Draws())
    torch.cuda.synchronize()
    parts["rollout"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = trainer._data2d(state, batch)
    torch.cuda.synchronize()
    parts["GAE"] = time.perf_counter() - t0
    emb = None
    if embed_part is not None:
        t0 = time.perf_counter()
        emb = trainer.embed(batch, data)
        torch.cuda.synchronize()
        parts[embed_part] = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, _ = trainer._update(state, data, 2, emb, Draws())
    torch.cuda.synchronize()
    parts["update"] = time.perf_counter() - t0
    total = sum(parts.values())
    steps = trainer.cfg.num_envs * trainer.cfg.num_steps
    print(f"{tag} one iteration ({what}), host wall: "
          + ", ".join(f"{k} {v * 1e3:.1f} ms ({100 * v / total:.1f}%)" for k, v in parts.items())
          + f"; total {total * 1e3:.1f} ms = {steps / total:.0f} env-steps/s on {card['smi']}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        trainer.iteration(state, 2)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = _kernel_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    out = {"parts": parts, "total": total, "busy": busy if busy > 0 else None}
    if busy <= 0:
        print(f"{tag} device busy share: not measured (the trace holds no device time)")
        return out
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    # The tracer itself slows the host many times over, so the busy share is
    # taken against the untraced iteration's wall time above.
    print(f"{tag} device busy {busy * 1e3:.1f} ms per iteration = {100 * busy / total:.1f}% of "
          f"the untraced {total * 1e3:.1f} ms (idle {100 * (1 - busy / total):.1f}%; traced wall "
          f"{wall * 1e3:.0f} ms, {sum(e.count for e in events)} kernel launches); top kernels: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms x{e.count}" for e in top))
    print(f"{tag} device time by ported kernel (the device side of the profiler range "
          "around each entry point's call, first kernel's start to last kernel's end): "
          + _fmt_ported(by_ported_kernel(prof)))
    return out


# The CLIP-PPO CLI's ablation runs (HARD disturbances, 2 iterations of
# 8 x 128 on Empty-16x16 at ViT-B/32): FROZEN_CLIP's trunk is the bf16 vision
# tower, RANDOM_ENCODER aligns with Gaussian embeddings (λ = 1e-5).
ABLATIONS = {
    "FROZEN_CLIP": [],
    "RANDOM_ENCODER": ["--clip-config.clip-lambda", "1e-5"],
}


def ablation_launches(args, mode: str) -> dict:
    """Each kernel's launches per iteration of the CLI under ``mode``, from
    its configuration: K1 once a rollout step; under FROZEN_CLIP K2 and K3
    in bf16 once a vision layer for every tower call (each rollout step, the
    bootstrap value, each minibatch of the update); nothing else."""
    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.models.clip.config import CLIP_CONFIGS

    per = {k: 0 for k in cuda_build.LAUNCHES}
    per["disturb"] = args.num_steps
    if mode == "FROZEN_CLIP":
        calls = args.num_steps + 1 + args.update_epochs * args.num_minibatches
        layers = CLIP_CONFIGS[args.clip_config.clip_model].vision_layers
        per["attn_block_bf16"] = per["mlp_block_bf16"] = layers * calls
    return per


def phase_ablation(results: list[dict], card: dict, mode: str, structured: bool = False) -> None:
    """The CLIP-PPO MiniGrid CLI under ``mode`` for two iterations, through
    its ``train()``: every kernel's launches against
    :func:`ablation_launches`, finite losses, the CLIP loss off (FROZEN_CLIP)
    or on (RANDOM_ENCODER), view mode off (HARD disturbances), the TensorBoard
    events and the final checkpoint. With ``structured`` the run passes
    ``--clip-config.structured-frozen-init``: the distillation's MSE at its
    first and last step must fall, and it launches no kernel (its tower runs
    the plain route, as the JAX distillation does)."""
    import math

    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as cli
    from clip_ppo_tpu_torch.utils import flags

    t_phase = time.time()
    argv = [
        "--clip-config.ablation-mode", mode, *ABLATIONS[mode],
        "--clip-config.apply-disturbances", "--clip-config.disturbance-severity", "HARD",
        "--total-timesteps", "2048", "--no-capture-video", "--seed", "1",
        *(["--clip-config.structured-frozen-init"] if structured else []),
    ]
    args = flags.parse(cli.Args, argv)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            args.model_path = os.path.join(tmp, "checkpoints")
            cuda_build.reset_launches()
            t0 = time.time()
            summary = cli.train(args, run_name="chip_smoke")
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = dict(cuda_build.LAUNCHES)
            events = [f for _, _, fs in os.walk(os.path.join(tmp, "runs")) for f in fs
                      if "tfevents" in f]
            ckpts = os.listdir(args.model_path)
        finally:
            os.chdir(cwd)
    iters = args.num_iterations
    per = ablation_launches(args, mode)
    tag = f"[{mode} structured]" if structured else f"[{mode}]"
    scalars = summary["last_scalars"]
    if structured:
        losses = summary["distill_losses"]
        if losses is None:
            fail(f"{tag}: the distillation did not run")
        print(f"{tag} distillation: {len(losses)} Adam steps at batch 64 through the bf16 "
              f"ViT-B/32 vision tower (plain route, autograd) in {summary['distill_seconds']:.2f} "
              f"s wall, {len(losses) / summary['distill_seconds']:.1f} steps/s; MSE "
              f"{float(losses[0]):.6f} at the first step, {float(losses[-1]):.6f} at the last "
              f"on {card['smi']}")
        if not float(losses[-1]) < float(losses[0]) or not torch.isfinite(losses).all():
            fail(f"{tag}: the distillation MSE did not fall ({float(losses[0])} -> "
                 f"{float(losses[-1])})")
    print(f"{tag} python -m clip_ppo_tpu_torch.cli.clip_ppo_minigrid {' '.join(argv)}: {iters} "
          f"iterations of {args.num_envs}x{args.num_steps} on {args.env_id} at "
          f"{args.clip_config.clip_model} in {wall:.2f} s wall; view mode {summary['view_mode']}; "
          f"launches {launches} (expected per iteration {per}); steady SPS {summary['sps']:.1f}; "
          + ", ".join(f"{k} {float(scalars[k]):.6f}"
                      for k in ("policy_loss", "value_loss", "entropy", "first_clip_loss"))
          + f" on {card['smi']}")
    for name, n in per.items():
        if launches[name] != n * iters:
            fail(f"{name} launched {launches[name]} times under {mode}, expected {n * iters}")
    for key, v in scalars.items():
        if not math.isfinite(float(v)) and key != "explained_variance":
            fail(f"non-finite {key} = {v} under {mode}")
    clip_on = float(scalars["first_clip_loss"]) > 0.0
    if clip_on != (mode == "RANDOM_ENCODER"):
        fail(f"{mode}: the CLIP loss {'ran' if clip_on else 'did not run'} "
             f"(first_clip_loss {float(scalars['first_clip_loss'])})")
    if summary["view_mode"]:
        fail(f"{mode} took the view fast path under HARD disturbances")
    if not events:
        fail(f"no TensorBoard event file written under {mode}")
    if not any(c.endswith("_final.ckpt") for c in ckpts):
        fail(f"no final checkpoint among {ckpts}")
    if mode == "FROZEN_CLIP" and not structured:
        record_launches(results, "frozen", launches)
    print(f"{tag} phase took {time.time() - t_phase:.1f} s")


def phase_frozen_profile(card: dict) -> None:
    """One steady FROZEN_CLIP iteration (8 x 128, Empty-16x16, HARD,
    ViT-B/32 in bf16) by part, with the device's busy share and its time by
    ported kernel."""
    import torch

    from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
    from clip_ppo_tpu_torch.models import clip_utils
    from clip_ppo_tpu_torch.models.agent import init_agent_params
    from clip_ppo_tpu_torch.models.clip.model import cast_tower
    from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity, SEVERITY_CONFIGS
    from clip_ppo_tpu_torch.train.ppo import PPOConfig
    from clip_ppo_tpu_torch.train.runner import Trainer

    t0 = time.time()
    dev = torch.device("cuda", 0)
    env = TorchVectorEnv("MiniGrid-Empty-16x16-v0", 8, dev)
    clip_params, clip_cfg = clip_utils.load_clip_model("ViT-B/32", dev)
    trainer = Trainer(PPOConfig(), env, 2, disturbance=SEVERITY_CONFIGS[DisturbanceSeverity.HARD],
                      features_fn=clip_utils.make_frozen_clip_features_fn(clip_cfg),
                      frozen_params={"clip": cast_tower(clip_params, torch.bfloat16)})
    del clip_params
    gen = torch.Generator()
    gen.manual_seed(1)
    state = trainer.init_state(init_agent_params(gen, env.num_actions, dev), 1)
    profile_iteration(trainer, state, "[FROZEN_CLIP profile]",
                      "8x128, Empty-16x16, HARD, FROZEN_CLIP, ViT-B/32 in bf16", card)
    print(f"[FROZEN_CLIP profile] phase took {time.time() - t0:.1f} s")


def phase_frozen_encode(card: dict) -> None:
    """The FROZEN_CLIP trunk's features of a few frames: the bf16 ViT-B/32
    vision tower through K2 and K3 in bf16 on the card against the plain bf16
    route on the CPU with the same weights, L2-normalized, 2e-2 absolute
    (the bound ``tests/test_clip.py`` puts on bf16 against float32)."""
    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.models import clip_utils
    from clip_ppo_tpu_torch.models.clip.model import cast_tower
    from clip_ppo_tpu_torch.utils.tree import tree_map

    t0 = time.time()
    dev = torch.device("cuda", 0)
    params, cfg = clip_utils.load_clip_model("ViT-B/32", dev)
    visual = cast_tower({"visual": params["visual"]}, torch.bfloat16)
    del params
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    frames = torch.randint(0, 256, (4, 84, 84, 3), generator=gen, device=dev, dtype=torch.uint8)
    cuda_build.reset_launches()
    got = clip_utils.get_frozen_clip_features(visual, cfg, frames.float() / 255.0)
    launches = _launch_delta({k: 0 for k in cuda_build.LAUNCHES}, cuda_build.LAUNCHES)
    got = clip_utils.l2_normalize(got).cpu()
    t_cpu = time.time()
    ref = clip_utils.l2_normalize(clip_utils.get_frozen_clip_features(
        tree_map(lambda t: t.cpu(), visual), cfg, frames.cpu().float() / 255.0))
    t_cpu = time.time() - t_cpu
    err = (got - ref).abs().max().item()
    want = {"attn_block_bf16": cfg.vision_layers, "mlp_block_bf16": cfg.vision_layers}
    print(f"[frozen encode] 4 frames through the bf16 ViT-B/32 vision tower (launches {launches}) "
          f"vs the plain bf16 route on the CPU ({t_cpu:.1f} s): shape {tuple(got.shape)}, "
          f"max_abs_err {err:.3e} on unit vectors (tolerance 2e-2)")
    if launches != want:
        fail(f"the bf16 vision tower launched {launches}, expected {want}")
    if got.shape != (4, cfg.embed_dim) or not torch.isfinite(got).all() or not err <= 2e-2:
        fail(f"bf16 tower features on the card disagree with the CPU: {err}")
    print(f"[frozen encode] phase took {time.time() - t0:.1f} s")


# The vanilla CLI's two runs: the view fast path, and per-image HARD
# disturbances. Neither reaches a kernel of the port: per-image
# disturbances are plain PyTorch, never K1, which computes the batched
# function.
VANILLA_RUNS = [("view mode", [], True),
                ("per-image HARD", ["--apply-disturbances", "--disturbance-severity", "HARD"],
                 False)]
# The per-image tolerance of tests/port/test_torch_disturb_per_image.py: one
# uint8 level at most, and at most 2 in 10,000 elements a level apart.
PER_IMAGE_LEVEL_TOL, PER_IMAGE_MAX_SHARE_OFF = 1 / 255 + 1e-6, 2e-4


def phase_vanilla(card: dict) -> None:
    """Vanilla PPO on MiniGrid (``cli/ppo_minigrid.py``): the view trunk
    against the dense conv and the per-image disturbance against the CPU on
    the card, the per-image disturbance's time per rollout step beside K1's
    batched call, the CLI for two iterations in view mode and two under
    per-image HARD disturbances (no kernel launched, view mode on and off as
    expected, losses finite), and one steady iteration of each by part."""
    import math

    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.cli import ppo_minigrid as cli
    from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
    from clip_ppo_tpu_torch.models import agent as agent_mod
    from clip_ppo_tpu_torch.models import nature_cnn as cnn
    from clip_ppo_tpu_torch.ops import disturbances as D
    from clip_ppo_tpu_torch.ops.resize import upscale_nearest
    from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity, SEVERITY_CONFIGS
    from clip_ppo_tpu_torch.train.ppo import PPOConfig
    from clip_ppo_tpu_torch.train.runner import Trainer
    from clip_ppo_tpu_torch.utils import flags
    from clip_ppo_tpu_torch.utils.tree import tree_map

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    # -- the view trunk against the dense conv on the card: the rollout's
    # batch of 8 and the update's minibatch of 256, features and gradients.
    # The biases are drawn at random: at their init of 0 a conv1 unit whose
    # inputs cancel sits at 0 within round-off, where the two formulations'
    # ReLUs may pass its gradient in one and not in the other --
    pgen = torch.Generator()
    pgen.manual_seed(11)
    params = agent_mod.init_agent_params(pgen, 7, dev)
    for layer in params["trunk"].values():
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen, device=dev)
    for b in (8, 256):
        view = torch.randint(0, 11, (b, 7, 7, 3), generator=gen, device=dev, dtype=torch.uint8)
        weights = torch.randn(b, 512, generator=gen, device=dev)
        trunk = tree_map(lambda t: t.detach().clone().requires_grad_(True), params["trunk"])
        leaves = [trunk[k][n] for k in trunk for n in ("w", "b")]
        got = cnn.nature_cnn_view(trunk, view.float(), 12, v_scale=1.0 / 255.0)
        g_got = torch.autograd.grad((got * weights).sum(), leaves)
        ref = cnn.nature_cnn(trunk, upscale_nearest(view, 12).float() / 255.0)
        g_ref = torch.autograd.grad((ref * weights).sum(), leaves)
        fixed = agent_mod.make_view_features(12).fixed(params)(params, view)
        worst = max(_errors(got, ref)[1], _errors(fixed, ref.detach())[1],
                    *(_errors(a, r)[1] for a, r in zip(g_got, g_ref)))
        print(f"[vanilla] view trunk vs the dense conv on the ×12 upscale, [{b},7,7,3], TF32 "
              f"off: largest error relative to max |ref| over the features (autograd and "
              f"rollout pre-sum) and the 8 weight gradients {worst:.3e} (tolerance 1e-5)")
        if not worst <= 1e-5:
            fail(f"the view trunk disagrees with the dense conv at batch {b}: {worst}")

    # -- the per-image disturbance on the card against the CPU, same draws --
    x = torch.randint(0, 256, (8, 84, 84, 3), generator=gen, device=dev).float() / 255.0
    for sev in ("MILD", "MODERATE", "HARD", "SEVERE"):
        p = SEVERITY_CONFIGS[DisturbanceSeverity[sev]]
        d = D.draw(x, p, gen, "per_image")
        got = D.disturb(x, p, d, "per_image").cpu()
        ref = D.disturb(x.cpu(), p, D.DisturbanceDraws(*(t.cpu() for t in d[:3])), "per_image")
        diff = (got - ref).abs()
        off = (diff > 1e-6).float().mean().item()
        print(f"[vanilla] per-image {sev} [8,84,84,3] on the card vs the CPU on the same draws: "
              f"max {diff.max().item() * 255:.3f} levels, {off:.2e} of the elements a level "
              f"apart (tolerance 1 level, {PER_IMAGE_MAX_SHARE_OFF:.0e})")
        if not (diff.max().item() <= PER_IMAGE_LEVEL_TOL and off <= PER_IMAGE_MAX_SHARE_OFF):
            fail(f"the per-image disturbance on the card disagrees with the CPU at {sev}")

    # -- time per rollout step at [8, 84, 84, 3]: the per-image pipeline with
    # its draws (what a vanilla rollout step runs) and on given draws, beside
    # K1's batched call with its draws (what a CLIP rollout step runs) --
    hard = SEVERITY_CONFIGS[DisturbanceSeverity.HARD]
    d_pi = D.draw(x, hard, gen, "per_image")
    calls = {
        "per-image with its draws": lambda: D.disturb_auto(x, hard, gen, semantics="per_image"),
        "per-image on given draws": lambda: D.disturb(x, hard, d_pi, "per_image"),
        "K1 batched with its draws": lambda: D.disturb_auto(x, hard, gen),
    }
    timed = {k: (time_ms(f, reps=20, calls=50), device_ms(f, calls=50)) for k, f in calls.items()}
    print("[vanilla] disturbance per rollout step, HARD [8,84,84,3], CUDA events over 50 "
          "back-to-back calls (torch.profiler device time of all its kernels): "
          + "; ".join(f"{k} {t:.4f} ms ({_fmt_ms(dt)})" for k, (t, dt) in timed.items())
          + f" on {card['smi']}")

    # -- the CLI, two iterations each way; no kernel of the port launches --
    for label, extra, view_mode in VANILLA_RUNS:
        args = flags.parse(cli.Args, ["--total-timesteps", "2048", "--no-capture-video",
                                      "--seed", "1", *extra])
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                args.model_path = os.path.join(tmp, "checkpoints")
                cuda_build.reset_launches()
                t0 = time.time()
                summary = cli.train(args, run_name="chip_smoke_vanilla")
                torch.cuda.synchronize()
                wall = time.time() - t0
                launches = dict(cuda_build.LAUNCHES)
                ckpts = os.listdir(args.model_path)
            finally:
                os.chdir(cwd)
        print(f"[vanilla {label}] {args.num_iterations} iterations of {args.num_envs}x"
              f"{args.num_steps} on {args.env_id} in {wall:.2f} s wall; view mode "
              f"{summary['view_mode']}; launches {launches}; steady SPS {summary['sps']:.1f}; "
              f"losses " + ", ".join(f"{k} {float(summary['last_scalars'][k]):.5f}"
                                     for k in ("policy_loss", "value_loss", "entropy")))
        if any(launches.values()):
            fail(f"the vanilla path ({label}) launched kernels of the port: {launches}")
        if summary["view_mode"] is not view_mode:
            fail(f"view mode is {summary['view_mode']} on the vanilla path ({label})")
        for key, v in summary["last_scalars"].items():
            if not math.isfinite(float(v)) and key != "explained_variance":
                fail(f"non-finite {key} = {v} on the vanilla path ({label})")
        if not any(c.endswith("_final.ckpt") for c in ckpts):
            fail(f"no final checkpoint among {ckpts}")

    # -- one steady iteration of each by part --
    for label, disturbance in (("view mode", None), ("per-image HARD", hard)):
        env = TorchVectorEnv("MiniGrid-Empty-16x16-v0", 8, dev)
        trainer = Trainer(PPOConfig(), env, 2, disturbance=disturbance,
                          disturbance_semantics="per_image")
        pgen = torch.Generator()
        pgen.manual_seed(1)
        state = trainer.init_state(agent_mod.init_agent_params(pgen, env.num_actions, dev), 1)
        profile_iteration(trainer, state, f"[vanilla {label} profile]",
                          f"8x128, Empty-16x16, vanilla PPO, {label}", card)


# The encoder benchmark's two runs, and the launches each call must make.
BENCH_L14 = ["--model", "ViT-L/14", "--dtype", "float32", "--batch-sizes", "64", "256",
             "--text-batch", "1024", "--iterations", "3"]
BENCH_L14_PER_CALL = {"image": {"fused_qkv": 24, "mlp_stream": 24},
                      "text": {"attn_block": 12, "mlp_stream": 12}}
# The encoder benchmark at its default dtype, bf16, at ViT-B/32: both towers
# run K2 and K3 in bf16 (the text tower is 512 wide).
BENCH_BF16 = ["--model", "ViT-B/32", "--batch-sizes", "64", "256", "1024", "--text-batch",
              "1024", "--iterations", "3"]
BENCH_BF16_PER_CALL = {"image": {"attn_block_bf16": 12, "mlp_block_bf16": 12},
                       "text": {"attn_block_bf16": 12, "mlp_block_bf16": 12}}
BENCH_PALLAS = ["--model", "ViT-B/32", "--dtype", "float32", "--attention-impl", "pallas",
                "--batch-sizes", "64", "--iterations", "2"]
BENCH_PALLAS_PER_CALL = {"image": {"packed_attention": 12},
                         "text": {"attn_block": 12, "mlp_block": 12}}
# ViT-L/14 under the JAX package's weight-streaming switches, one batch size
# and 2 iterations a run (3 in the default run above), each switch with the
# launches of every call: (label, environment, launches per call).
BENCH_SWITCH = ["--model", "ViT-L/14", "--dtype", "float32", "--batch-sizes", "256",
                "--text-batch", "1024", "--iterations", "2"]
SWITCH_VARS = ("CLIP_PPO_ATTN_STREAM", "CLIP_PPO_MLP_CHUNKED", "CLIP_PPO_MLP_STREAM")
BOTH = {"CLIP_PPO_ATTN_STREAM": "1", "CLIP_PPO_MLP_CHUNKED": "1"}
SWITCHES = [
    ("attn_stream", {"CLIP_PPO_ATTN_STREAM": "1"},
     {"image": {"attn_stream": 24, "mlp_stream": 24}, "text": {"attn_block": 12, "mlp_stream": 12}}),
    ("mlp_chunked", {"CLIP_PPO_MLP_CHUNKED": "1"},
     {"image": {"fused_qkv": 24, "mlp_chunked": 24}, "text": {"attn_block": 12, "mlp_chunked": 12}}),
    ("both", BOTH,
     {"image": {"attn_stream": 24, "mlp_chunked": 24}, "text": {"attn_block": 12, "mlp_chunked": 12}}),
    ("mlp_stream_off", {"CLIP_PPO_MLP_STREAM": "0"},
     {"image": {"fused_qkv": 24}, "text": {"attn_block": 12}}),
]


# The encoder benchmark at its default dtype, bf16, at ViT-L/14: every kernel
# through its bf16 entry point. The vision tower takes K4 and K5 (K6 and K7
# under the switches); the text tower's 768-wide MLP fits the budget in bf16,
# so it takes K2 and K3 under every switch.
L14_BF16_TEXT = {"attn_block_bf16": 12, "mlp_block_bf16": 12}
BENCH_L14_BF16 = ["--model", "ViT-L/14", "--batch-sizes", "64", "256", "--text-batch", "1024",
                  "--iterations", "3"]
BENCH_L14_BF16_PER_CALL = {"image": {"fused_qkv_bf16": 24, "mlp_stream_bf16": 24},
                           "text": L14_BF16_TEXT}
BENCH_SWITCH_BF16 = ["--model", "ViT-L/14", "--batch-sizes", "256", "--text-batch", "1024",
                     "--iterations", "2"]
SWITCHES_BF16 = [
    ("attn_stream_bf16", {"CLIP_PPO_ATTN_STREAM": "1"},
     {"image": {"attn_stream_bf16": 24, "mlp_stream_bf16": 24}, "text": L14_BF16_TEXT}),
    ("mlp_chunked_bf16", {"CLIP_PPO_MLP_CHUNKED": "1"},
     {"image": {"fused_qkv_bf16": 24, "mlp_chunked_bf16": 24}, "text": L14_BF16_TEXT}),
    ("both_bf16", BOTH,
     {"image": {"attn_stream_bf16": 24, "mlp_chunked_bf16": 24}, "text": L14_BF16_TEXT}),
    ("mlp_stream_off_bf16", {"CLIP_PPO_MLP_STREAM": "0"},
     {"image": {"fused_qkv_bf16": 24}, "text": L14_BF16_TEXT}),
]
# ViT-B/32 in bf16 under --attention-impl fused (K4) and pallas (K8); the
# text half runs "auto" (K2 and K3 in bf16), as in the JAX tool.
B32_BF16_TEXT = {"attn_block_bf16": 12, "mlp_block_bf16": 12}
BENCH_IMPL_BF16 = [
    ("fused_bf16", ["--model", "ViT-B/32", "--attention-impl", "fused", "--batch-sizes", "1024",
                    "--iterations", "2"],
     {"image": {"fused_qkv_bf16": 12}, "text": B32_BF16_TEXT}),
    ("pallas_bf16", ["--model", "ViT-B/32", "--attention-impl", "pallas", "--batch-sizes", "64",
                     "--iterations", "2"],
     {"image": {"packed_attention_bf16": 12}, "text": B32_BF16_TEXT}),
]
# ViT-B/16 (T = 197) at one batch size in each dtype: bf16 both towers on K2
# and K3 in bf16; float32 its vision tower on K2 and K5, its 512-wide text
# tower on K2 and K3.
BENCH_B16 = [
    ("b16_bf16", ["--model", "ViT-B/16", "--batch-sizes", "256", "--iterations", "3"],
     {"image": {"attn_block_bf16": 12, "mlp_block_bf16": 12}, "text": B32_BF16_TEXT}),
    ("b16_f32", ["--model", "ViT-B/16", "--dtype", "float32", "--batch-sizes", "256",
                 "--iterations", "3"],
     {"image": {"attn_block": 12, "mlp_stream": 12}, "text": {"attn_block": 12, "mlp_block": 12}}),
]


@contextlib.contextmanager
def switches(env: dict):
    """Run with exactly the switches in ``env`` set, the others unset."""
    saved = {k: os.environ.pop(k, None) for k in SWITCH_VARS}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def _launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def phase_benchmark(results: list[dict], card: dict, path: str, argv: list[str],
                    per_call: dict) -> list[tuple]:
    """The port's CLIP encoder benchmark as a user runs it, through its
    ``main()``. Each timing (one per image batch size, then the text batch)
    makes 1 + iterations calls; the launches of each are read around it and
    must match ``per_call`` ("image" and "text": kernel -> launches per
    call, every other kernel none)."""
    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.cli import benchmark_clip as bench

    timings = []
    real = bench._bench

    def counted(fn, data, iterations):
        before = dict(cuda_build.LAUNCHES)
        seconds = real(fn, data, iterations)
        torch.cuda.synchronize()
        timings.append((data.shape[0], seconds, iterations + 1,
                        _launch_delta(before, cuda_build.LAUNCHES)))
        return seconds

    tag = f"[benchmark {path}]"
    env = " ".join(f"{k}={os.environ[k]}" for k in SWITCH_VARS if k in os.environ)
    print(f"{tag} {env + ' ' if env else ''}python -m clip_ppo_tpu_torch.cli.benchmark_clip "
          f"{' '.join(argv)}")
    bench._bench = counted
    try:
        cuda_build.reset_launches()
        t0 = time.time()
        bench.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(cuda_build.LAUNCHES)
    finally:
        bench._bench = real
    *images, text = timings
    for half, rows in (("image", images), ("text", [text])):
        for batch, seconds, calls, delta in rows:
            want = {k: n * calls for k, n in per_call[half].items()}
            print(f"{tag} {half} batch {batch}: {seconds * 1e3:.2f} ms/batch, "
                  f"{batch / seconds:.1f} per second; launches over {calls} calls {delta}")
            if delta != want:
                fail(f"{path} {half} batch {batch}: launches {delta}, expected {want}")
    print(f"{tag} whole run {wall:.1f} s wall; launches {launches} on {card['smi']}")
    record_launches(results, path, launches)
    return timings


def _profile_call(call, label: str, card: dict) -> None:
    """Untraced wall time of one call, then its device time by kernel."""
    import torch

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    events = _kernel_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy <= 0:
        print(f"[large tower] device time of {label}: not measured (no device time in the trace)")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    print(f"[large tower] {label}: {wall * 1e3:.1f} ms untraced wall, device "
          f"busy {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}% of the wall); by kernel: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms x{e.count} "
                      f"({100 * e.self_device_time_total / 1e6 / busy:.1f}%)" for e in top)
          + f" on {card['smi']}")
    print(f"[large tower] {label}, device time by ported kernel (the device side of the "
          f"profiler range around each entry point's call): {_fmt_ported(by_ported_kernel(prof))}")


def phase_large_tower(card: dict) -> None:
    """ViT-L/14's vision tower on its default route (K4 + K5) and under both
    weight-streaming switches (K6 + K7): its embeddings of two frames on the
    card against the plain versions on the CPU with the same weights, then
    where one batch-256 image call of each spends its device time
    (torch.profiler), beside the call's untraced wall time."""
    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.models import clip_utils
    from clip_ppo_tpu_torch.utils.tree import tree_map

    dev = torch.device("cuda", 0)
    params, cfg = clip_utils.load_clip_model("ViT-L/14", dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    frames = torch.randint(0, 256, (2, 84, 84, 3), generator=gen, device=dev, dtype=torch.uint8)
    ref = clip_utils.encode_images({"visual": tree_map(lambda t: t.cpu(), params["visual"])},
                                   cfg, frames.cpu())
    routes = [("default route", {}, {"fused_qkv": 24, "mlp_stream": 24}),
              ("both switches", BOTH, {"attn_stream": 24, "mlp_chunked": 24})]
    for label, env, want in routes:
        with switches(env):
            cuda_build.reset_launches()
            got = clip_utils.encode_images(params, cfg, frames).cpu()
            launches = _launch_delta({k: 0 for k in cuda_build.LAUNCHES}, cuda_build.LAUNCHES)
        err = (got - ref).abs().max().item()
        print(f"[large tower] {label}: 2 frames through the ViT-L/14 tower (launches {launches}) "
              f"vs the plain versions on the CPU: shape {tuple(got.shape)}, max_abs_err "
              f"{err:.3e} on unit vectors (tolerance 1e-4)")
        if launches != want:
            fail(f"ViT-L/14's vision tower ({label}) launched {launches}, expected {want}")
        if got.shape != (2, cfg.embed_dim) or not torch.isfinite(got).all() or not err <= 1e-4:
            fail(f"ViT-L/14 embeddings ({label}) on the card disagree with the CPU: {err}")

    frames = torch.randint(0, 255, (256, 84, 84, 3), generator=gen, device=dev, dtype=torch.uint8)
    for label, env, _ in routes:
        with switches(env):
            _profile_call(lambda: clip_utils.encode_images(params, cfg, frames),
                          f"one batch-256 image call, {label}", card)
    del params, frames
    torch.cuda.empty_cache()


def phase_large_tower_bf16(card: dict) -> None:
    """ViT-L/14's vision tower in bf16 as ``benchmark_clip`` runs it (cast
    once, the frames preprocessed in fp32 and encoded in bf16), on its
    default route (K4 + K5 in bf16) and under both weight-streaming switches
    (K6 + K7 in bf16): its L2-normalized features of two frames on the card
    against the plain bf16 route on the CPU with the same weights, 2e-2
    absolute (``tests/test_clip.py``'s bound on bf16 against float32); then
    where one batch-256 bf16 image call of each spends its device time."""
    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.models import clip_utils
    from clip_ppo_tpu_torch.models.clip.model import cast_tower, encode_image
    from clip_ppo_tpu_torch.ops.resize import preprocess_for_clip
    from clip_ppo_tpu_torch.utils.tree import tree_map

    t0 = time.time()
    dev = torch.device("cuda", 0)
    params, cfg = clip_utils.load_clip_model("ViT-L/14", dev)
    visual = cast_tower({"visual": params["visual"]}, torch.bfloat16)
    del params

    def features(p, frames):
        x = preprocess_for_clip(frames.float() / 255.0, cfg.image_size)
        return encode_image(p, cfg, x, torch.bfloat16)

    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    frames = torch.randint(0, 256, (2, 84, 84, 3), generator=gen, device=dev, dtype=torch.uint8)
    t_cpu = time.time()
    with torch.no_grad():
        ref = clip_utils.l2_normalize(features(tree_map(lambda t: t.cpu(), visual), frames.cpu()))
    t_cpu = time.time() - t_cpu
    routes = [("default route", {}, {"fused_qkv_bf16": 24, "mlp_stream_bf16": 24}),
              ("both switches", BOTH, {"attn_stream_bf16": 24, "mlp_chunked_bf16": 24})]
    for label, env, want in routes:
        with switches(env), torch.no_grad():
            cuda_build.reset_launches()
            got = clip_utils.l2_normalize(features(visual, frames)).cpu()
            launches = _launch_delta({k: 0 for k in cuda_build.LAUNCHES}, cuda_build.LAUNCHES)
        err = (got - ref).abs().max().item()
        print(f"[large tower bf16] {label}: 2 frames through the bf16 ViT-L/14 tower (launches "
              f"{launches}) vs the plain bf16 route on the CPU ({t_cpu:.1f} s): shape "
              f"{tuple(got.shape)}, max_abs_err {err:.3e} on unit vectors (tolerance 2e-2)")
        if launches != want:
            fail(f"the bf16 ViT-L/14 tower ({label}) launched {launches}, expected {want}")
        if got.shape != (2, cfg.embed_dim) or not torch.isfinite(got).all() or not err <= 2e-2:
            fail(f"bf16 ViT-L/14 features ({label}) on the card disagree with the CPU: {err}")
    frames = torch.randint(0, 255, (256, 84, 84, 3), generator=gen, device=dev, dtype=torch.uint8)
    for label, env, _ in routes:
        with switches(env), torch.no_grad():
            _profile_call(lambda: features(visual, frames),
                          f"one batch-256 bf16 image call, {label}", card)
    del visual, frames
    torch.cuda.empty_cache()
    print(f"[large tower bf16] phase took {time.time() - t0:.1f} s")


# Phase 11, Atari: the vanilla CLI on each game, and the CLIP-PPO CLI in
# every mode, 2 iterations of 8 envs x 128 steps each at ViT-B/32. Name:
# (CLI, argv). The image modality is the CLIP-PPO CLI's default (Breakout,
# λ = 1e-5).
ATARI_GAMES = ("ALE/Breakout-v5", "ALE/Pong-v5", "ALE/Seaquest-v5")
ATARI_RUNS = {
    "image": [],
    "image HARD Pong": ["--env-id", "ALE/Pong-v5", "--clip-config.apply-disturbances",
                        "--clip-config.disturbance-severity", "HARD"],
    "text": ["--clip-config.clip-modality", "text"],
    "FROZEN_CLIP": ["--clip-config.ablation-mode", "FROZEN_CLIP"],
    "RANDOM_ENCODER image": ["--clip-config.ablation-mode", "RANDOM_ENCODER"],
    "RANDOM_ENCODER text": ["--clip-config.ablation-mode", "RANDOM_ENCODER",
                            "--clip-config.clip-modality", "text"],
}
# The kernels line's Atari rows take their launches from these runs.
ATARI_PATHS = {"image": "atari", "image HARD Pong": "atari_hard", "FROZEN_CLIP": "atari_frozen"}


def atari_launches(args) -> dict:
    """Each kernel's launches per iteration of the CLIP-PPO Atari CLI under
    ``args``, from its configuration: K1 once a frame of each stored stack
    (4 a rollout step) under disturbances; the image modality's one bf16
    encode of the iteration's T x N stacks, K2 and K3 in bf16 once a vision
    layer; the text modality's fp32 text tower, K2 and K3 once a text layer;
    FROZEN_CLIP's bf16 tower once a vision layer for every rollout step, the
    bootstrap value and every minibatch; RANDOM_ENCODER no tower kernel."""
    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.models.agent import AblationMode
    from clip_ppo_tpu_torch.models.clip.config import CLIP_CONFIGS

    cc = args.clip_config
    cfg = CLIP_CONFIGS[cc.clip_model]
    per = {k: 0 for k in cuda_build.LAUNCHES}
    if cc.apply_disturbances:
        per["disturb"] = 4 * args.num_steps
    if cc.ablation_mode == AblationMode.FROZEN_CLIP:
        calls = args.num_steps + 1 + args.update_epochs * args.num_minibatches
        per["attn_block_bf16"] = per["mlp_block_bf16"] = cfg.vision_layers * calls
    elif cc.ablation_mode == AblationMode.NONE and cc.clip_modality == "image":
        per["attn_block_bf16"] = per["mlp_block_bf16"] = cfg.vision_layers
    elif cc.ablation_mode == AblationMode.NONE:
        per["attn_block"] = per["mlp_block"] = cfg.text_layers
    return per


@contextlib.contextmanager
def iteration_clock(times: list):
    """Appends the host clock, after a device synchronize, at the end of
    every Trainer iteration of the block (a fused call of one iteration, or
    a split path's update half): the difference of two is one iteration's
    wall time, its host work between the calls included."""
    import torch

    from clip_ppo_tpu_torch.train.runner import Trainer

    saved = {name: getattr(Trainer, name) for name in ("run_iterations", "run_update_half")}

    def clocked(fn):
        def call(*a, **k):
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times.append(time.perf_counter())
            return out
        return call

    for name, fn in saved.items():
        setattr(Trainer, name, clocked(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(Trainer, name, fn)


def _paths(r: dict) -> tuple:
    """The paths a kernel row stands for: its ``path``, one name or a tuple."""
    p = r["path"]
    return (p,) if isinstance(p, str) else tuple(p or ())


def record_launches(results: list[dict], path, launches: dict, shapes: dict | None = None) -> None:
    """A driven path's launches onto the kernel rows that name it, kept by
    path: each row's launches of its kernel, or with ``shapes``
    (``cuda_build.LAUNCH_SHAPES`` after the run) of its kernel at its shape.
    A row's ``launches`` is their sum over its paths."""
    for r in results:
        if path is not None and path in _paths(r):
            n = (launches[r["name"]] if shapes is None
                 else shapes.get((r["name"], r["shape"].split()[0]), 0))
            r.setdefault("launches_by_path", {})[path] = n
            r["launches"] = sum(r["launches_by_path"].values())


def run_atari_cli(cli, argv: list[str]):
    """``cli.train`` for 2 iterations of 8 x 128 in a temporary directory,
    one iteration a dispatch and clocked. Returns (args, summary, launches,
    wall seconds, steady env-steps/s of the second iteration, files)."""
    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.utils import flags

    argv = [*argv, "--total-timesteps", "2048", "--iterations-per-dispatch", "1",
            "--no-capture-video", "--seed", "1"]
    args = flags.parse(cli.Args, argv)
    cwd = os.getcwd()
    times: list = []
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            if hasattr(args, "model_path"):
                args.model_path = os.path.join(tmp, "checkpoints")
            cuda_build.reset_launches()
            t0 = time.time()
            with iteration_clock(times):
                summary = cli.train(args, run_name="chip_smoke")
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = dict(cuda_build.LAUNCHES)
            files = [f for _, _, fs in os.walk(tmp) for f in fs]
        finally:
            os.chdir(cwd)
    steady = args.batch_size / (times[-1] - times[-2]) if len(times) >= 2 else None
    return args, summary, launches, wall, steady, files


def _check_scalars(tag: str, scalars: dict) -> None:
    import math

    for key, v in scalars.items():
        if not math.isfinite(float(v)) and key != "explained_variance":
            fail(f"{tag}: non-finite {key} = {v}")


def phase_atari(results: list[dict], card: dict) -> dict:
    """Phase 11: ``ppo_atari`` on each game and ``clip_ppo_atari`` in each
    mode of ``ATARI_RUNS``, launches against :func:`atari_launches`; then
    ``stack_frames`` and the multi-frame bf16 features against the CPU, and
    one steady image-modality iteration by part. Returns each run's steady
    env-steps/s."""
    import torch

    from clip_ppo_tpu_torch.cli import clip_ppo_atari, ppo_atari

    t_phase = time.time()
    sps = {}
    for env_id in ATARI_GAMES:
        args, summary, launches, wall, steady, files = run_atari_cli(
            ppo_atari, ["--env-id", env_id])
        tag = f"[atari ppo {env_id}]"
        print(f"{tag} python -m clip_ppo_tpu_torch.cli.ppo_atari --env-id {env_id}: "
              f"{args.num_iterations} iterations of {args.num_envs}x{args.num_steps} in "
              f"{wall:.2f} s wall; CLI SPS {summary['sps']:.1f}; steady (iteration 2) "
              f"{steady:.1f} env-steps/s; launches {sum(launches.values())}; "
              f"{summary['episodes']} episodes; "
              + ", ".join(f"{k} {float(summary['last_scalars'][k]):.6f}"
                          for k in ("policy_loss", "value_loss", "entropy"))
              + f" on {card['smi']}")
        if any(launches.values()):
            fail(f"ppo_atari on {env_id} launched a kernel of the port: {launches}")
        _check_scalars(tag, summary["last_scalars"])
        if not any("tfevents" in f for f in files):
            fail(f"{tag}: no TensorBoard event file written")
        sps[f"ppo_atari {env_id}"] = steady
    for mode, argv in ATARI_RUNS.items():
        args, summary, launches, wall, steady, files = run_atari_cli(clip_ppo_atari, argv)
        per = atari_launches(args)
        iters = args.num_iterations
        scalars = summary["last_scalars"]
        tag = f"[atari {mode}]"
        print(f"{tag} python -m clip_ppo_tpu_torch.cli.clip_ppo_atari {' '.join(argv)}: {iters} "
              f"iterations of {args.num_envs}x{args.num_steps} on {args.env_id} at "
              f"{args.clip_config.clip_model} in {wall:.2f} s wall; CLI SPS {summary['sps']:.1f}; "
              f"steady (iteration 2) {steady:.1f} env-steps/s; launches {launches} (expected "
              f"per iteration {({k: v for k, v in per.items() if v})}); "
              + ", ".join(f"{k} {float(scalars[k]):.6f}"
                          for k in ("policy_loss", "value_loss", "entropy", "first_clip_loss"))
              + f" on {card['smi']}")
        for name, n in per.items():
            if launches[name] != n * iters:
                fail(f"{name} launched {launches[name]} times in {mode}, expected {n * iters}")
        _check_scalars(tag, scalars)
        clip_on = float(scalars["first_clip_loss"]) > 0.0
        if clip_on != (mode != "FROZEN_CLIP"):
            fail(f"{tag}: the CLIP loss {'ran' if clip_on else 'did not run'} "
                 f"(first_clip_loss {float(scalars['first_clip_loss'])})")
        if not any("tfevents" in f for f in files) or not any(
                f.endswith("_final.ckpt") for f in files):
            fail(f"{tag}: no TensorBoard event file or final checkpoint among {files}")
        record_launches(results, ATARI_PATHS.get(mode), launches)
        sps[f"clip_ppo_atari {mode}"] = steady
    torch.cuda.empty_cache()
    phase_stack_frames(card)
    phase_multiframe_encode(card)
    phase_atari_profile(card)
    print("[atari] steady env-steps/s (iteration 2 of each run): " + "; ".join(
        f"{k} {v:.1f}" for k, v in sps.items()) + f" on {card['smi']}")
    print(f"[atari] phase took {time.time() - t_phase:.1f} s")
    return sps


def phase_stack_frames(card: dict) -> None:
    """``stack_frames`` on the card: a HARD [8, 84, 84, 4] stack, one K1
    launch a frame, against the plain version on the CPU fed the same noise
    (1e-5); then in the main path's mode, the four frames of identical images
    with the same contrast factor and cutout: their in-kernel noise (each
    frame its own seed) must differ."""
    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.ops import disturbances as td
    from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity, SEVERITY_CONFIGS

    dev = torch.device("cuda", 0)
    params = SEVERITY_CONFIGS[DisturbanceSeverity.HARD]
    cpu_gen = torch.Generator().manual_seed(4)
    x = torch.rand((8, 84, 84, 4), generator=cpu_gen)
    draws = td.draw(x, params, cpu_gen, "stack_frames")  # the noise itself, on the CPU
    on_card = tuple(td.DisturbanceDraws(*(None if t is None else t.to(dev) for t in d))
                    for d in draws)
    cuda_build.reset_launches()
    got = td.disturb(x.to(dev), params, on_card, "stack_frames").cpu()
    n = cuda_build.LAUNCHES["disturb"]
    err = (got - td.disturb(x, params, draws, "stack_frames")).abs().max().item()
    gen = torch.Generator(device=dev).manual_seed(5)
    same = x[..., :1].to(dev).expand(8, 84, 84, 4).contiguous()
    seeded = td.draw(same, params, gen, "stack_frames")
    seeded = tuple(d._replace(factor=seeded[0].factor, origin=seeded[0].origin) for d in seeded)
    frames = td.disturb(same, params, seeded, "stack_frames")
    seeds = [int(d.seed.item()) for d in seeded]
    apart = min((frames[..., i] - frames[..., j]).abs().max().item()
                for i in range(4) for j in range(i + 1, 4))
    print(f"[stack_frames] HARD [8,84,84,4] on the card ({n} K1 launches) vs the plain version "
          f"on the CPU, same noise: max_abs_err {err:.3e} (tolerance 1e-5); in-kernel noise, "
          f"seeds {seeds}: the closest two frames of identical images differ by up to {apart:.3f}")
    if n != 4 or not err <= 1e-5:
        fail(f"stack_frames on the card: {n} launches (4 expected), max_abs_err {err}")
    if len(set(seeds)) != 4 or not apart > 0.05:
        fail(f"stack_frames: the four frames' in-kernel noise does not differ ({seeds}, {apart})")


def phase_multiframe_encode(card: dict) -> None:
    """The image modality's multi-frame features of two stacks: the bf16
    ViT-B/32 vision tower through K2 and K3 in bf16 on the card against the
    plain bf16 route on the CPU with the same weights, per-frame
    L2-normalized, 2e-2 absolute (as phase 10)."""
    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.models import clip_utils
    from clip_ppo_tpu_torch.models.clip.model import cast_tower
    from clip_ppo_tpu_torch.utils.tree import tree_map

    dev = torch.device("cuda", 0)
    params, cfg = clip_utils.load_clip_model("ViT-B/32", dev)
    frozen = {"clip": cast_tower({"visual": params["visual"]}, torch.bfloat16)}
    del params
    gen = torch.Generator(device=dev).manual_seed(7)
    stacks = torch.randint(0, 256, (2, 84, 84, 4), generator=gen, device=dev, dtype=torch.uint8)
    embed = clip_utils.make_multiframe_embed_fn(cfg)
    cuda_build.reset_launches()
    got = embed(stacks, frozen).cpu()
    launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    ref = embed(stacks.cpu(), {"clip": tree_map(lambda t: t.cpu(), frozen["clip"])})
    err = (got - ref).abs().max().item()
    want = {"attn_block_bf16": cfg.vision_layers, "mlp_block_bf16": cfg.vision_layers}
    print(f"[multiframe encode] 2 stacks of 4 frames through the bf16 ViT-B/32 vision tower "
          f"(launches {launches}) vs the plain bf16 route on the CPU: shape {tuple(got.shape)}, "
          f"max_abs_err {err:.3e} on per-frame unit vectors (tolerance 2e-2)")
    if launches != want:
        fail(f"the multi-frame encode launched {launches}, expected {want}")
    if got.shape != (2, 4 * cfg.embed_dim) or not torch.isfinite(got).all() or not err <= 2e-2:
        fail(f"multi-frame features on the card disagree with the CPU: {err}")


def phase_atari_profile(card: dict) -> None:
    """One steady image-modality iteration (Breakout, 8 x 128, ViT-B/32 in
    bf16) by part, with the device's busy share, its kernel launches and
    its time by ported kernel."""
    import torch

    from clip_ppo_tpu_torch.envs.atari.vector import AtariVectorEnv
    from clip_ppo_tpu_torch.models import clip_utils
    from clip_ppo_tpu_torch.models.agent import init_agent_params
    from clip_ppo_tpu_torch.models.clip.model import cast_tower
    from clip_ppo_tpu_torch.train.ppo import PPOConfig
    from clip_ppo_tpu_torch.train.runner import Trainer

    t0 = time.time()
    dev = torch.device("cuda", 0)
    env = AtariVectorEnv("ALE/Breakout-v5", 8, dev)
    clip_params, clip_cfg = clip_utils.load_clip_model("ViT-B/32", dev)
    frozen = {"clip": cast_tower({"visual": clip_params["visual"]}, torch.bfloat16)}
    del clip_params
    trainer = Trainer(PPOConfig(clip_mode="projected"), env, 2,
                      embed_images_fn=clip_utils.make_multiframe_embed_fn(clip_cfg),
                      clip_lambda=1e-5, frozen_params=frozen)
    gen = torch.Generator()
    gen.manual_seed(1)
    params = init_agent_params(gen, env.num_actions, dev, in_channels=4,
                               with_temporal_projection=True)
    profile_iteration(trainer, trainer.init_state(params, 1), "[atari profile]",
                      "Breakout 8x128, image modality, 4,096 frames through ViT-B/32 in bf16",
                      card, "CLIP encode (4,096 frames)")
    print(f"[atari profile] phase took {time.time() - t0:.1f} s")


# -- phase 12: the experiment pipeline ---------------------------------------

DRILL_ITERATIONS = 3  # DoorKey-6x6 truncates at 360 steps: 3 x 128 end an episode in each env
DRILL_STARTUP = {"attn_block": 12, "mlp_block": 12}  # the text table, once a run


def phase_drill(card: dict) -> None:
    """12a. ``run_pretrained_robustness --synthesize-checkpoint`` on
    DoorKey-6x6 (text modality, λ 1e-5, HARD for the disturbed run) for 3
    iterations a run: the full ViT-B/32 archive synthesized and taken by the
    loader; each run's launches (the text table's K2 and K3 once a layer,
    K1 once a rollout step in the disturbed run only); the severity read back
    from each run's log; the RI and AUC finite. Each run dispatches one
    iteration at a time, so its last iteration is clocked for the steady
    env-steps/s."""
    import math

    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as cpm
    from clip_ppo_tpu_torch.cli import run_pretrained_robustness as drill
    from clip_ppo_tpu_torch.metrics import get_disturbance_severity
    from clip_ppo_tpu_torch.models.clip import loader
    from clip_ppo_tpu_torch.models.clip.config import CLIP_CONFIGS

    t0 = time.time()
    runs, loaded = {}, []
    real_train, real_load = cpm.train, loader.load_openai_checkpoint

    def train(targs, run_name=None):
        targs.iterations_per_dispatch = 1
        times: list = []
        cuda_build.reset_launches()
        t_run = time.time()
        with iteration_clock(times):
            summary = real_train(targs, run_name=run_name)
        torch.cuda.synchronize()
        runs[run_name] = (targs, summary, dict(cuda_build.LAUNCHES), time.time() - t_run,
                          targs.batch_size / (times[-1] - times[-2]))
        return summary

    def load(path, device=None):
        params, cfg = real_load(path, device)
        loaded.append((path, cfg))
        return params, cfg

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, mock.patch.dict(os.environ):
        os.chdir(tmp)
        os.environ.pop("CLIP_PPO_CHECKPOINT_DIR", None)
        cpm.train, loader.load_openai_checkpoint = train, load
        try:
            result = drill.main(drill.Args(
                total_timesteps=DRILL_ITERATIONS * 8 * 128, synthesize_checkpoint=True,
                checkpoint_dir=os.path.join(tmp, "ckpts"), run_prefix="chip_smoke"))
            severities = {k: get_disturbance_severity(result[k]).value
                          for k in ("clean_run", "disturbed_run")}
        finally:
            cpm.train, loader.load_openai_checkpoint = real_train, real_load
            os.chdir(cwd)
    if [p for p, _ in loaded] != [result["checkpoint"]] * 2 or any(
            c != CLIP_CONFIGS["ViT-B/32"] for _, c in loaded):
        fail(f"the drill's runs did not both load the synthesized ViT-B/32 archive: {loaded}")
    if severities != {"clean_run": "NONE", "disturbed_run": "HARD"}:
        fail(f"the drill's logs read back severities {severities}, expected NONE (CLEAN) and HARD")
    for name, (targs, summary, launches, wall, steady) in runs.items():
        disturbed = targs.clip_config.apply_disturbances
        want = {k: DRILL_STARTUP.get(k, 0) for k in launches}
        want["disturb"] = targs.num_steps * targs.num_iterations if disturbed else 0
        print(f"[drill] {name}: {targs.num_iterations} iterations of {targs.num_envs}x"
              f"{targs.num_steps} on {targs.env_id}, text modality at ViT-B/32 from the "
              f"synthesized archive, in {wall:.2f} s wall; text table {summary['table_seconds']:.3f}"
              f" s; steady (last iteration) {steady:.1f} env-steps/s; launches "
              f"{ {k: v for k, v in launches.items() if v} } on {card['smi']}")
        if launches != want:
            fail(f"the drill's run {name} launched {launches}, expected {want}")
        _check_scalars(f"[drill] {name}", summary["last_scalars"])
    values = {k: result[k] for k in ("final_ri", "mean_ri", "clean_auc", "disturbed_auc")}
    print("[drill] " + ", ".join(f"{k} {v:.6f}" for k, v in values.items())
          + f"; severities {severities}; phase took {time.time() - t0:.1f} s")
    if not all(math.isfinite(v) for v in values.values()):
        fail(f"the drill's RI or AUC is not finite: {values}")


def _own_normals(xc, d_seed):
    """The batched draws ``d_seed`` with the kernel's own normals for its
    seed: image i's stream, indexed by the NHWC element as the kernel
    indexes it."""
    import torch

    from clip_ppo_tpu_torch.ops import disturb_kernel as dk
    from clip_ppo_tpu_torch.ops.disturbances import DisturbanceDraws

    seed = int(d_seed.seed.item())
    own = torch.stack([dk.kernel_normals(xc[0].numel(), seed, i, xc.device).view(xc.shape[1:])
                       for i in range(xc.shape[0])])
    return DisturbanceDraws(own, d_seed.factor, d_seed.origin)


def phase_bench_disturbances(results: list[dict], card: dict) -> None:
    """12c. ``benchmark_disturbances`` at its defaults (HARD, 84x84x3, batch
    1 to 64, 50 chained calls): its per-image and batched ms and speed-up,
    K1's launches (a warm-up chain and a timed one of each batch size), then
    at each batch size K1 against its plain version on the kernel's own
    normals, timed beside it with its bound."""
    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.cli import benchmark_disturbances as bench
    from clip_ppo_tpu_torch.ops import disturb_kernel as dk
    from clip_ppo_tpu_torch.ops.disturbances import draw
    from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity, SEVERITY_CONFIGS

    t0 = time.time()
    args = bench.BenchArgs()
    cuda_build.reset_launches()
    rows = bench.benchmark_disturbances(args)
    launches = dict(cuda_build.LAUNCHES)
    want = {k: 0 for k in launches}
    want["disturb"] = 2 * args.iterations * len(args.batch_sizes)
    if launches != want or any(r["launches"] != 2 * args.iterations for r in rows):
        fail(f"benchmark_disturbances launched {launches} ({[r['launches'] for r in rows]} a "
             f"batch size), expected {want}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    params = SEVERITY_CONFIGS[DisturbanceSeverity[args.severity]]
    for r in rows:
        b = r["batch"]
        x = torch.rand((b, args.height, args.width, args.channels), generator=gen, device=dev)
        d = draw(x, params, gen)
        d_own = _own_normals(x, d)
        err, rel = _errors(dk.disturb_batched(x, params, d), dk.disturb_batched_plain(x, params, d_own))
        if not err <= 1e-5:
            fail(f"K1 at [{b},84,84,3] disagrees with its plain version: {err} > 1e-5")
        k1 = lambda: dk.disturb_batched(x, params, d)  # noqa: E731
        ms = time_ms(k1, reps=20, calls=50)
        dev_ms = device_ms(k1, calls=50, kernel="disturb_kernel")
        plain_ms = time_ms(lambda: dk.disturb_batched_plain(x, params, d_own), reps=20, calls=50)
        bound_ms, bound_by = _bound(2 * x.numel() * 4,
                                    x.numel() * (4 * params.blur_kernel_size + 7), card)
        print(f"[benchmark_disturbances] batch {b}: per-image {r['per_image_ms']:.3f} ms, batched "
              f"{r['batched_ms']:.3f} ms (draws and K1, 50 chained calls), speed-up "
              f"{r['speedup']:.2f}x, K1 launches {r['launches']}; K1 alone {ms:.4f} ms per call "
              f"over 50 back-to-back calls (device {_fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}), max_abs_err {err:.3e} max_rel_err "
              f"{rel:.3e} (tolerance 1e-5) on {card['smi']}")
        results.append({
            "name": "disturb", "route": "cuda", "source": "clip_ppo_tpu_torch/csrc/disturb.cu",
            "replaces": "clip_ppo_tpu/ops/pallas_disturb.py:76", "shape": f"[{b},84,84,3]",
            "path": "benchmark_disturbances", "launches": r["launches"], "max_abs_err": err,
            "max_rel_err": rel, "tolerance": 1e-5, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "device_ms": dev_ms,
            "ctas": dk.CLUSTER_CTAS, "per_image_ms": r["per_image_ms"],
            "batched_ms": r["batched_ms"], "speedup": r["speedup"],
        })
    print(f"[benchmark_disturbances] phase took {time.time() - t0:.1f} s")


GRID_RUN = "s0_atari_ALEBreakout-v5_CLIPPPO_SEVERE_image_l1e-05"


def phase_grid(card: dict) -> None:
    """12d. ``run_experiments --dry-run`` lists the 78 runs on the port's
    modules; then the command ``build_command`` gives for CLIP-PPO SEVERE in
    the image modality on Breakout (λ 1e-5), cut to 3 iterations of 8 x 128
    by ``dataclasses.replace``, runs as a subprocess, and the port's metrics
    read its log; the same flags then run in this process, two iterations
    one a dispatch, for the configuration's steady env-steps/s and launches."""
    import contextlib as _cl
    import io
    import math

    import clip_ppo_tpu_torch
    from clip_ppo_tpu_torch.cli import clip_ppo_atari, run_experiments
    from clip_ppo_tpu_torch.io.tb_reader import EventAccumulator
    from clip_ppo_tpu_torch.metrics import (
        compute_auc_metric,
        compute_success_rate,
        get_disturbance_severity,
        load_tensorboard_run,
    )

    t0 = time.time()
    out = io.StringIO()
    with _cl.redirect_stdout(out):
        run_experiments.main(["--dry-run"])
    cmds = [ln for ln in out.getvalue().splitlines() if " -m clip_ppo_tpu_torch.cli." in ln]
    if len(cmds) != 78 or " -m clip_ppo_tpu.cli." in out.getvalue():
        fail(f"run_experiments --dry-run listed {len(cmds)} commands on the port's modules, "
             "expected 78 and none on the JAX package's")
    exp = next(e for e in run_experiments._setup_main_experiments() if e.run_name == GRID_RUN)
    exp = dataclasses.replace(exp, timesteps=3 * 8 * 128)
    cmd = run_experiments.build_command(exp)
    root = os.path.dirname(os.path.dirname(os.path.abspath(clip_ppo_tpu_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])]))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        t_run = time.time()
        proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        wall = time.time() - t_run
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            print(proc.stderr[-4000:], file=sys.stderr)
            fail(f"the grid run {exp.run_name} exited with {proc.returncode}")
        os.chdir(tmp)
        try:
            run = os.path.join("runs", exp.run_name)
            severity = get_disturbance_severity(run).value
            ts, returns, lengths = load_tensorboard_run(run)
            auc, success = compute_auc_metric(ts, returns), compute_success_rate(run)
            sps = [e.value for e in EventAccumulator(run).Reload().Scalars("charts/SPS")]
            ckpts = os.listdir("checkpoints")
        finally:
            os.chdir(cwd)
    print(f"[grid] {len(cmds)} commands on the port's modules; ran {' '.join(cmd[1:])} as a "
          f"subprocess in {wall:.2f} s wall: severity {severity}, {len(returns)} episodes, "
          f"mean return {sum(returns) / max(len(returns), 1):.3f}, AUC {auc:.6f}, success rate "
          f"{success:.2f}%, charts/SPS by iteration {sps} (the first iteration's warm-up "
          f"included) on {card['smi']}")
    if severity != "SEVERE" or not returns or not math.isfinite(auc) or len(sps) != 3:
        fail(f"the grid run's log reads severity {severity}, {len(returns)} returns, AUC {auc}, "
             f"{len(sps)} SPS points")
    if not any(c.endswith("_final.ckpt") for c in ckpts):
        fail(f"the grid run wrote no final checkpoint: {ckpts}")
    # One dispatch takes the run's 3 iterations, so its log cannot split
    # them: the same flags in this process, one iteration a dispatch, clock
    # the configuration's steady iteration and count its launches.
    args, summary, launches, _, steady, _ = run_atari_cli(clip_ppo_atari, cmd[3:])
    per = atari_launches(args)
    print(f"[grid] the same configuration in this process for {args.num_iterations} iterations, "
          f"one a dispatch: steady (iteration 2) {steady:.1f} env-steps/s; launches "
          f"{ {k: v for k, v in launches.items() if v} } (expected per iteration "
          f"{ {k: v for k, v in per.items() if v} }) on {card['smi']}")
    for name, n in per.items():
        if launches[name] != n * args.num_iterations:
            fail(f"{name} launched {launches[name]} times in the grid's configuration, expected "
                 f"{n * args.num_iterations}")
    _check_scalars("[grid]", summary["last_scalars"])
    print(f"[grid] phase took {time.time() - t0:.1f} s")


def phase_panels(card: dict) -> None:
    """12e. ``disturbances_test``'s panels (HARD, the 256 x 256 test card,
    every stage on its own and combined) computed on the card, against the
    same panels on the CPU with the same draws, 1e-5 absolute."""
    import torch

    from clip_ppo_tpu_torch.cli import disturbances_test as tool
    from clip_ppo_tpu_torch.utils.tree import tree_map

    t0 = time.time()
    args = tool.DisturbanceTestArgs()
    params = tool.resolve_test_params(args)
    dev = torch.device("cuda", 0)
    x = torch.as_tensor(tool.test_card(args.size), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    draws = tool.draw_panel_inputs(x[None], params, gen)
    got = tool.compute_panels(x, params, args, draws)
    ref = tool.compute_panels(x.cpu(), params, args, tree_map(lambda t: t.cpu(), draws))
    errs = {name: (g.cpu() - r).abs().max().item() for (name, g), (_, r) in zip(got, ref)}
    print(f"[panels] {args.severity} on the {args.size}x{args.size} test card, card vs CPU: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tolerance 1e-5); phase took {time.time() - t0:.1f} s")
    if [n for n, _ in got] != ["original", "noise", "contrast", "blur", "cutout", "combined"]:
        fail(f"disturbances_test computed the panels {[n for n, _ in got]}")
    if not all(v <= 1e-5 for v in errs.values()):
        fail(f"disturbances_test's panels on the card disagree with the CPU: {errs}")


def phase_pipeline(results: list[dict], card: dict) -> None:
    """Phase 12: the experiment pipeline (a-e)."""
    t0 = time.time()
    phase_drill(card)
    phase_ablation(results, card, "FROZEN_CLIP", structured=True)
    phase_bench_disturbances(results, card)
    phase_grid(card)
    phase_panels(card)
    print(f"[pipeline] phase 12 took {time.time() - t0:.1f} s")


# Phase 13: the classic MiniGrid families. The largest id of each kind (and
# Unlock's open_door success) for the transition check, the vanilla runs and
# their trace.
FAMILY_RUNS = (
    "MiniGrid-FourRooms-v0", "MiniGrid-LavaGapS7-v0", "MiniGrid-DistShift1-v0",
    "MiniGrid-MultiRoom-N6-v0", "MiniGrid-SimpleCrossingS11N5-v0",
    "MiniGrid-LavaCrossingS9N3-v0", "MiniGrid-Dynamic-Obstacles-16x16-v0",
    "MiniGrid-BlockedUnlockPickup-v0", "MiniGrid-ObstructedMaze-1Dlhb-v1",
    "MiniGrid-KeyCorridorS6R3-v0", "MiniGrid-LockedRoom-v0", "MiniGrid-RedBlueDoors-8x8-v0",
)
# The vanilla runs of phase 13b, cut to keep the script well inside its clock:
# DistShift's reset, a see-through layout with the ball draws and the two
# largest resets (LavaCrossingS9N3's and ObstructedMaze-1Dlhb's generators run
# on the card in 13a and in LavaCrossingS9N1's and ObstructedMaze-1Q's runs).
FAMILY_VANILLA = (
    "MiniGrid-DistShift1-v0", "MiniGrid-MultiRoom-N6-v0", "MiniGrid-Dynamic-Obstacles-16x16-v0",
    "MiniGrid-KeyCorridorS6R3-v0",
)
FAMILY_STEPS = 24
HARD_TEXT = ["--clip-config.clip-lambda", "1e-5", "--clip-config.clip-modality", "text",
             "--clip-config.apply-disturbances", "--clip-config.disturbance-severity", "HARD"]
HARD_IMAGE = ["--clip-config.clip-lambda", "1e-5", "--clip-config.clip-modality", "image",
              "--clip-config.apply-disturbances", "--clip-config.disturbance-severity", "HARD"]
# (label, argv, startup launches, launches per iteration, kernels-line path
# whose rows take the run's launches, split path expected)
FAMILY_CLIP_RUNS = (
    ("text table FourRooms", ["--env-id", "MiniGrid-FourRooms-v0", *HARD_TEXT],
     {"attn_block": 24, "mlp_block": 24}, {"disturb": 128}, "fourrooms", False),  # 1,444 rows
    ("text split MultiRoom-N6", ["--env-id", "MiniGrid-MultiRoom-N6-v0", *HARD_TEXT],
     {}, {"attn_block": 12, "mlp_block": 12, "disturb": 128}, "split", True),
    ("image LavaCrossingS9N1", ["--env-id", "MiniGrid-LavaCrossingS9N1-v0", *HARD_IMAGE],
     {}, {"attn_block": 12, "mlp_stream": 12, "disturb": 128}, "lavacrossing", False),
)


def _crafted(core, grids, targets=None, kind: str = "", success: str = "", instrs=None,
             target_color: int = -1):
    """Mid-episode states of a few reset grids (numpy), the agent turned to
    face an object: (grid, pos, dir, carrying, first action, target, instr,
    instr_state; the grid's ``instrs`` [N, 4, 12] or zeros, no latch) for
    the goal and lava (forward), a ball (pickup; forward, a collision, under
    Dynamic-Obstacles; balls of ``target_color`` first), a box (pickup, and
    toggle), a locked door with its key in hand (toggle) and RedBlueDoors'
    blue door with the red one open and closed (toggle); with the grids' mission ``targets`` [N, 8], also
    ``done`` facing the target cell (GoToDoor, GoToObject), a pickup of the
    target's (type, color) (Fetch), Memory's step onto its success cell and
    PutNear's drop of the move object beside its near object; with a
    BabyAI ``success`` mode, the states :func:`_babyai_crafted` gives, and
    :func:`_seq_crafted`'s for the composite levels."""
    import numpy as np

    def face(g, target):
        for d, (dx, dy) in enumerate(core.DIR_TO_VEC):
            x, y = target[0] - dx, target[1] - dy
            if 0 <= x < g.shape[0] and 0 <= y < g.shape[1] and g[x, y, 0] in (core.EMPTY,
                                                                                core.DOOR):
                if g[x, y, 0] == core.DOOR and g[x, y, 2] != core.OPEN:
                    continue
                return (x, y), d
        return None

    out, none = [], np.zeros(3, np.int8)
    for i, g in enumerate(grids[:3]):
        t = np.zeros(8, np.int32) if targets is None else targets[i]
        ins = np.zeros((4, 12), np.int32) if instrs is None else instrs[i]
        start = len(out)
        if success == "babyai_seq":
            out += _seq_crafted(core, g, t, ins, face, none)
        elif success.startswith("babyai_"):
            out += _babyai_crafted(core, success, g, t, face, none)
        elif t.any():
            out += _mission_crafted(core, kind, g, t, face, none)
        wants = [(core.GOAL, None, core.A_FORWARD), (core.LAVA, None, core.A_FORWARD),
                 (core.BALL, None, core.A_PICKUP), (core.BALL, None, core.A_FORWARD),
                 (core.BOX, None, core.A_PICKUP), (core.BOX, None, core.A_TOGGLE)]
        locked = np.argwhere((g[..., 0] == core.DOOR) & (g[..., 2] == core.LOCKED))
        for obj, _, action in wants:
            cells = sorted(np.argwhere(g[..., 0] == obj),
                           key=lambda c: g[tuple(c)][1] != target_color)
            for c in cells[:2]:
                f = face(g, tuple(c))
                if f is not None:
                    out.append((g.copy(), f[0], f[1], none, action, t))
        for c in locked[:1]:
            f = face(g, tuple(c))
            if f is not None:
                out.append((g.copy(), f[0], f[1], np.array([core.KEY, g[tuple(c)][1], 0], np.int8),
                            core.A_TOGGLE, t))
        doors = {int(g[tuple(c)][1]): tuple(c) for c in np.argwhere(g[..., 0] == core.DOOR)}
        if core.RED in doors and core.BLUE in doors:
            for red_state in (core.OPEN, core.CLOSED):
                gr = g.copy()
                gr[doors[core.RED]][2] = red_state
                f = face(gr, doors[core.BLUE])
                if f is not None:
                    out.append((gr, f[0], f[1], none, core.A_TOGGLE, t))
        out[start:] = [c if len(c) == 8 else (*c, ins, np.zeros((4, 2), np.int32))
                       for c in out[start:]]
    return out


def _seq_crafted(core, g, t, instr, face, none):
    """States of one grid ``g`` of a composite level whose first action
    completes an instruction: the reset's slot-0 row, acted on (``done``
    facing a goto match, a toggle of a door to open, its key in hand where it
    is locked, a pickup, a drop of the move object beside a fixed one), put
    in the slot each composition verifies next with every other slot it uses
    already done — single (slot 0), and (slot 1 done), before (slot 0 done,
    slot 2 acting), after (slot 2 done, slot 0 acting) — and where slot 0 is
    strict, a toggle of each door it does not name."""
    import numpy as np

    row, h = instr[0], g.shape[1]
    movable = (core.KEY, core.BALL, core.BOX)

    def cells(tt, cc, types, positional):
        if positional:
            return [((v - 1) // h, (v - 1) % h) for v in row[6:12] if v]
        m = np.isin(g[..., 0], types) & ((g[..., 0] == tt) if tt >= 0 else True)
        return [tuple(c) for c in np.argwhere(m & ((g[..., 1] == cc) if cc >= 0 else True))]

    act = None
    if row[0] == 4:  # putnext: the move object in hand, dropped beside a fixed one
        for mv in cells(row[1], row[2], movable, False):
            held = g.copy()
            held[mv] = [core.EMPTY, 0, 0]
            for fx in cells(row[3], row[4], movable, False):
                for dx, dy in core.DIR_TO_VEC:
                    c = (fx[0] + dx, fx[1] + dy)
                    f = face(held, c) if held[c][0] == core.EMPTY else None
                    if f is not None and held[f[0]][0] == core.EMPTY and act is None:
                        act = (held, *f, np.array([*g[mv][:2], 0], np.int8), core.A_DROP)
    elif row[0]:
        types = {1: (*movable, core.DOOR), 2: (core.DOOR,), 3: movable}[int(row[0])]
        for c in cells(row[1], row[2], types, bool(row[5] & 1)):
            f = face(g, c)
            if f is None or act is not None or (row[0] == 2 and g[c][2] == core.OPEN):
                continue
            carry = (np.array([core.KEY, g[c][1], 0], np.int8)
                     if row[0] == 2 and g[c][2] == core.LOCKED else none)
            act = (g.copy(), *f, carry,
                   {1: core.A_DONE, 2: core.A_TOGGLE, 3: core.A_PICKUP}[int(row[0])])
    out = []
    if act is not None:
        for comp, acting, done in ((0, 0, ()), (1, 0, (1,)), (2, 2, (0,)), (3, 0, (2,))):
            ins, latch = np.zeros((4, 12), np.int32), np.zeros((4, 2), np.int32)
            for slot in (acting, *done):
                ins[slot] = row
            latch[list(done), 0] = 1
            tt = t.copy()
            tt[:2] = comp, 0
            out.append((*act, tt, ins, latch))
    if row[5] & 2:  # strict: a door of another color
        for c in map(tuple, np.argwhere((g[..., 0] == core.DOOR) & (g[..., 1] != row[2]))):
            f = face(g, c)
            if f is not None:
                out.append((g.copy(), *f, none, core.A_TOGGLE, t, instr,
                            np.zeros((4, 2), np.int32)))
    return out


def _mission_crafted(core, kind, g, t, face, none):
    """The mission modes' crafted states of one grid ``g`` of the family
    ``kind`` and its target ``t`` (see :func:`_crafted`)."""
    import numpy as np

    out = []
    objs = [tuple(c) for c in np.argwhere(np.isin(g[..., 0], [core.KEY, core.BALL, core.BOX]))]
    if kind in ("gotodoor", "gotoobject"):  # done beside the target
        f = face(g, (int(t[2]), int(t[3])))
        if f is not None:
            out.append((g.copy(), f[0], f[1], none, core.A_DONE, t))
    if kind == "fetch":  # the mission's (type, color) picked up
        for c in objs:
            if (g[c][0], g[c][1]) == (t[0], t[1]):
                f = face(g, c)
                if f is not None:
                    out.append((g.copy(), f[0], f[1], none, core.A_PICKUP, t))
    if kind == "memory":  # onto the success cell
        mid = g.shape[1] // 2
        out.append((g.copy(), (int(t[0]), mid), 3 if t[1] < mid else 1, none, core.A_FORWARD, t))
    if kind == "putnear":  # the move object dropped beside the near object
        held = g.copy()
        for c in objs:
            if (g[c][0], g[c][1]) == (t[0], t[1]):
                held[c] = [core.EMPTY, 0, 0]
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                c = (int(t[4]) + dx, int(t[5]) + dy)
                if held[c][0] == core.EMPTY:
                    f = face(held, c)
                    if f is not None and held[f[0]][0] == core.EMPTY:
                        out.append((held, f[0], f[1], np.array([t[0], t[1], 0], np.int8),
                                    core.A_DROP, t))
                        return out
    return out


def _babyai_crafted(core, success, g, t, face, none):
    """States of one BabyAI grid ``g`` that meet the mission ``t`` of the
    ``success`` mode on their first action: ``done`` facing a GoTo target,
    the move object dropped beside PutNext's fixed one, a matching pickup
    (and a wrong one, which fails a strict level), a toggle of the mission's
    door (its key in hand where it is locked), ActionObjDoor's verb on its
    object."""
    import numpy as np

    out = []
    things = [tuple(c) for c in np.argwhere(np.isin(g[..., 0], [core.KEY, core.BALL, core.BOX,
                                                                 core.DOOR]))]

    def is_(c, ttype, tcol):
        return (ttype < 0 or g[c][0] == ttype) and (tcol < 0 or g[c][1] == tcol)

    def add(grid, c, action, carrying=none):
        f = face(grid, c)
        if f is not None:
            out.append((grid, f[0], f[1], np.asarray(carrying, np.int8), action, t))

    if success == "babyai_putnext":
        held = g.copy()
        held[np.all(held[..., :2] == [t[0], t[1]], axis=-1)] = [core.EMPTY, 0, 0]
        fixed = next(c for c in things if (g[c][0], g[c][1]) == (t[2], t[3]))
        for dx, dy in core.DIR_TO_VEC:
            c = (fixed[0] + dx, fixed[1] + dy)
            if held[c][0] == core.EMPTY and face(held, c) is not None:
                add(held, c, core.A_DROP, [t[0], t[1], 0])
                break
        return out
    if success == "babyai_pickup":  # up to three matches, then one wrong pickup
        for match, most in ((True, 3), (False, 1)):
            n0 = len(out)
            for c in things:
                if g[c][0] != core.DOOR and is_(c, t[0], t[1]) == match and len(out) - n0 < most:
                    add(g.copy(), c, core.A_PICKUP)
        return out
    for c in things:
        door = g[c][0] == core.DOOR
        if success == "babyai_goto" and is_(c, t[0], t[1]):
            add(g.copy(), c, core.A_DONE)
        elif success == "babyai_open_color" and door and is_(c, core.DOOR, t[1]):
            add(g.copy(), c, core.A_TOGGLE, [core.KEY, g[c][1], 0])
        elif success == "babyai_open" and door and c[0] * g.shape[1] + c[1] + 1 in t[:4]:
            add(g.copy(), c, core.A_TOGGLE)
        elif success == "babyai_action" and is_(c, t[1], t[2]):
            add(g.copy(), c, (core.A_DONE, core.A_PICKUP, core.A_TOGGLE)[int(t[0])])
    return out[:4]


def phase_family_transitions(card: dict, env_ids=(*FAMILY_RUNS, "MiniGrid-Unlock-v0"),
                             tag: str = "families") -> None:
    """13a. The reset of each family's largest id, drawn on the card (so
    every generator runs there) and copied to the CPU, with crafted
    mid-episode states, stepped 24 times on the card and on the CPU with the
    same actions (and the same Dynamic-Obstacles draws): views, states
    (``target`` included) and flags equal, rewards equal as float32; every
    family reaches its success, but Playground, which has none, and a strict
    level (``EnvParams.strict``) also its failure, a termination without
    reward. Returns the compositions (``target[0]``) whose composite
    instruction succeeded on the card."""
    import numpy as np
    import torch

    from clip_ppo_tpu_torch.envs.minigrid import core

    dev = torch.device("cuda", 0)
    t0 = time.time()
    comps_won = set()
    for env_id in env_ids:
        p = core.parse_env_id(env_id)
        gen = torch.Generator()
        gen.manual_seed(13)
        dgen = torch.Generator(device=dev)
        dgen.manual_seed(13)
        st = core.EnvState(*(t.cpu() for t in dataclasses.astuple(core.reset(p, 8, dgen, dev))))
        crafted = _crafted(core, st.grid.numpy(), st.target.numpy(), p.kind, p.success,
                           st.instr.numpy(), p.target_color)
        n = 8 + len(crafted)
        cat = lambda a, b: torch.cat([a, torch.as_tensor(np.stack(b))])  # noqa: E731
        cpu = core.EnvState(
            cat(st.grid, [c[0] for c in crafted]), cat(st.agent_pos, [np.array(c[1]) for c in crafted]),
            cat(st.agent_dir, [np.array(c[2]) for c in crafted]), cat(st.carrying, [c[3] for c in crafted]),
            torch.cat([st.step_count, torch.full((len(crafted),), p.max_steps // 2, dtype=torch.int32)]),
            cat(st.target, [np.asarray(c[5], np.int32) for c in crafted]),
            cat(st.instr, [c[6] for c in crafted]), cat(st.instr_state, [c[7] for c in crafted]))
        gpu = core.EnvState(*(t.to(dev) for t in dataclasses.astuple(cpu)))
        rng = np.random.RandomState(13)
        actions = rng.randint(0, p.num_actions, size=(FAMILY_STEPS, n))
        actions[0, 8:] = [c[4] for c in crafted]
        won = failed = 0
        for t in range(FAMILY_STEPS):
            a = torch.as_tensor(actions[t])
            if not torch.equal(core.observe(p, gpu).cpu(), core.observe(p, cpu)):
                fail(f"{env_id}: the views on the card differ from the CPU's before step {t}")
            draws = core.obstacle_gumbels(p, n, gen, "cpu") if p.kind == "dynobs" else None
            comp = cpu.target[:, 0]
            cpu, r_c, te_c, tr_c = core.step(p, cpu, a, gumbels=draws)
            gpu, r_g, te_g, tr_g = core.step(p, gpu, a.to(dev),
                                             gumbels=None if draws is None else draws.to(dev))
            for name, x, y in (("reward", r_g, r_c), ("terminated", te_g, te_c),
                               ("truncated", tr_g, tr_c), *(
                                   (f.name, getattr(gpu, f.name), getattr(cpu, f.name))
                                   for f in dataclasses.fields(core.EnvState))):
                if not torch.equal(x.cpu(), y):
                    fail(f"{env_id}: {name} on the card differs from the CPU's at step {t}")
            won += int((r_c > 0).sum())
            failed += int((te_c & (r_c == 0)).sum())
            if p.success == "babyai_seq":
                comps_won |= set(comp[r_c > 0].tolist())
        print(f"[{tag}] {env_id} ({p.kind}, success {p.success}): {n} states ({len(crafted)} "
              f"crafted) x {FAMILY_STEPS} steps on the card equal to the CPU (views, states, "
              f"flags; rewards as float32); {won} rewarded transitions, {failed} terminated "
              f"without reward")
        if won == 0 and p.kind != "playground":
            fail(f"{env_id}: no transition reached the family's success")
        if p.strict and failed == 0:
            fail(f"{env_id}: no transition reached the strict level's failure")
        if won and p.kind == "playground":
            fail(f"{env_id}: Playground has no reward, yet {won} transitions were rewarded")
    print(f"[{tag}] transition checks took {time.time() - t0:.1f} s")
    return comps_won


def _count_kernels(fn) -> int:
    """The device kernels ``fn`` launches, from a torch.profiler trace (0
    where the trace holds no device time)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in _kernel_events(prof))


def phase_family_vanilla(card: dict, env_ids=FAMILY_VANILLA, tag: str = "families vanilla",
                         mission: bool = False) -> dict:
    """13b. ``ppo_minigrid`` for 2 iterations of 8 x 128 on each id of
    ``env_ids`` (view mode, no kernel of the port launched, finite losses),
    its second iteration clocked for the steady env-steps/s; one rollout of
    128 steps timed alone; and the kernels a rollout step launches, from two
    short traces (a whole trace of 128 steps takes the profiler minutes to
    read): a 4-step rollout R4 whose bulk reset is made before the trace,
    and the bulk reset W of a 128-step rollout, a step then launching
    R4 / 4 + W / 128. (A rejection loop's launches grow with the number of
    envs it resets, so the reset is kept out of R4.) With ``mission``, every
    run is ``--mission-conditioning``, its Trainer FiLM-conditioned."""
    import torch

    from clip_ppo_tpu_torch.cli import ppo_minigrid as cli
    from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
    from clip_ppo_tpu_torch.models import agent as agent_mod
    from clip_ppo_tpu_torch.train.ppo import PPOConfig
    from clip_ppo_tpu_torch.train.runner import Draws, Trainer

    dev = torch.device("cuda", 0)
    out = {}
    for env_id in env_ids:
        args, summary, launches, wall, steady, _ = run_atari_cli(
            cli, ["--env-id", env_id, *(["--mission-conditioning"] if mission else [])])
        if any(launches.values()):
            fail(f"vanilla {env_id} launched kernels of the port: {launches}")
        if not summary["view_mode"] or summary["mission_conditioning"] is not mission:
            fail(f"vanilla {env_id}: view mode {summary['view_mode']}, mission conditioning "
                 f"{summary['mission_conditioning']}")
        _check_scalars(f"[{tag}] {env_id}", summary["last_scalars"])
        env = TorchVectorEnv(env_id, 8, dev)
        pgen = torch.Generator()
        pgen.manual_seed(1)
        params = agent_mod.init_agent_params(pgen, env.num_actions, dev,
                                             mission_dim=env.mission_dim if mission else 0)
        trainer = Trainer(PPOConfig(), env, 2, mission_conditioning=mission)
        state = trainer.init_state(params, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._rollout(state, Draws())
        torch.cuda.synchronize()
        rollout_s = time.perf_counter() - t0
        short = Trainer(PPOConfig(num_steps=4), env, 2, mission_conditioning=mission)
        state = short.init_state(params, 1)
        short._rollout(state, Draws())  # warm-up
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        bank = env.prepare_resets(state.vec_state, 4, gen).reset_bank
        made = lambda vs, k, g: dataclasses.replace(vs, reset_bank=bank, reset_step=0)  # noqa: E731
        with mock.patch.object(env, "prepare_resets", made):
            r4 = _count_kernels(lambda: short._rollout(state, Draws()))
        w = _count_kernels(lambda: env.prepare_resets(state.vec_state, 128, gen))
        per_step = r4 / 4 + w / 128 if r4 else None
        out[env_id] = (steady, per_step)
        print(f"[{tag}] {env_id}: 2 iterations of 8x128 in {wall:.2f} s wall, steady "
              f"{steady:.1f} env-steps/s (second iteration); one rollout alone {rollout_s * 1e3:.1f}"
              f" ms = {1024 / rollout_s:.1f} env-steps/s; "
              + (f"a rollout step launches {per_step:.1f} kernels ({r4 / 4:.1f} for the "
                 f"policy and the env step, {w} for the rollout's bulk reset of 1,024 envs)"
                 if r4 else "kernel launches not measured (the trace holds no device time)")
              + f"; {env.num_actions} actions on {card['smi']}")
    return out


def phase_family_clip(results: list[dict], card: dict, runs=FAMILY_CLIP_RUNS,
                      tag: str = "families clip") -> None:
    """13c-d. ``clip_ppo_minigrid`` for 2 iterations, HARD: the text modality
    on FourRooms (the 1,444-row description table, two batches, K2 and K3 12
    times each at [1024,77,512] and at [420,77,512] at startup and none an
    iteration) and on MultiRoom-N6 (the split path: K2 and K3 12 times an
    iteration), the host's describe + tokenize and the encode timed per
    iteration; the image modality on LavaCrossingS9N1. K1 128 times an
    iteration in each. Each run's launches go to the kernel rows of its path
    by input shape, and every row of the path must have run at its shape."""
    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as cpm
    from clip_ppo_tpu_torch.envs.minigrid import core
    from clip_ppo_tpu_torch.models import clip_utils

    for label, argv, startup, per_iter, path, split in runs:
        spans = {"describe": [], "tokenize": [], "encode": []}

        def timed(fn, key, sync=False):
            def call(*a, **k):
                if sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if sync:
                    torch.cuda.synchronize()
                spans[key].append(time.perf_counter() - t0)
                return out
            return call

        with mock.patch.object(core, "describe_rollout", timed(core.describe_rollout, "describe")), \
                mock.patch.object(clip_utils, "tokenize", timed(clip_utils.tokenize, "tokenize")), \
                mock.patch.object(clip_utils, "encode_texts",
                                  timed(clip_utils.encode_texts, "encode", sync=True)):
            args, summary, launches, wall, steady, _ = run_atari_cli(cpm, argv)
        shapes = dict(cuda_build.LAUNCH_SHAPES)
        want = {k: startup.get(k, 0) + per_iter.get(k, 0) * args.num_iterations for k in launches}
        print(f"[{tag}] {label}: {args.num_iterations} iterations of {args.num_envs}x"
              f"{args.num_steps} in {wall:.2f} s wall, split path {summary['split_path']}, text "
              f"table {summary['table_seconds']:.3f} s, steady {steady:.1f} env-steps/s; launches "
              f"{ {k: v for k, v in launches.items() if v} }, by input shape "
              f"{ {f'{k} {sh}': v for (k, sh), v in sorted(shapes.items())} } on {card['smi']}")
        if launches != want:
            fail(f"{label} launched {launches}, expected {want}")
        if summary["split_path"] is not split:
            fail(f"{label}: split path {summary['split_path']}")
        _check_scalars(f"[{tag}] {label}", summary["last_scalars"])
        if not float(summary["last_scalars"]["first_clip_loss"]) > 0.0:
            fail(f"{label}: the CLIP loss did not run")
        if split:
            ms = {k: [v * 1e3 for v in vs] for k, vs in spans.items()}
            enc = [e - t for e, t in zip(ms["encode"], ms["tokenize"][-len(ms["encode"]):])]
            print(f"[{tag}] {label}: split path per iteration (host clock): describe "
                  + ", ".join(f"{v:.2f}" for v in ms["describe"]) + " ms; tokenize "
                  + ", ".join(f"{v:.2f}" for v in ms["tokenize"]) + " ms; text encode of 1,024 "
                  "descriptions (K2 + K3, synchronized) " + ", ".join(f"{v:.2f}" for v in enc)
                  + f" ms on {card['smi']}")
        record_launches(results, path, launches, shapes)
        for r in results:  # each shape of the path's rows ran there
            if path in _paths(r) and not r["launches_by_path"][path]:
                fail(f"{label}: {r['name']} never ran at {r['shape']}, launches by shape {shapes}")


def phase_families(results: list[dict], card: dict) -> None:
    """Phase 13: the classic MiniGrid families (a-d)."""
    t0 = time.time()
    phase_family_transitions(card)
    phase_family_vanilla(card)
    phase_family_clip(results, card)
    print(f"[families] phase 13 took {time.time() - t0:.1f} s")


# Phase 14: the mission families, Memory, Playground and the full
# ObstructedMaze (the largest id of each), and --recurrent.
MISSION_RUNS = (
    "MiniGrid-ObstructedMaze-Full-v0", "MiniGrid-Playground-v0", "MiniGrid-MemoryS17Random-v0",
    "MiniGrid-GoToDoor-8x8-v0", "MiniGrid-Fetch-8x8-N3-v0", "MiniGrid-GoToObject-8x8-N2-v0",
    "MiniGrid-PutNear-8x8-N3-v0",
)
MISSION_VANILLA = ("MiniGrid-ObstructedMaze-Full-v0", "MiniGrid-Playground-v0",
                   "MiniGrid-PutNear-8x8-N3-v0")  # as FAMILY_VANILLA; MemoryS7 runs in 14c
MISSION_CLIP_RUNS = (  # as FAMILY_CLIP_RUNS
    ("text split GoToDoor-8x8", ["--env-id", "MiniGrid-GoToDoor-8x8-v0", *HARD_TEXT],
     {}, {"attn_block": 12, "mlp_block": 12, "disturb": 128}, "gotodoor", True),
    ("image ObstructedMaze-1Q", ["--env-id", "MiniGrid-ObstructedMaze-1Q-v1", *HARD_IMAGE],
     {}, {"attn_block": 12, "mlp_stream": 12, "disturb": 128}, "obstructedmaze", False),
)
RECURRENT_ID = "MiniGrid-MemoryS7-v0"


def phase_recurrent(card: dict, env_id: str = RECURRENT_ID, mission: bool = False,
                    tag: str = "recurrent") -> None:
    """14c. ``ppo_minigrid --recurrent`` on MemoryS7 (``env_id``; with
    ``mission``, ``--mission-conditioning`` too) for 2 iterations of
    8 x 128 (view mode, no kernel of the port, finite losses), then one
    steady iteration's rollout, GAE and update timed apart (synchronized),
    and the kernels the rollout and the update launch: both are linear in
    the rollout's length (the rollout's bulk reset and the update's
    per-minibatch work are fixed, each step adds the same), so traces of
    4- and 8-step iterations give the 128-step counts."""
    import torch

    from clip_ppo_tpu_torch.cli import ppo_minigrid as cli
    from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
    from clip_ppo_tpu_torch.models import recurrent as rec
    from clip_ppo_tpu_torch.train.ppo import PPOConfig
    from clip_ppo_tpu_torch.train.runner import Draws, Trainer

    dev = torch.device("cuda", 0)
    args, summary, launches, wall, steady, _ = run_atari_cli(
        cli, ["--env-id", env_id, "--recurrent", *(["--mission-conditioning"] if mission else [])])
    if any(launches.values()):
        fail(f"--recurrent launched kernels of the port: {launches}")
    if not (summary["recurrent"] and summary["view_mode"]
            and summary["mission_conditioning"] is mission):
        fail(f"--recurrent: recurrent {summary['recurrent']}, view mode {summary['view_mode']}, "
             f"mission conditioning {summary['mission_conditioning']}")
    _check_scalars(f"[{tag}]", summary["last_scalars"])
    env = TorchVectorEnv(env_id, 8, dev)
    pgen = torch.Generator()
    pgen.manual_seed(1)
    params = rec.init_agent_params_recurrent(pgen, env.num_actions, dev,
                                             mission_dim=env.mission_dim if mission else 0)

    def parts(num_steps: int, count: bool):
        trainer = Trainer(PPOConfig(num_steps=num_steps), env, 4, recurrent=True,
                          mission_conditioning=mission)
        state, *_ = trainer.iteration(trainer.init_state(params, 1), 1)  # warm-up
        torch.cuda.synchronize()
        init, out, ms = state.lstm_state, {}, {}

        def rollout():
            out["state"], out["batch"] = trainer._rollout(state, Draws())

        def update():
            trainer._update(out["state"], out["data"], 2, None, Draws(), init)

        t0 = time.perf_counter()
        n_roll = _count_kernels(rollout) if count else rollout()
        torch.cuda.synchronize()
        ms["rollout"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out["data"] = trainer._data2d(out["state"], out["batch"])
        torch.cuda.synchronize()
        ms["gae"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        n_upd = _count_kernels(update) if count else update()
        torch.cuda.synchronize()
        ms["update"] = (time.perf_counter() - t0) * 1e3
        return ms, n_roll, n_upd

    ms, _, _ = parts(128, False)
    total = sum(ms.values())
    _, r4, u4 = parts(4, True)
    _, r8, u8 = parts(8, True)
    counts = ""
    if r4 and u4:
        roll = r4 + (r8 - r4) / 4 * 124
        upd = u4 + (u8 - u4) / 4 * 124
        counts = (f"; kernels of a 128-step iteration {roll + upd:.0f}: rollout {roll:.0f} "
                  f"({(r8 - r4) / 4:.1f} a step), update {upd:.0f} ({(u8 - u4) / 4 / 16:.1f} a "
                  f"replayed step of a minibatch, forward and backward; traced 4 and 8 steps: "
                  f"rollout {r4}, {r8}, update {u4}, {u8})")
    print(f"[{tag}] {env_id}, LSTM hidden {args.lstm_hidden}: 2 iterations of 8x128 in "
          f"{wall:.2f} s wall, steady {steady:.1f} env-steps/s (second iteration); one steady "
          f"iteration by part (host clock, synchronized): rollout {ms['rollout']:.1f} ms, GAE "
          f"{ms['gae']:.1f} ms, update {ms['update']:.1f} ms (16 minibatches of 2 envs x 128 "
          f"steps replayed), total {total:.1f} ms = {1024 / total * 1e3:.1f} env-steps/s"
          f"{counts or '; kernel launches not measured (the trace holds no device time)'} on "
          f"{card['smi']}")


def phase_missions(results: list[dict], card: dict) -> None:
    """Phase 14: the mission families, Memory, Playground, the full
    ObstructedMaze and --recurrent (a-e)."""
    t0 = time.time()
    phase_family_transitions(card, MISSION_RUNS, "missions")
    phase_family_vanilla(card, MISSION_VANILLA, "missions vanilla")
    phase_recurrent(card)
    phase_family_clip(results, card, MISSION_CLIP_RUNS, "missions clip")
    print(f"[missions] phase 14 took {time.time() - t0:.1f} s")


# Phase 15: the BabyAI levels that ``EnvState.target`` decides — one id of
# each generator for the transitions, the largest for the vanilla runs.
BABYAI_RUNS = (
    "BabyAI-GoToLocalS8N7-v0", "BabyAI-PutNextLocal-v0", "BabyAI-PickupDistDebug-v0",
    "BabyAI-OpenRedDoor-v0", "BabyAI-OpenDoorLoc-v0", "BabyAI-ActionObjDoor-v0", "BabyAI-GoTo-v0",
    "BabyAI-UnblockPickup-v0", "BabyAI-KeyInBox-v0", "BabyAI-UnlockToUnlock-v0",
    "BabyAI-GoToObjDoor-v0", "BabyAI-PutNextS7N4Carrying-v0", "BabyAI-UnlockPickupDist-v0",
)
BABYAI_VANILLA = ("BabyAI-GoTo-v0", "BabyAI-ActionObjDoor-v0", "BabyAI-UnlockToUnlock-v0",
                  "BabyAI-PutNextS7N4Carrying-v0", "BabyAI-GoToLocalS8N7-v0")
BABYAI_CLIP_RUNS = (  # as FAMILY_CLIP_RUNS
    ("text table BabyAI-GoTo", ["--env-id", "BabyAI-GoTo-v0", *HARD_TEXT],
     {"attn_block": 24, "mlp_block": 24}, {"disturb": 128}, "babyai_text", False),  # 1,936 rows
    ("image BabyAI-OpenDoorLoc", ["--env-id", "BabyAI-OpenDoorLoc-v0", *HARD_IMAGE],
     {}, {"attn_block": 12, "mlp_stream": 12, "disturb": 128}, "babyai_image", False),
)


def phase_babyai(results: list[dict], card: dict) -> None:
    """Phase 15: the BabyAI levels that ``target`` decides (a-d)."""
    t0 = time.time()
    phase_family_transitions(card, BABYAI_RUNS, "babyai")
    phase_family_vanilla(card, BABYAI_VANILLA, "babyai vanilla")
    phase_family_clip(results, card, BABYAI_CLIP_RUNS, "babyai clip")
    print(f"[babyai] phase 15 took {time.time() - t0:.1f} s")


# Phase 16: BabyAI's composite instructions (one id of each generator and
# size) and --mission-conditioning.
SEQ_RUNS = (
    "BabyAI-BossLevel-v0", "BabyAI-MiniBossLevel-v0", "BabyAI-SynthSeq-v0",
    "BabyAI-GoToSeqS5R2-v0", "BabyAI-MoveTwoAcrossS8N9-v0", "BabyAI-OpenRedBlueDoorsDebug-v0",
    "BabyAI-OpenDoorsOrderN4Debug-v0", "BabyAI-PickupLoc-v0",
)
SEQ_VANILLA = ("BabyAI-BossLevel-v0", "BabyAI-MoveTwoAcrossS8N9-v0", "BabyAI-OpenDoorsOrderN4-v0")
SEQ_MISSION = ("BabyAI-BossLevel-v0",)
SEQ_RECURRENT_ID = "BabyAI-OpenTwoDoors-v0"  # the level that needs memory
SEQ_CLIP_RUNS = (  # as FAMILY_CLIP_RUNS
    ("text table BossLevel, mission", ["--env-id", "BabyAI-BossLevel-v0",
                                       "--mission-conditioning", *HARD_TEXT],
     {"attn_block": 24, "mlp_block": 24}, {"disturb": 128}, "boss_mission", False),  # 1,936 rows
    ("text table MiniBossLevel", ["--env-id", "BabyAI-MiniBossLevel-v0", *HARD_TEXT],
     {"attn_block": 12, "mlp_block": 12}, {"disturb": 128}, "miniboss_text", False),  # 324 rows
)


def phase_seq(results: list[dict], card: dict) -> None:
    """Phase 16: BabyAI's composite instructions and --mission-conditioning
    (a-d); every composition must succeed on the card."""
    t0 = time.time()
    comps = phase_family_transitions(card, SEQ_RUNS, "seq")
    names = {0: "single", 1: "and", 2: "before", 3: "after"}
    print(f"[seq] compositions that succeeded on the card: "
          f"{', '.join(names[c] for c in sorted(comps))}")
    if comps != set(names):
        fail(f"compositions that never succeeded on the card: {set(names) - comps}")
    phase_family_vanilla(card, SEQ_VANILLA, "seq vanilla")
    phase_family_vanilla(card, SEQ_MISSION, "seq vanilla mission", mission=True)
    phase_recurrent(card, SEQ_RECURRENT_ID, mission=True, tag="seq recurrent mission")
    phase_family_clip(results, card, SEQ_CLIP_RUNS, "seq clip")
    print(f"[seq] phase 16 took {time.time() - t0:.1f} s")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    try:
        import clip_ppo_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from here ({e}); run from the repository root")
    t_start = time.time()
    for k in SWITCH_VARS:  # the earlier paths run with every switch unset
        os.environ.pop(k, None)
    card = phase_card()
    results = (phase_kernels(card) + phase_attention(card) + phase_stream_kernels(card)
               + phase_bf16_kernels(card))
    for modality in ("text", "image"):
        phase_slice(results, card, modality)
        if modality == "image":
            phase_image_encode(card)
        phase_profile(card, modality)
    phase_slice(results, card, "image", "ViT-B/16")
    phase_image_encode(card, "ViT-B/16")
    phase_vanilla(card)
    default = phase_benchmark(results, card, "benchmark", BENCH_L14, BENCH_L14_PER_CALL)
    phase_benchmark(results, card, "pallas", BENCH_PALLAS, BENCH_PALLAS_PER_CALL)
    image = {"default route": next(r for r in default if r[0] == 256)[1]}
    for label, env, per_call in SWITCHES:
        with switches(env):
            image[label] = phase_benchmark(results, card, label, BENCH_SWITCH, per_call)[0][1]
    print("[switches] ViT-L/14 image call at batch 256: " + "; ".join(
        f"{k} {v * 1e3:.2f} ms/batch, {256 / v:.1f} frames/s" for k, v in image.items())
        + f" on {card['smi']}")
    phase_large_tower(card)
    t0 = time.time()
    default = phase_benchmark(results, card, "l14_bf16", BENCH_L14_BF16, BENCH_L14_BF16_PER_CALL)
    image = {"default route": next(r for r in default if r[0] == 256)[1]}
    for label, env, per_call in SWITCHES_BF16:
        with switches(env):
            image[label] = phase_benchmark(results, card, label, BENCH_SWITCH_BF16,
                                           per_call)[0][1]
    print("[switches bf16] ViT-L/14 bf16 image call at batch 256: " + "; ".join(
        f"{k} {v * 1e3:.2f} ms/batch, {256 / v:.1f} frames/s" for k, v in image.items())
        + f" on {card['smi']}")
    for label, argv, per_call in BENCH_IMPL_BF16 + BENCH_B16:
        phase_benchmark(results, card, label, argv, per_call)
    print(f"[benchmark bf16 and ViT-B/16] phase took {time.time() - t0:.1f} s")
    phase_large_tower_bf16(card)
    for mode in ABLATIONS:
        phase_ablation(results, card, mode)
    phase_frozen_encode(card)
    phase_frozen_profile(card)
    t0 = time.time()
    phase_benchmark(results, card, "bench_bf16", BENCH_BF16, BENCH_BF16_PER_CALL)
    print(f"[benchmark bench_bf16] phase took {time.time() - t0:.1f} s")
    phase_atari(results, card)
    phase_pipeline(results, card)
    phase_families(results, card)
    phase_missions(results, card)
    phase_babyai(results, card)
    phase_seq(results, card)
    order = ("name", "route", "source", "replaces", "shape", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    for r in results:  # every kernel of a driven path was launched there, on each of its paths
        by = r.get("launches_by_path") or {p: r.get("launches") for p in _paths(r)}
        for p in _paths(r):
            if not by.get(p):
                fail(f"{r['name']} {r['shape']} was not launched on its path {p}")
    print(f"[done] every phase passed in {time.time() - t_start:.1f} s")
    extra = ("launches_by_path", "bound_fp32_ms", "device_ms", "library_device_ms", "ctas", "empty_ms",
             "empty_device_ms", "ms_8_ctas", "device_ms_8_ctas", "f32_kernel_ms",
             "per_image_ms", "batched_ms", "speedup")
    print(json.dumps({"kernels": [{k: r[k] for k in (*order, *extra) if k in r}
                                  for r in results if r["path"]]}))
    print(card["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
