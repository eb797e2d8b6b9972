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
   and spill nothing;
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it: K1 at every severity, at the shapes
   of ``K1_CASES`` (a ragged band, one channel, bands thinner than the
   halo, clusters of 8) and in the main path's mode, noise drawn in the
   kernel, against the plain version fed the kernel's own normals; timed
   with clusters of 16 and of 8 CTAs beside an empty kernel on the same
   grid, and its device time with fewer CTAs, without drawing the noise
   and at other tap counts. ``BLOCK_CASES``: K2, K3 and K5 with random
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
   [B*T, D] chunk of the hidden plus the row statistics;
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
7. encoder benchmark — the port's ``cli/benchmark_clip.py`` at ViT-L/14 in
   float32 (K4 + K5 in the vision tower, K2 + K5 in the text tower), then at
   ViT-B/32 with ``--attention-impl pallas`` (K8 in the vision tower), with
   the launches of every call counted; then at ViT-L/14 under each of the
   JAX package's weight-streaming switches (``CLIP_PPO_ATTN_STREAM=1``: K6;
   ``CLIP_PPO_MLP_CHUNKED=1``: K7; both; ``CLIP_PPO_MLP_STREAM=0``: the
   plain MLP), one batch size and 2 iterations each, launches checked, and
   the image call's time under each beside the default route's;
8. large tower — ViT-L/14's embeddings of two frames on the card, on the
   default route and under both switches, against the plain versions on the
   CPU, and where one batch-256 image call of each spends its device time,
   by kernel and by ported kernel.

The paths of phases 3 to 7 before the switch runs run with every switch
unset, and their launch checks hold K6 and K7 at 0.

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

# Published dense peaks of the H100 SXM at its full 700 W (NVIDIA data
# sheet): fp32 outside the tensor cores, TF32 on the tensor cores, and
# device-memory bandwidth.
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
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
    if spills:
        fail(f"ptxas spills registers in the tensor-core kernels: {spills}")
    return {"smi": smi, "name": name, "flops": flops, "tf32_flops": TF32_FLOPS, "bw": bw}


# The libraries whose kernels run their products on the tensor cores in
# 3xTF32: their SASS must hold tensor-core instructions, ptxas must spill
# nothing in them, and their bounds count three TF32 passes a product.
TENSOR_CORE_LIBS = ("fused_qkv", "attn_block", "mlp_block", "mlp_stream", "attn_stream",
                    "mlp_chunked")


def _kernel_name(line: str) -> str:
    """A readable kernel name from a mangled one in ptxas's or cuobjdump's
    output: ..._17mlp_stream_kernelILi768EEvPKf... -> mlp_stream_kernel<768>,
    ...11gemm_kernelILb1ELi1EEEvNS_6ParamsE -> gemm_kernel<true,1>."""
    m = re.search(r"([a-z_]+_kernel)(I(?:L[a-z]+\d+E)+E)?", line)
    if not m:
        return ""
    args = [("true" if v == "1" else "false") if t == "b" else v
            for t, v in re.findall(r"L([a-z]+)(\d+)E", m[2] or "")]
    return m[1] + (f"<{','.join(args)}>" if args else "")


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


# K1 at shapes its bands must get right, noise as input: (shape, severity,
# CTAs an image)
K1_CASES = [
    ((3, 85, 83, 3), "HARD", 16),  # ragged: bands of 6, the 15th of 1, the 16th empty
    ((4, 84, 84, 1), "HARD", 16),  # one channel: the channel mean
    ((2, 9, 13, 3), "SEVERE", 16),  # bands of 1 row, thinner than the 3-row halo
    ((8, 84, 84, 3), "SEVERE", 8),  # the portable cluster size: bands of 11
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
    for shape, sev, ctas in K1_CASES:
        params = SEVERITY_CONFIGS[DisturbanceSeverity[sev]]
        xc = torch.rand(shape, generator=gen, device=dev)
        k1_check(f"{sev} [{','.join(map(str, shape))}]", xc, params, noise_in(xc, params), ctas)
    z = dk.kernel_normals(1 << 22, 12345, 0, dev)
    z1 = dk.kernel_normals(1 << 16, 12345, 1, dev)
    mean, std = z.mean().item(), z.std().item()
    print(f"[kernels] K1 in-kernel Philox normals over {z.numel()} draws: mean {mean:.5f} std {std:.5f}")
    if abs(mean) > 0.003 or abs(std - 1.0) > 0.003 or torch.equal(z[: z1.numel()], z1):
        fail("K1's in-kernel noise is not standard normal (|mean|, |std-1| <= 0.003) or "
             "its streams do not differ per image")
    params = SEVERITY_CONFIGS[DisturbanceSeverity.HARD]
    d_seed = draw(x, params, gen)  # the main path's mode: noise drawn in the kernel
    # The plain version fed the kernel's own normals: image i's stream under
    # the call's seed, indexed by the NHWC element as the kernel indexes it.
    seed = int(d_seed.seed.item())
    own = torch.stack([dk.kernel_normals(x[0].numel(), seed, i, dev).view(x.shape[1:])
                       for i in range(x.shape[0])])
    d_own = DisturbanceDraws(own, d_seed.factor, d_seed.origin)
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
        "path": "text", "max_abs_err": worst,
        "max_rel_err": worst_rel, "tolerance": 1e-5, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "device_ms": k1_device_ms, "ctas": dk.CLUSTER_CTAS,
        "empty_ms": empty_ms, "empty_device_ms": empty_device_ms,
        "ms_8_ctas": timed[8][0], "device_ms_8_ctas": timed[8][1],
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


BLOCK_CASES = [  # (kernel, B, T, D, causal, path, timed); rows of no path stay out of the kernels line
    ("attn_block", 1024, 77, 512, True, "text", True),  # text table
    ("mlp_block", 1024, 77, 512, False, "text", True),
    ("attn_block", 1024, 50, 768, False, "image", True),  # ViT-B/32 vision
    ("mlp_stream", 1024, 50, 768, False, "image", True),
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
    # modality: launches expected on the CLI's main path, per iteration
    "text": {"attn_block": 0, "mlp_block": 0, "mlp_stream": 0, "fused_qkv": 0,
             "packed_attention": 0, "attn_stream": 0, "mlp_chunked": 0, "disturb": 128},
    "image": {"attn_block": 12, "mlp_block": 0, "mlp_stream": 12, "fused_qkv": 0,
              "packed_attention": 0, "attn_stream": 0, "mlp_chunked": 0, "disturb": 128},
}
STARTUP = {"text": {"attn_block": 12, "mlp_block": 12}, "image": {}}  # the text table


def phase_slice(results: list[dict], card: dict, modality: str) -> None:
    import math

    import torch

    from clip_ppo_tpu_torch import cuda_build
    from clip_ppo_tpu_torch.cli import clip_ppo_minigrid as cli
    from clip_ppo_tpu_torch.utils import flags

    argv = [
        "--clip-config.clip-lambda", "1e-5", "--clip-config.clip-modality", modality,
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
    tag = f"[{modality} slice]"
    print(f"{tag} {iters} iterations of {args.num_envs}x{args.num_steps} on {args.env_id} "
          f"in {wall:.2f} s wall; launches {launches}")
    print(f"{tag} text table build {summary['table_seconds']:.3f} s; steady SPS "
          f"{summary['sps']:.1f}; first_clip_loss {float(summary['last_scalars']['first_clip_loss']):.6f} "
          f"on {card['smi']}")
    for name, per_iter in SLICES[modality].items():
        n = per_iter * iters + STARTUP[modality].get(name, 0)
        if launches[name] != n:
            fail(f"{name} launched {launches[name]} times on the {modality} path, expected {n}")
    for key, v in summary["last_scalars"].items():
        if not math.isfinite(float(v)) and key != "explained_variance":
            fail(f"non-finite {key} = {v}")
    if not float(summary["last_scalars"]["first_clip_loss"]) > 0.0:
        fail("the CLIP loss did not run (first_clip_loss is not > 0)")
    if not events:
        fail("no TensorBoard event file written")
    if not any(c.endswith("_final.ckpt") for c in ckpts):
        fail(f"no final checkpoint among {ckpts}")
    for r in results:
        if r["path"] == modality:
            r["launches"] = launches[r["name"]]


def phase_image_encode(card: dict) -> None:
    """The vision tower's embeddings of a few frames through the kernels on
    the card, against the plain versions on the CPU with the same weights."""
    import torch

    from clip_ppo_tpu_torch.models import clip_utils
    from clip_ppo_tpu_torch.utils.tree import tree_map

    dev = torch.device("cuda", 0)
    params, cfg = clip_utils.load_clip_model("ViT-B/32", dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    frames = torch.randint(0, 256, (8, 84, 84, 3), generator=gen, device=dev, dtype=torch.uint8)
    got = clip_utils.encode_images(params, cfg, frames).cpu()
    ref = clip_utils.encode_images(tree_map(lambda t: t.cpu(), params), cfg, frames.cpu())
    err = (got - ref).abs().max().item()
    print(f"[image encode] 8 frames through the ViT-B/32 tower (K2 + K5 on the card) vs the "
          f"plain versions on the CPU: shape {tuple(got.shape)}, max_abs_err {err:.3e} on "
          f"unit vectors (tolerance 1e-4)")
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
    from clip_ppo_tpu_torch.train.runner import Draws, Trainer

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
    t0 = time.perf_counter()
    emb = trainer.embed(batch, data)
    torch.cuda.synchronize()
    parts["CLIP encode" if modality == "image" else "table gather"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, _ = trainer._update(state, data, 2, emb, Draws())
    torch.cuda.synchronize()
    parts["update"] = time.perf_counter() - t0
    total = sum(parts.values())
    tag = f"[{modality} profile]"
    print(f"{tag} one iteration (8x128, Empty-16x16, HARD, {modality} modality), host wall: "
          + ", ".join(f"{k} {v * 1e3:.1f} ms ({100 * v / total:.1f}%)" for k, v in parts.items())
          + f"; total {total * 1e3:.1f} ms = {1024 / total:.0f} env-steps/s on {card['smi']}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        trainer.iteration(state, 2)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = _kernel_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy <= 0:
        print(f"{tag} device busy share: not measured (the trace holds no device time)")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    # The tracer itself slows the host many times over, so the busy share is
    # taken against the untraced iteration's wall time above.
    print(f"{tag} device busy {busy * 1e3:.1f} ms per iteration = {100 * busy / total:.1f}% of "
          f"the untraced {total * 1e3:.1f} ms (idle {100 * (1 - busy / total):.1f}%; traced wall "
          f"{wall * 1e3:.0f} ms); top kernels: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms x{e.count}" for e in top))
    print(f"{tag} device time by ported kernel (the device side of the profiler range "
          "around each entry point's call, first kernel's start to last kernel's end): "
          + _fmt_ported(by_ported_kernel(prof)))


# The encoder benchmark's two runs, and the launches each call must make.
BENCH_L14 = ["--model", "ViT-L/14", "--dtype", "float32", "--batch-sizes", "64", "256",
             "--text-batch", "1024", "--iterations", "3"]
BENCH_L14_PER_CALL = {"image": {"fused_qkv": 24, "mlp_stream": 24},
                      "text": {"attn_block": 12, "mlp_stream": 12}}
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
    for r in results:
        if r["path"] == path:
            r["launches"] = launches[r["name"]]
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
    results = phase_kernels(card) + phase_attention(card) + phase_stream_kernels(card)
    for modality in ("text", "image"):
        phase_slice(results, card, modality)
        if modality == "image":
            phase_image_encode(card)
        phase_profile(card, modality)
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
    order = ("name", "route", "source", "replaces", "shape", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"[done] every phase passed in {time.time() - t_start:.1f} s")
    extra = ("bound_fp32_ms", "device_ms", "library_device_ms", "ctas", "empty_ms",
             "empty_device_ms", "ms_8_ctas", "device_ms_8_ctas")
    print(json.dumps({"kernels": [{k: r[k] for k in (*order, *extra) if k in r}
                                  for r in results if r["path"]]}))
    print(card["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
