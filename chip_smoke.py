#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``clip_ppo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its findings on its own lines; any failure exits
non-zero at once:

1. card — the GPU's name and power limit (nvidia-smi), and the build of
   every hand-written kernel from ``clip_ppo_tpu_torch/csrc/``;
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it (K2, K3 and K5 with random LayerNorm
   affines and biases; K2 at the text, the vision and ViT-L/14's text
   tower's shapes; K5 also at ViT-L/14's width and at a ragged row count;
   K4 at ViT-L/14's vision tower, at ViT-B/32's towers and at a ragged
   batch; K8 fed strided views of one qkv buffer), with its median time per
   call (CUDA events; K1 over back-to-back calls, beside its profiled device
   time), the plain version's time, the least time the card could take and,
   for K4 and K8, the time of ``scaled_dot_product_attention`` on the same
   q/k/v; then K6 and K7 at ViT-L/14's shapes and at ragged ones, K6 timed
   beside the route it replaces and K7 beside K5, and both refusing a width
   their kernels do not take;
3. text slice — the CLIP-PPO MiniGrid CLI (text modality, HARD
   disturbances) for two iterations, with every launch count read from the
   run;
4. text profile — one steady iteration of the same configuration timed by
   part, and the device's busy share from a torch.profiler trace;
5. image slice — the same CLI with the image modality (the ViT-B/32 vision
   tower encodes each iteration's 1,024 frames) for two iterations, with
   its launch counts, and the tower's embeddings of a few frames on the
   card against the plain versions on the CPU;
6. image profile — one steady image-modality iteration by part, and the
   device's busy share;
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
   CPU, and where one batch-256 image call of each spends its device time.

The paths of phases 3 to 7 before the switch runs run with every switch
unset, and their launch checks hold K6 and K7 at 0.

The last lines are the kernels' JSON summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result. Comparisons run with TF32 off
for both matmuls and cuDNN, so every plain version computes in full fp32.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# Published dense peaks of the H100 SXM at its full 700 W (NVIDIA data
# sheet): fp32 outside the tensor cores, and device-memory bandwidth.
FP32_FLOPS = 67e12
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


def profiled_ms(fn, kernel: str, calls: int) -> float:
    """Device milliseconds per launch of the kernel whose name holds
    ``kernel``, from a torch.profiler trace of ``calls`` calls of ``fn``
    (0.0 when the trace holds no such kernel)."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key
              and e.device_type == torch.autograd.DeviceType.CUDA]
    n = sum(e.count for e in events)
    return sum(e.self_device_time_total for e in events) / 1e3 / n if n else 0.0


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
          f"{bw / 1e12:.2f} TB/s")
    from clip_ppo_tpu_torch import cuda_build

    t0 = time.time()
    cuda_build.build_all()
    print(f"[card] built {len(cuda_build.SOURCES)} kernel libraries in {time.time() - t0:.1f} s")
    for lib in cuda_build.SOURCES:
        kernel = ""
        for line in cuda_build.build_log(lib).splitlines():
            if "Function properties for" in line:
                # a mangled name such as ..._17mlp_stream_kernelILi768EEvPKf...
                m = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", line)
                kernel = f"{m[1]}<{m[2]}>" if m and m[2] else m[1] if m else ""
            elif "registers" in line or "spill" in line:
                print(f"[card] ptxas {lib} {kernel}: {line.strip()}")
    return {"smi": smi, "name": name, "flops": flops, "bw": bw}


def _bound(nbytes: float, nflops: float, card: dict) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / card["bw"] * 1e3, nflops / card["flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _errors(got, ref) -> tuple[float, float]:
    """Max absolute error, and the same relative to max |ref|."""
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


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

    # -- K1 at the rollout's [8, 84, 84, 3], every severity, noise as input --
    x = torch.rand((8, 84, 84, 3), generator=gen, device=dev)
    worst, worst_rel = 0.0, 0.0
    for sev in ("MILD", "MODERATE", "HARD", "SEVERE"):
        params = SEVERITY_CONFIGS[DisturbanceSeverity[sev]]
        d = draw(x, params, gen)
        d = DisturbanceDraws(torch.randn(x.shape, generator=gen, device=dev), d.factor, d.origin)
        err, rel = _errors(dk.disturb_batched(x, params, d), dk.disturb_batched_plain(x, params, d))
        print(f"[kernels] K1 {sev}: ksize {params.blur_kernel_size} max_abs_err {err:.3e} "
              f"max_rel_err {rel:.3e} (tolerance 1e-5 absolute on [0, 1] values)")
        if not err <= 1e-5:
            fail(f"K1 {sev} disagrees with its plain version: {err} > 1e-5")
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
    d_in = DisturbanceDraws(torch.randn(x.shape, generator=gen, device=dev), d_seed.factor, d_seed.origin)
    k1 = lambda: dk.disturb_batched(x, params, d_seed)  # noqa: E731
    ms = time_ms(k1, reps=20, calls=50)
    plain_ms = time_ms(lambda: dk.disturb_batched_plain(x, params, d_in), reps=20, calls=50)
    device_ms = profiled_ms(k1, "disturb_kernel", calls=50)
    elems = x.numel()
    bound_ms, bound_by = _bound(2 * elems * 4, elems * (4 * params.blur_kernel_size + 7), card)
    print(f"[kernels] K1 HARD [8,84,84,3]: {ms:.4f} ms per call over 50 back-to-back calls "
          f"(torch.profiler device time {device_ms:.4f} ms per launch; grid of {x.shape[0]} "
          f"blocks on {torch.cuda.get_device_properties(dev).multi_processor_count} SMs), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    results.append({
        "name": "disturb", "route": "cuda", "source": "clip_ppo_tpu_torch/csrc/disturb.cu",
        "replaces": "clip_ppo_tpu/ops/pallas_disturb.py:76", "shape": "[8,84,84,3]",
        "path": "text", "max_abs_err": worst,
        "max_rel_err": worst_rel, "tolerance": 1e-5, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    })

    # -- K2 and K3 at the text table's [1024, 77, 512]; K2 and K5 at the vision
    # tower's [1024, 50, 768]; K2 at ViT-L/14's text tower, [1024, 77, 768]
    # causal; K5 at ViT-L/14's [256, 257, 1024] and at a ragged row count
    # (checked, not timed) ------------------------------------------------
    cases = [  # (case, timed); rows of no main path stay out of the kernels line
        (attn_case("attn_block", 1024, 77, 512, True, "text"), True),
        (mlp_case("mlp_block", 1024, 77, 512, "text"), True),
        (attn_case("attn_block", 1024, 50, 768, False, "image"), True),
        (mlp_case("mlp_stream", 1024, 50, 768, "image"), True),
        (attn_case("attn_block", 1024, 77, 768, True, "benchmark"), True),
        (mlp_case("mlp_stream", 256, 257, 1024, "benchmark"), True),
        (mlp_case("mlp_stream", 7, 50, 768, None), False),
    ]
    results += run_block_cases(cases, card, gen, dev)
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
    (tolerance 1e-4 x max(1, max |ref|)); the timed ones also get their
    median ms, the plain version's, the bound and, where a case names one,
    the time of another route to the same function on the same inputs."""
    import torch

    results = []
    params = {}
    with torch.no_grad():
        for (name, path, (b, t, dm, causal), fn, plain, nflops, wbytes, src, line,
             beside), timed in cases:
            if dm not in params:
                params[dm] = random_block(gen, dm, dev)
            p = params[dm]
            xb = torch.randn((b, t, dm), generator=gen, device=dev)
            got, ref = fn(xb, p), plain(xb, p)
            torch.cuda.synchronize()
            err, rel = _errors(got, ref)
            scale = ref.abs().max().item()
            tol = 1e-4 * max(1.0, scale)
            del got, ref
            shape = f"[{b},{t},{dm}]" + (" causal" if causal else "")
            print(f"[kernels] {name} {shape}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                  f"(max |ref| {scale:.3f}; tolerance 1e-4 x max(1, max |ref|) = {tol:.1e})")
            if not err <= tol:
                fail(f"{name} {shape} disagrees with its plain version: {err} > {tol}")
            if not timed:
                continue
            ms = time_ms(lambda: fn(xb, p), reps=10)
            plain_ms = time_ms(lambda: plain(xb, p), reps=10)
            bound_ms, bound_by = _bound(2 * xb.numel() * 4 + wbytes, nflops, card)
            row = {
                "name": name, "route": "cuda", "source": src, "replaces": line, "shape": shape,
                "path": path, "max_abs_err": err, "max_rel_err": rel, "tolerance": tol, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
            }
            other = ""
            if beside is not None:
                label, other_fn = beside
                row["beside"], row["beside_ms"] = label, time_ms(lambda: other_fn(xb, p), reps=10)
                other = f", {label} {row['beside_ms']:.3f} ms"
            print(f"[kernels] {name} {shape}: {ms:.3f} ms, plain {plain_ms:.3f} ms{other}, bound "
                  f"{bound_ms:.3f} ms ({bound_by}, {nflops / 1e9:.1f} GFLOP), "
                  f"{nflops / ms / 1e9:.2f} TFLOP/s")
            results.append(row)
            del xb
    del params
    torch.cuda.empty_cache()
    return results


def phase_stream_kernels(card: dict) -> list[dict]:
    """K6 and K7 against their plain versions on the card at the shapes of
    ViT-L/14's switch runs and at ragged ones, K6 timed beside the route it
    replaces (LN1, the cuBLAS qkv projection, K4, the cuBLAS out-projection
    and the residual) and K7 beside K5 on the same inputs."""
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

    k4_route = ("LN1 + cuBLAS qkv + K4 + cuBLAS out-proj + residual", fused_route)
    k5 = ("K5 (mlp_stream)", lambda x, p: bk.mlp_stream(x, p["ln_2"], p["mlp"]))
    cases = [
        (attn_case("attn_stream", 256, 257, 1024, False, "both", k4_route), True),
        (attn_case("attn_stream", 3, 257, 1024, False, None), False),
        (attn_case("attn_stream", 4, 77, 1024, True, None), False),
        (mlp_case("mlp_chunked", 256, 257, 1024, "both", k5), True),
        (mlp_case("mlp_chunked", 1024, 77, 768, "both", k5), True),
        (mlp_case("mlp_chunked", 3, 257, 1024, None), False),
    ]
    results = run_block_cases(cases, card, gen, dev)
    # A width the kernels do not take is refused by name, not run.
    x, blk = torch.zeros((2, 3, 192), device=dev), random_block(gen, 192, dev)
    for name, call in (("attn_stream", lambda: bk.attn_stream(x, blk["ln_1"], blk["attn"], 3)),
                       ("mlp_chunked", lambda: bk.mlp_chunked(x, blk["ln_2"], blk["mlp"]))):
        try:
            call()
        except ValueError as e:
            print(f"[kernels] {name} refuses D = 192: {e}")
        else:
            fail(f"{name} ran at D = 192, a width its kernel does not take")
    print("[kernels] " + json.dumps({"checked": [
        {k: r.get(k) for k in ("name", "shape", "max_abs_err", "max_rel_err", "tolerance")}
        | {"ok": True} for r in results]}))
    return results


def phase_attention(card: dict) -> list[dict]:
    """K4 and K8 against their plain versions on the card, timed beside
    ``scaled_dot_product_attention`` on the same q/k/v viewed as
    [B, H, T, 64] (the library yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from clip_ppo_tpu_torch.models.clip import attention_kernels as ak

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src = "clip_ppo_tpu_torch/csrc/fused_qkv.cu"
    cases = [  # (kernel, path, (B, T, heads), causal, timed)
        ("fused_qkv", "benchmark", (256, 257, 16), False, True),  # ViT-L/14 vision
        ("fused_qkv", None, (1024, 50, 12), False, True),  # ViT-B/32 vision, impl="fused"
        ("fused_qkv", None, (1024, 77, 12), True, True),  # ViT-L/14 text, impl="fused"
        ("fused_qkv", None, (3, 257, 16), False, False),  # ragged: 1-row last tile
        ("packed_attention", "pallas", (64, 50, 12), False, True),  # ViT-B/32, impl="pallas"
        ("packed_attention", None, (256, 257, 16), False, True),  # ViT-L/14, impl="pallas"
    ]
    results = []
    with torch.no_grad():
        for name, path, (b, t, h), causal, timed in cases:
            d = h * 64
            qkv = torch.randn((b, t, 3 * d), generator=gen, device=dev)
            q, k, v = (z.view(b, t, h, 64) for z in qkv.split(d, dim=-1))  # row stride 3D
            if name == "fused_qkv":
                fn = lambda: ak.fused_qkv_attention(qkv, h, causal)  # noqa: E731
                plain = lambda: ak.fused_qkv_attention_plain(qkv, h, causal)  # noqa: E731
                shape, line = f"[{b},{t},{3 * d}]" + (" causal" if causal else ""), 91
            else:
                fn = lambda: ak.packed_attention(q, k, v)  # noqa: E731
                plain = lambda: ak.packed_attention_plain(q, k, v)  # noqa: E731
                shape, line = f"[{b},{t},{h},64] strided", 391
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
            qh, kh, vh = (z.transpose(1, 2) for z in (q, k, v))
            ms = time_ms(fn, reps=10)
            plain_ms = time_ms(plain, reps=10)
            library_ms = time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal), reps=10)
            pairs = t * (t + 1) // 2 if causal else t * t
            nflops = 2 * 2 * b * pairs * d  # scores and weighted values
            bound_ms, bound_by = _bound(4 * b * t * d * 4, nflops, card)  # q, k, v read; out written
            print(f"[kernels] {name} {shape}: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"scaled_dot_product_attention {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
                  f"({bound_by}, {nflops / 1e9:.1f} GFLOP), {nflops / ms / 1e9:.2f} TFLOP/s")
            results.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": f"clip_ppo_tpu/models/clip/pallas_attention.py:{line}",
                "shape": shape, "path": path, "max_abs_err": err, "max_rel_err": rel,
                "tolerance": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
            })
            del qkv, q, k, v, qh, kh, vh
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
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
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
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
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
    print(json.dumps({"kernels": [{k: r[k] for k in order} for r in results if r["path"]]}))
    print(card["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
