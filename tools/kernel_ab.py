#!/usr/bin/env python3
"""Time the hand-written kernels of two checkouts of the port in turns on
one GPU: the attention kernels (K4 ``fused_qkv``, K8 ``packed_attention``),
the resblock halves on the shared GEMM (K2 ``attn_block``, K3
``mlp_block``, K5 ``mlp_stream``, K6 ``attn_stream``, K7 ``mlp_chunked``)
and the disturbance (K1 ``disturb``).

    python3 tools/kernel_ab.py OTHER_ROOT [--kernels all|attention|block|disturb]

``OTHER_ROOT`` is another checkout (for example an earlier commit unpacked
with ``git archive``). The script runs OTHER, this checkout, this checkout,
OTHER, each in a process of its own that imports ``clip_ppo_tpu_torch``
from that root and builds its kernels there. Each run takes this
checkout's ``chip_smoke.py`` cases and measures as chip_smoke's phase 2
does, after checking the kernel against its plain version with chip_smoke's
tolerance: every timed case of ``ATTENTION_CASES``, the kernel and
``scaled_dot_product_attention`` by CUDA events around ``ATTENTION_CALLS``
back-to-back calls (median of 10 runs) and the kernel's device time from a
profiler trace; every timed K2, K3 and K5 case of ``BLOCK_CASES`` and K6
and K7 case of ``STREAM_CASES``, by CUDA events around one call (median of
10), on a resblock with random LayerNorm affines and biases; and K1 at HARD
[8,84,84,3] with its noise drawn in the kernel, the rollout's mode, by CUDA
events around 50 back-to-back calls (median of 20) and its device time per
launch from a profiler trace of 50. A shape the other checkout's wrapper
refuses is recorded as refused. It prints one JSON line per run and case, the card's
name and power limit, and last a JSON summary with each case's two runs per
checkout.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
BLOCK_KERNELS = ("attn_block", "mlp_block", "mlp_stream", "attn_stream", "mlp_chunked")
GROUPS = ("all", "attention", "block", "disturb")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _attention(cs, root: str, gen) -> None:
    n = cs.ATTENTION_CALLS
    for case in cs.ATTENTION_CASES:
        if not case[4]:  # not timed
            continue
        fn, plain, sdpa, shape, _, _ = cs.attention_case(case, gen)
        got, ref = fn(), plain()
        err, tol = (got - ref).abs().max().item(), 1e-4 * max(1.0, ref.abs().max().item())
        del got, ref
        if not err <= tol:
            cs.fail(f"{case[0]} {shape} from {root} disagrees with its plain version: "
                    f"{err} > {tol}")
        print(json.dumps({
            "root": root, "name": case[0], "shape": shape, "max_abs_err": err,
            "ms": cs.time_ms(fn, reps=10, calls=n),
            "library_ms": cs.time_ms(sdpa, reps=10, calls=n),
            "device_ms": cs.device_ms(fn, calls=n)}), flush=True)


def _block(cs, root: str, gen, dev) -> None:
    import torch

    params = {}
    for spec in cs.BLOCK_CASES + cs.STREAM_CASES:
        name, b, t, dm, causal, _, timed = spec
        if name not in BLOCK_KERNELS or not timed:
            continue
        _, _, _, fn, plain, *_ = cs.block_case(spec)
        if dm not in params:
            params[dm] = cs.random_block(gen, dm, dev)
        p = params[dm]
        x = torch.randn((b, t, dm), generator=gen, device=dev)
        shape = f"[{b},{t},{dm}]" + (" causal" if causal else "")
        try:
            got = fn(x, p)
        except ValueError as e:
            print(json.dumps({"root": root, "name": name, "shape": shape, "refused": str(e)}),
                  flush=True)
            continue
        ref = plain(x, p)
        err, tol = (got - ref).abs().max().item(), 1e-4 * max(1.0, ref.abs().max().item())
        del got, ref
        if not err <= tol:
            cs.fail(f"{name} {shape} from {root} disagrees with its plain version: {err} > {tol}")
        print(json.dumps({"root": root, "name": name, "shape": shape, "max_abs_err": err,
                          "ms": cs.time_ms(lambda: fn(x, p), reps=10)}), flush=True)


def _disturb(cs, root: str, gen, dev) -> None:
    """K1 at HARD [8,84,84,3] as the rollout calls it, the noise drawn in
    the kernel from the call's seed."""
    import torch

    from clip_ppo_tpu_torch.ops import disturb_kernel as dk
    from clip_ppo_tpu_torch.ops.disturbances import draw
    from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity, SEVERITY_CONFIGS

    params = SEVERITY_CONFIGS[DisturbanceSeverity.HARD]
    x = torch.rand((8, 84, 84, 3), generator=gen, device=dev)
    d = draw(x, params, gen)
    k1 = lambda: dk.disturb_batched(x, params, d)  # noqa: E731
    print(json.dumps({"root": root, "name": "disturb", "shape": "[8,84,84,3] HARD",
                      "ms": cs.time_ms(k1, reps=20, calls=50),
                      "device_ms": cs.device_ms(k1, calls=50, kernel="disturb_kernel")}),
          flush=True)


def run_one(root: str, kernels: str) -> None:
    """Time the chosen cases with the port imported from ``root``."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    cs = _chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from clip_ppo_tpu_torch import cuda_build

    cuda_build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    with torch.no_grad():
        if kernels in ("all", "attention"):
            _attention(cs, root, gen)
        if kernels in ("all", "block"):
            _block(cs, root, gen, dev)
        if kernels in ("all", "disturb"):
            _disturb(cs, root, gen, dev)


def main() -> None:
    args = sys.argv[1:]
    kernels = "all"
    if len(args) >= 2 and args[-2] == "--kernels":
        kernels = args[-1]
        args = args[:-2]
    if kernels not in GROUPS:
        sys.exit(__doc__)
    if len(args) == 2 and args[0] == "--one":
        run_one(args[1], kernels)
        return
    if len(args) != 1:
        sys.exit(__doc__)
    other = str(Path(args[0]).resolve())
    rows = []
    for root in (other, str(HERE), str(HERE), other):
        out = subprocess.run([sys.executable, __file__, "--one", root, "--kernels", kernels],
                             check=True, capture_output=True, text=True).stdout
        print(out, end="", flush=True)
        rows += [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    summary = {}
    for r in rows:
        key = f"{r['name']} {r['shape']}"
        side = "this" if r["root"] == str(HERE) else "other"
        s = summary.setdefault(key, {"this": [], "other": [], "library": []})
        s[side].append(r.get("ms", "refused"))
        if "device_ms" in r:
            s.setdefault(f"{side}_device", []).append(r["device_ms"])
        if "library_ms" in r:
            s["library"].append(r["library_ms"])
    print(json.dumps({"other": other, "this": str(HERE), "ms": summary}))


if __name__ == "__main__":
    main()
