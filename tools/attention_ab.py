#!/usr/bin/env python3
"""Time the attention kernels (K4 ``fused_qkv``, K8 ``packed_attention``) of
two checkouts of the port in turns on one GPU.

    python3 tools/attention_ab.py OTHER_ROOT

``OTHER_ROOT`` is another checkout (for example an earlier commit unpacked
with ``git archive``). The script runs OTHER, this checkout, this checkout,
OTHER, each in a process of its own that imports ``clip_ppo_tpu_torch``
from that root and builds its kernels there. Each run takes every timed
case of ``chip_smoke.ATTENTION_CASES`` (this checkout's), checks the kernel
against its plain version with chip_smoke's tolerance, and times it as
chip_smoke's phase 2 does: the kernel and ``scaled_dot_product_attention``
by CUDA events around ``ATTENTION_CALLS`` back-to-back calls (median of 10
runs), and the kernel's device time from a profiler trace. It prints one
JSON line per run and case, the card's name and power limit, and last a
JSON summary with each case's two runs per checkout.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(root: str) -> None:
    """Time every timed attention case with the port imported from ``root``."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    cs = _chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from clip_ppo_tpu_torch import cuda_build

    cuda_build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=torch.device("cuda", 0))
    gen.manual_seed(3)
    n = cs.ATTENTION_CALLS
    with torch.no_grad():
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


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
        return
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    other = str(Path(sys.argv[1]).resolve())
    rows = []
    for root in (other, str(HERE), str(HERE), other):
        out = subprocess.run([sys.executable, __file__, "--one", root], check=True,
                             capture_output=True, text=True).stdout
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
        s[side].append(r["ms"])
        s["library"].append(r["library_ms"])
    print(json.dumps({"other": other, "this": str(HERE), "ms": summary}))


if __name__ == "__main__":
    main()
