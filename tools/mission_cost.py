"""What ``--mission-conditioning`` costs a vanilla iteration, part by part.

Two feed-forward Trainers on the same env id (default BabyAI-BossLevel-v0),
8 envs × 128 steps in view mode, one plain and one FiLM-conditioned
(``models/mission.py``), from the same agent params. After a warm-up
iteration each, three rounds alternate the two arms and time each part of
an iteration on the host clock, synchronized: the rollout, GAE and the
update (4 epochs × 4 minibatches). Then the mission's own pieces, each
called 128 times on the rollout's inputs: ``mission_fn`` (the 64 slots
from the env state), ``featurize`` and ``mission_film`` (γ, β), and the
policy's features with and without the FiLM. Last, the kernels each arm's
rollout launches a step and its update launches, from torch.profiler traces
of 4- and 8-step iterations (the difference over 4 steps).

    python tools/mission_cost.py                        # on the GPU
    python tools/mission_cost.py --env-id BabyAI-GoToSeqS5R2-v0 --no-cuda

One JSON line, with the device's name (and, on a GPU, its power limit from
nvidia-smi); medians over the rounds.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _device_name(device) -> str:
    import torch

    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    lines = smi.stdout.strip().splitlines() if smi.returncode == 0 else []
    return lines[0] if lines else f"{torch.cuda.get_device_name(0)}, power limit not read"


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--env-id", default="BabyAI-BossLevel-v0")
    parser.add_argument("--num-steps", type=int, default=128)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--cuda", action=argparse.BooleanOptionalAction, default=True)
    opts = parser.parse_args(argv)

    import torch

    from clip_ppo_tpu_torch.device import resolve_device
    from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
    from clip_ppo_tpu_torch.models import agent as agent_mod
    from clip_ppo_tpu_torch.models import mission as mission_mod
    from clip_ppo_tpu_torch.train.ppo import PPOConfig
    from clip_ppo_tpu_torch.train.runner import Draws, Trainer

    device = resolve_device(opts.cuda)
    env = TorchVectorEnv(opts.env_id, 8, device)
    gen = torch.Generator()
    gen.manual_seed(1)
    params = agent_mod.init_agent_params(gen, env.num_actions, device,
                                         mission_dim=env.mission_dim)
    plain = {k: v for k, v in params.items() if k != "mission"}
    arms = {False: plain, True: params}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def clock(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def make(mission: bool, num_steps: int):
        trainer = Trainer(PPOConfig(num_steps=num_steps), env, 2, mission_conditioning=mission)
        state, *_ = trainer.iteration(trainer.init_state(arms[mission], 1), 1)  # warm-up
        return trainer, state

    def parts(trainer, state) -> tuple[dict, object, object]:
        (state2, batch), roll = clock(lambda: trainer._rollout(state, Draws()))
        data, gae = clock(lambda: trainer._data2d(state2, batch))
        _, upd = clock(lambda: trainer._update(state2, data, 2, None, Draws()))
        return {"rollout": roll, "gae": gae, "update": upd}, state2, batch

    full = {m: make(m, opts.num_steps) for m in (False, True)}
    times: dict = {m: {"rollout": [], "gae": [], "update": []} for m in (False, True)}
    batches = {}
    for _ in range(opts.rounds):
        for m in (False, True):
            trainer, state = full[m]
            ms, state, batches[m] = parts(trainer, state)
            full[m] = (trainer, state)
            for k, v in ms.items():
                times[m][k].append(v)
    med = {m: {k: statistics.median(v) for k, v in times[m].items()} for m in (False, True)}

    # The mission's own pieces on the last rollout's inputs, 128 calls each.
    trainer_m, state_m = full[True]
    obs, missions = batches[True].obs
    obs0, m0 = obs[0], missions[0]
    base_fn = trainer_m.features_fn.base_fn

    def per_call(fn) -> float:
        fn()
        _, ms = clock(lambda: [fn() for _ in range(128)])
        return ms / 128

    with torch.no_grad():
        pieces = {
            "mission_fn": per_call(lambda: env.mission_fn(state_m.vec_state)),
            "featurize": per_call(lambda: mission_mod.featurize(m0)),
            "mission_film": per_call(lambda: mission_mod.mission_film(params["mission"], m0)),
            "features_plain": per_call(lambda: base_fn(params, obs0, None)),
            "features_film": per_call(lambda: trainer_m.features_fn(params, (obs0, m0), None)),
        }

    # Kernels a rollout step and an update launch, from two short traces.
    launches = {}
    if device.type == "cuda":
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

        def count(fn) -> int:
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                sync()
            return sum(e.count for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.key.endswith("_launch"))

        for m in (False, True):
            counts = {}
            for steps in (4, 8):
                trainer, state = make(m, steps)
                out = {}

                def roll():
                    out["s"], out["b"] = trainer._rollout(state, Draws())

                counts[f"rollout{steps}"] = count(roll)
                data = trainer._data2d(out["s"], out["b"])
                counts[f"update{steps}"] = count(
                    lambda: trainer._update(out["s"], data, 2, None, Draws()))
            launches["mission" if m else "plain"] = {
                "rollout_step": (counts["rollout8"] - counts["rollout4"]) / 4,
                "update": counts["update8"], "traced": counts}

    line = {
        "metric": "mission_cost", "env_id": opts.env_id, "num_envs": 8,
        "num_steps": opts.num_steps, "rounds": opts.rounds,
        "plain_ms": med[False], "mission_ms": med[True],
        "rounds_ms": {"plain": times[False], "mission": times[True]},
        "pieces_ms_per_call": pieces, "launches": launches or "not measured (CPU)",
        "device": _device_name(device),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
