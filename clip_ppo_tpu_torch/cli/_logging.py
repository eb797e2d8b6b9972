"""Shared per-iteration TB/console logging for the training CLIs.

All four entry points (and the Atari CLIs' host/ALE variants) write the
same reference tag set per iteration — episodic stats, the seven loss
scalars, learning rate, SPS (reference
`ppo_minigrid.py:352-366`) — differing only in whether episodes are
echoed to stdout (the vanilla Atari script's CleanRL print), whether
``losses/clip_loss`` is written, and the optional verbose debug print.
This class is that one block; each CLI instantiates it with its flavor
instead of carrying a copy.

State the CLIs read back: ``global_step`` (checkpoint payloads, also
settable on resume), ``last_returns`` (the train() summary),
``b_returns`` (the reference checkpoint payload's last GAE batch
returns, `shared/checkpoint_utils.py:21-29`), and ``sps``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

LOSS_TAGS = (
    "value_loss", "policy_loss", "entropy", "old_approx_kl",
    "approx_kl", "clipfrac", "explained_variance",
)


def _hms(seconds: float) -> str:
    """tqdm-style duration: MM:SS, or H:MM:SS from one hour up."""
    s = max(int(seconds), 0)
    if s >= 3600:
        return f"{s // 3600}:{s // 60 % 60:02d}:{s % 60:02d}"
    return f"{s // 60:02d}:{s % 60:02d}"


class IterationLogger:
    def __init__(
        self,
        writer,
        profiler,
        recorder,
        *,
        num_envs: int,
        batch_size: int,
        num_iterations: int,
        echo_episodes: bool = False,
        log_clip_loss: bool = False,
        verbose_fn: Optional[Callable[[int, dict], None]] = None,
        quiet: bool = False,
        log_intrinsic: bool = False,
    ) -> None:
        self.writer = writer
        self.profiler = profiler
        self.recorder = recorder
        self.num_envs = num_envs
        self.batch_size = batch_size
        self.num_iterations = num_iterations
        self.echo_episodes = echo_episodes
        self.log_clip_loss = log_clip_loss
        self.verbose_fn = verbose_fn
        self.quiet = quiet  # non-main distributed processes stay silent
        self.log_intrinsic = log_intrinsic

        self.global_step = 0  # settable on checkpoint resume
        self.start_time = time.time()
        self.last_returns: list[float] = []
        self.b_returns = None
        self._iters_done = 0  # iterations handled by THIS logger (ETA basis)
        self._steps_here = 0  # steps accumulated by THIS logger (SPS basis)

    @property
    def sps(self) -> float:
        # Steps since THIS logger started, not global_step: after
        # --resume-checkpoint global_step includes pre-resume steps while
        # start_time is fresh, which would inflate charts/SPS.
        return self._steps_here / (time.time() - self.start_time)

    def _episode(self, ret: float, length: int, step_at: int) -> None:
        if self.echo_episodes and not self.quiet:
            print(f"global_step={step_at}, episodic_return={ret}")
        self.writer.add_scalar("charts/episodic_return", ret, step_at)
        self.writer.add_scalar("charts/episodic_length", length, step_at)
        self.last_returns.append(ret)

    def _scalars(self, it: int, scalars: dict) -> None:
        self.global_step += self.batch_size
        self._steps_here += self.batch_size
        for tag in LOSS_TAGS:
            self.writer.add_scalar(
                f"losses/{tag}", float(scalars[tag]), self.global_step
            )
        if self.log_clip_loss:
            # Logged unconditionally like the reference
            # (`clip_ppo_minigrid.py:584`).
            self.writer.add_scalar(
                "losses/clip_loss", float(scalars["clip_loss"]),
                self.global_step,
            )
        if self.verbose_fn is not None:
            self.verbose_fn(it, scalars)
        self.writer.add_scalar(
            "charts/learning_rate", float(scalars["learning_rate"]),
            self.global_step,
        )
        if self.log_intrinsic:
            # beyond-reference: mean count bonus this iteration
            # (--exploration-bonus, train/exploration.py). Gated so runs
            # without the bonus keep the exact reference tag set.
            self.writer.add_scalar(
                "charts/intrinsic_reward",
                float(scalars["intrinsic_reward"]), self.global_step,
            )
        sps = int(self.sps)
        self._iters_done += 1
        if not self.quiet:
            # tqdm-style progress (the reference wraps the iteration loop
            # in tqdm, `ppo_minigrid.py:235`): percent + elapsed + ETA from
            # the mean per-iteration wall time since this logger started.
            elapsed = time.time() - self.start_time
            eta = elapsed / self._iters_done * max(self.num_iterations - it, 0)
            print(
                f"iteration {it}/{self.num_iterations} "
                f"({100 * it // max(self.num_iterations, 1)}%) SPS: {sps} "
                f"[{_hms(elapsed)}<{_hms(eta)}]"
            )
        self.writer.add_scalar("charts/SPS", sps, self.global_step)

    def handle(self, it: int, scalars: dict, episode_stats: dict) -> None:
        """LogPipeline callback for the device (packed-logs) path."""
        self.profiler.step(it)
        if self.recorder is not None:
            self.recorder.add_rollout(
                np.asarray(episode_stats["env0_frames"]),
                np.asarray(episode_stats["env0_dones"]),
            )
        done_mask = np.asarray(episode_stats["done_mask"])
        ep_ret = np.asarray(episode_stats["episode_return"])
        ep_len = np.asarray(episode_stats["episode_length"])
        for t, env_idx in zip(*np.nonzero(done_mask)):
            step_at = self.global_step + (int(t) + 1) * self.num_envs
            self._episode(
                float(ep_ret[t, env_idx]), int(ep_len[t, env_idx]), step_at
            )
        self.b_returns = episode_stats.get("b_returns", self.b_returns)
        self._scalars(it, scalars)

    def log_host_iteration(
        self, it: int, scalars: dict, episodes, extras
    ) -> None:
        """HostTrainer path: episodes is a list of (return, length,
        rollout_step) tuples, extras the optional env0 video frames."""
        self.profiler.step(it)
        if self.recorder is not None and extras:
            self.recorder.add_rollout(
                extras["env0_frames"], extras["env0_dones"]
            )
        for r, length, t in episodes:
            step_at = self.global_step + (int(t) + 1) * self.num_envs
            self._episode(r, length, step_at)
        self._scalars(it, scalars)
