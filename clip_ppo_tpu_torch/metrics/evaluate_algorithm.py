"""Single-run evaluation: learning curves, AUC, 2×2 robustness dashboard.

Port of ``clip_ppo_tpu/metrics/evaluate_algorithm.py`` (the reference's
`metrics/evaluate_algorithm.py:84-265`): rolling-mean learning curve with
raw overlay, AUC bar comparison, and the four-panel robustness dashboard
(returns over time, RI over time, performance gap, RI distribution).
Figures are saved under ``--save-dir`` and shown only with ``--show``;
matplotlib is imported where a figure is drawn.

Usage:
    python -m clip_ppo_tpu_torch.metrics.evaluate_algorithm \
        --clean-run-path runs/clean --disturbed-run-path runs/hard
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from clip_ppo_tpu_torch.metrics._plotting import finish, pyplot
from clip_ppo_tpu_torch.metrics.calculate_metrics import (
    compute_auc_metric,
    compute_robustness_index_over_time,
    load_tensorboard_run,
    rolling_mean,
)
from clip_ppo_tpu_torch.utils import flags


@dataclass
class EvaluationConfig:
    """Configuration for robustness evaluation."""

    clean_run_path: str = "runs/clean"
    """Path to clean (undisturbed) TensorBoard run directory"""
    disturbed_run_path: str = "runs/disturbed"
    """Path to disturbed TensorBoard run directory"""
    save_dir: str = "plots"
    """Directory for output figures"""
    show: bool = False
    """Also open interactive windows (reference behavior)"""
    window_size: int = 50
    """Rolling window for smoothing"""


def _runs(cfg: EvaluationConfig):
    return ((cfg.clean_run_path, "clean"), (cfg.disturbed_run_path, "disturbed"))


def plot_mean_return_vs_timesteps(cfg: EvaluationConfig) -> str:
    """Rolling-mean learning curves with a faint raw overlay."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(10, 6))
    for path, label in _runs(cfg):
        ts, ret, _ = load_tensorboard_run(path)
        (line,) = ax.plot(ts, rolling_mean(ret, cfg.window_size), label=label, linewidth=2)
        ax.plot(ts, ret, alpha=0.15, color=line.get_color())
    ax.set_xlabel("Timesteps")
    ax.set_ylabel("Episodic Return")
    ax.set_title("Mean Returns vs Timesteps")
    ax.legend()
    ax.grid(True, alpha=0.3)
    return finish(fig, cfg.save_dir, cfg.show, "learning_curve.png")


def plot_auc_comparison(cfg: EvaluationConfig) -> str:
    """Normalized-AUC bars for the two runs."""
    plt = pyplot()
    labels, aucs = [], []
    for path, label in _runs(cfg):
        ts, ret, _ = load_tensorboard_run(path)
        labels.append(label)
        aucs.append(compute_auc_metric(ts, ret))
    fig, ax = plt.subplots(figsize=(7, 6))
    bars = ax.bar(labels, aucs, alpha=0.7, edgecolor="black")
    for bar, v in zip(bars, aucs):
        ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(),
                f"{v:.3f}", ha="center", va="bottom", fontweight="bold")
    ax.set_ylabel("Normalized AUC")
    ax.set_title("AUC Comparison")
    ax.grid(True, alpha=0.3, axis="y")
    return finish(fig, cfg.save_dir, cfg.show, "auc_comparison.png")


def plot_robustness_analysis(cfg: EvaluationConfig) -> str:
    """2×2 dashboard: curves, RI(t), performance gap, RI histogram."""
    plt = pyplot()
    frame = compute_robustness_index_over_time(
        cfg.clean_run_path, cfg.disturbed_run_path, cfg.window_size)
    ts = frame["timestep"]
    fig, axes = plt.subplots(2, 2, figsize=(14, 10))

    ax = axes[0, 0]
    ax.plot(ts, frame["clean_return"], label="clean", linewidth=2)
    ax.plot(ts, frame["disturbed_return"], label="disturbed", linewidth=2)
    ax.set_title("Returns over Time")
    ax.set_xlabel("Timesteps")
    ax.set_ylabel("Rolling-Mean Return")
    ax.legend()
    ax.grid(True, alpha=0.3)

    ax = axes[0, 1]
    ax.plot(ts, frame["robustness_index"], color="tab:green", linewidth=2)
    ax.axhline(1.0, color="black", linestyle="--", alpha=0.5)
    ax.set_title("Robustness Index over Time")
    ax.set_xlabel("Timesteps")
    ax.set_ylabel("RI (disturbed/clean)")
    ax.grid(True, alpha=0.3)

    ax = axes[1, 0]
    ax.plot(ts, frame["clean_return"] - frame["disturbed_return"], color="tab:red", linewidth=2)
    ax.axhline(0.0, color="black", linestyle="--", alpha=0.5)
    ax.set_title("Performance Gap (clean − disturbed)")
    ax.set_xlabel("Timesteps")
    ax.set_ylabel("Return Gap")
    ax.grid(True, alpha=0.3)

    ax = axes[1, 1]
    ri = frame["robustness_index"]
    ax.hist(ri[~np.isnan(ri)], bins=30, alpha=0.7, color="tab:purple", edgecolor="black")
    ax.axvline(1.0, color="black", linestyle="--", alpha=0.5)
    ax.set_title("Robustness Index Distribution")
    ax.set_xlabel("RI")
    ax.set_ylabel("Count")
    ax.grid(True, alpha=0.3, axis="y")

    fig.suptitle("Robustness Analysis")
    fig.tight_layout()
    return finish(fig, cfg.save_dir, cfg.show, "robustness_analysis.png")


def main(argv=None) -> list[str]:
    cfg = flags.parse(EvaluationConfig, argv)
    return [plot_mean_return_vs_timesteps(cfg), plot_auc_comparison(cfg),
            plot_robustness_analysis(cfg)]


if __name__ == "__main__":
    main()
