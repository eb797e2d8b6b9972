"""Per-algorithm disturbance sweep: RI bars + RI-over-time per severity.

Port of ``clip_ppo_tpu/metrics/compare_algorithm_disturbances.py`` (the
reference's `metrics/compare_algorithm_disturbances.py:16-117`): severity
labels are machine-read from each disturbed run's
``config/disturbance_severity`` text tensor; bars use a green→red palette
over severities. Figures save under ``--save-dir`` (``--show`` restores the
reference's blocking windows); matplotlib is imported where a figure is drawn.

Usage:
    python -m clip_ppo_tpu_torch.metrics.compare_algorithm_disturbances \
        --algorithm-name PPO --clean-run-path runs/clean \
        --disturbance-runs runs/hard runs/severe
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from clip_ppo_tpu_torch.metrics._plotting import finish, pyplot
from clip_ppo_tpu_torch.metrics.calculate_metrics import (
    compute_robustness_index,
    compute_robustness_index_over_time,
    get_disturbance_severity,
)
from clip_ppo_tpu_torch.utils import flags


@dataclass
class RobustnessConfig:
    """Configuration for robustness analysis across disturbance levels."""

    algorithm_name: str = "PPO"
    """Algorithm name for the plot title"""
    clean_run_path: str = "runs/clean"
    """Path to clean (undisturbed) TensorBoard run directory"""
    disturbance_runs: tuple = ()
    """List of disturbed run paths"""
    save_dir: str = "plots"
    """Directory for output figures"""
    show: bool = False
    """Also open interactive windows (reference behavior)"""


def _severity_palette(plt, n: int):
    """Green→red gradient across severities (reference palette intent)."""
    return plt.cm.RdYlGn_r(np.linspace(0.15, 0.9, max(n, 1)))


def plot_ri_across_disturbances(cfg: RobustnessConfig) -> str:
    plt = pyplot()
    severities, ris = [], []
    for run in cfg.disturbance_runs:
        severities.append(get_disturbance_severity(run).value.upper())
        ris.append(compute_robustness_index(cfg.clean_run_path, run))

    fig, ax = plt.subplots(figsize=(8, 6))
    bars = ax.bar(severities, ris, color=_severity_palette(plt, len(severities)),
                  alpha=0.8, edgecolor="black")
    for bar, ri in zip(bars, ris):
        ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(),
                f"{ri:.3f}", ha="center", va="bottom", fontweight="bold")
    ax.axhline(1.0, color="black", linestyle="--", alpha=0.5,
               label="Perfect Robustness (1.0)")
    ax.set_xlabel("Disturbance Severity")
    ax.set_ylabel("Robustness Index")
    ax.set_title(f"{cfg.algorithm_name}: Robustness Across Disturbance Levels")
    ax.legend()
    ax.grid(True, alpha=0.3, axis="y")
    return finish(fig, cfg.save_dir, cfg.show, f"{cfg.algorithm_name}_ri_bars.png")


def plot_robustness_curves_over_time(cfg: RobustnessConfig) -> str:
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(10, 6))
    colors = _severity_palette(plt, len(cfg.disturbance_runs))
    for color, run in zip(colors, cfg.disturbance_runs):
        severity = get_disturbance_severity(run).value.upper()
        frame = compute_robustness_index_over_time(cfg.clean_run_path, run)
        ax.plot(frame["timestep"], frame["robustness_index"], label=severity,
                color=color, linewidth=2)
    ax.axhline(1.0, color="black", linestyle="--", alpha=0.5)
    ax.set_xlabel("Timesteps")
    ax.set_ylabel("Robustness Index")
    ax.set_title(f"{cfg.algorithm_name}: Robustness Index over Time")
    ax.legend()
    ax.grid(True, alpha=0.3)
    return finish(fig, cfg.save_dir, cfg.show, f"{cfg.algorithm_name}_ri_curves.png")


def main(argv=None) -> list[str]:
    cfg = flags.parse(RobustnessConfig, argv)
    return [plot_ri_across_disturbances(cfg), plot_robustness_curves_over_time(cfg)]


if __name__ == "__main__":
    main()
