"""Multi-algorithm comparison: RI bars, learning curves, success rates.

Port of ``clip_ppo_tpu/metrics/compare_algorithms.py`` (the reference's
`metrics/compare_algorithms.py:16-362`): per-severity RI bars across
algorithms, clean+disturbed learning curves (color = algorithm, linestyle =
severity), success-rate bars, and RI-over-time curves for all severities.
Severity labels are machine-read from each run's TB text tensor. Algorithms
come from the command line as ``--algorithms "NAME:clean_path:dist1,dist2"
...`` or, from a script, as :class:`AlgorithmConfig` values; matplotlib is
imported where a figure is drawn.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from clip_ppo_tpu_torch.metrics._plotting import finish, pyplot
from clip_ppo_tpu_torch.metrics.calculate_metrics import (
    compute_final_success_rate,
    compute_robustness_index,
    compute_robustness_index_over_time,
    get_disturbance_severity,
    load_tensorboard_run,
    rolling_mean,
)
from clip_ppo_tpu_torch.utils import flags

_SEVERITY_LINESTYLES = {
    "CLEAN": "-", "MILD": "--", "MODERATE": "-.", "HARD": ":", "SEVERE": (0, (1, 1)),
}


@dataclass
class AlgorithmConfig:
    """Configuration for a single algorithm."""

    name: str
    """Algorithm name for display"""
    clean_run_path: str
    """Path to clean (undisturbed) TensorBoard run directory"""
    disturbed_run_paths: List[str] = field(default_factory=list)
    """List of disturbed run paths for this algorithm"""


@dataclass
class ComparisonConfig:
    """Configuration for multi-algorithm comparison."""

    algorithms: tuple = ()
    """Algorithm specs as "NAME:clean_path:dist1,dist2" strings"""
    save_dir: str = "plots"
    """Directory for output figures"""
    show: bool = False
    """Also open interactive windows (reference behavior)"""
    window_size: int = 50
    """Rolling window for smoothing"""


def parse_algorithm_spec(spec: str) -> AlgorithmConfig:
    parts = spec.split(":")
    if len(parts) < 2:
        raise SystemExit(
            f"error: bad --algorithms spec {spec!r} "
            '(expected "NAME:clean_path[:dist1,dist2,...]")'
        )
    name, clean = parts[0], parts[1]
    disturbed = [p for p in parts[2].split(",") if p] if len(parts) > 2 else []
    return AlgorithmConfig(name, clean, disturbed)


def _algs(cfg: ComparisonConfig) -> List[AlgorithmConfig]:
    return [a if isinstance(a, AlgorithmConfig) else parse_algorithm_spec(a)
            for a in cfg.algorithms]


def _severity(run: str) -> str:
    return get_disturbance_severity(run).value.upper()


def _all_severities(algorithms: List[AlgorithmConfig]) -> List[str]:
    return sorted({_severity(run) for alg in algorithms for run in alg.disturbed_run_paths})


def _colors(plt, algorithms: List[AlgorithmConfig]):
    return plt.cm.tab10(np.linspace(0, 1, max(len(algorithms), 1)))


def plot_ri_comparison_across_algorithms(cfg: ComparisonConfig) -> Optional[str]:
    """One subplot per severity; bars = algorithms; 1.0 reference line."""
    algorithms = _algs(cfg)
    severities = _all_severities(algorithms)
    if not severities:
        print("no disturbed runs — skipping RI comparison")
        return None
    plt = pyplot()
    fig, axes = plt.subplots(1, len(severities), figsize=(5 * len(severities), 6),
                             squeeze=False)
    colors = _colors(plt, algorithms)
    for sev_idx, severity in enumerate(severities):
        ax = axes[0][sev_idx]
        names, ris, cols = [], [], []
        for alg_idx, alg in enumerate(algorithms):
            run = next((r for r in alg.disturbed_run_paths if _severity(r) == severity), None)
            if run is not None:
                names.append(alg.name)
                ris.append(compute_robustness_index(alg.clean_run_path, run))
                cols.append(colors[alg_idx % len(colors)])
        bars = ax.bar(names, ris, color=cols, alpha=0.7, edgecolor="black")
        for bar, ri in zip(bars, ris):
            ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(),
                    f"{ri:.3f}", ha="center", va="bottom", fontweight="bold")
        ax.axhline(1.0, color="black", linestyle="--", alpha=0.5,
                   label="Perfect Robustness (1.0)")
        ax.set_xlabel("Algorithm")
        ax.set_ylabel("Robustness Index")
        ax.set_title(f"{severity} Disturbance")
        ax.legend()
        ax.grid(True, alpha=0.3, axis="y")
    fig.tight_layout()
    return finish(fig, cfg.save_dir, cfg.show, "ri_comparison.png")


def plot_learning_curves_comparison(cfg: ComparisonConfig) -> str:
    """Color = algorithm, linestyle = severity (clean solid)."""
    algorithms = _algs(cfg)
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(12, 7))
    colors = _colors(plt, algorithms)
    for alg_idx, alg in enumerate(algorithms):
        runs = [("CLEAN", alg.clean_run_path)] + [(_severity(r), r)
                                                  for r in alg.disturbed_run_paths]
        for severity, run in runs:
            ts, ret, _ = load_tensorboard_run(run)
            ax.plot(ts, rolling_mean(ret, cfg.window_size),
                    color=colors[alg_idx % len(colors)],
                    linestyle=_SEVERITY_LINESTYLES.get(severity, "-"),
                    linewidth=2, label=f"{alg.name} ({severity})")
    ax.set_xlabel("Timesteps")
    ax.set_ylabel("Episodic Return (rolling mean)")
    ax.set_title("Learning Curves Comparison")
    ax.legend(fontsize=8)
    ax.grid(True, alpha=0.3)
    return finish(fig, cfg.save_dir, cfg.show, "learning_curves.png")


def plot_success_rate_comparison(cfg: ComparisonConfig) -> str:
    """Final-window success-rate bars, grouped clean + per severity."""
    algorithms = _algs(cfg)
    severities = ["CLEAN"] + _all_severities(algorithms)
    width = 0.8 / max(len(algorithms), 1)
    x = np.arange(len(severities))
    plt = pyplot()
    colors = _colors(plt, algorithms)

    fig, ax = plt.subplots(figsize=(10, 6))
    for alg_idx, alg in enumerate(algorithms):
        rates = []
        for severity in severities:
            run = alg.clean_run_path if severity == "CLEAN" else next(
                (r for r in alg.disturbed_run_paths if _severity(r) == severity), None)
            rates.append(compute_final_success_rate(run) if run is not None else np.nan)
        pos = x + (alg_idx - (len(algorithms) - 1) / 2) * width
        bars = ax.bar(pos, rates, width, color=colors[alg_idx % len(colors)],
                      alpha=0.7, edgecolor="black", label=alg.name)
        for bar, v in zip(bars, rates):
            if not np.isnan(v):
                ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(),
                        f"{v:.0f}%", ha="center", va="bottom", fontsize=8)
    ax.set_xticks(x)
    ax.set_xticklabels(severities)
    ax.set_ylabel("Success Rate (%) — last 100 episodes")
    ax.set_title("Success Rate Comparison")
    ax.legend()
    ax.grid(True, alpha=0.3, axis="y")
    return finish(fig, cfg.save_dir, cfg.show, "success_rates.png")


def plot_robustness_curves_comparison(cfg: ComparisonConfig) -> Optional[str]:
    """RI-over-time for every algorithm × severity (all-levels view)."""
    algorithms = _algs(cfg)
    if not _all_severities(algorithms):
        print("no disturbed runs — skipping RI curves")
        return None
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(12, 7))
    colors = _colors(plt, algorithms)
    for alg_idx, alg in enumerate(algorithms):
        for run in alg.disturbed_run_paths:
            severity = _severity(run)
            frame = compute_robustness_index_over_time(alg.clean_run_path, run, cfg.window_size)
            ax.plot(frame["timestep"], frame["robustness_index"],
                    color=colors[alg_idx % len(colors)],
                    linestyle=_SEVERITY_LINESTYLES.get(severity, "-"),
                    linewidth=2, label=f"{alg.name} ({severity})")
    ax.axhline(1.0, color="black", linestyle="--", alpha=0.5)
    ax.set_xlabel("Timesteps")
    ax.set_ylabel("Robustness Index")
    ax.set_title("Robustness Index over Time — All Severities")
    ax.legend(fontsize=8)
    ax.grid(True, alpha=0.3)
    return finish(fig, cfg.save_dir, cfg.show, "ri_curves_all.png")


def main(argv=None) -> list[Optional[str]]:
    cfg = flags.parse(ComparisonConfig, argv)
    if not cfg.algorithms:
        raise SystemExit('error: pass at least one --algorithms "NAME:clean[:d1,d2]" spec')
    return [plot_ri_comparison_across_algorithms(cfg), plot_learning_curves_comparison(cfg),
            plot_success_rate_comparison(cfg), plot_robustness_curves_comparison(cfg)]


if __name__ == "__main__":
    main()
