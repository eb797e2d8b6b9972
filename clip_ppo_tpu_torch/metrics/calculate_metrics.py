"""Shared metric math over TensorBoard runs: RI, AUC, success rates.

Port of ``clip_ppo_tpu/metrics/calculate_metrics.py`` (the reference's
`metrics/calculate_metrics.py:16-243`) that needs neither tensorboard nor
pandas: the runs are read by :mod:`clip_ppo_tpu_torch.io.tb_reader` (what
tensorboard's ``EventAccumulator`` returns, its 10,000-scalar reservoir and
its purge included) and the series are numpy arrays. Tag names, fallback
orders, windowing and fill rules are the JAX package's:

* scalar-tag fallbacks ``charts/episodic_return`` → ``episodic_return`` →
  ``charts/returns`` (lengths analogous);
* Robustness Index = rolling(50, min_periods=1)-mean disturbed / clean,
  truncated to the shorter run, masked where clean ≤ 0.1, then
  ffill → bfill → 0;
* AUC = trapezoid over (timestep, return), normalized by timestep range;
* success rate = % of episodes with return > threshold (final-window
  variant over the last 100).

:func:`compute_robustness_index_over_time` returns a dict of the four
columns of the JAX package's DataFrame (``timestep``, ``clean_return``,
``disturbed_return``, ``robustness_index``) as numpy arrays. Each window
mean here sums its own window, where pandas keeps a running sum: the two
agree to a relative 1e-12.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from clip_ppo_tpu_torch.io.tb_reader import EventAccumulator
from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity

RETURN_TAGS = ("charts/episodic_return", "episodic_return", "charts/returns")
LENGTH_TAGS = ("charts/episodic_length", "episodic_length", "charts/lengths")
SEVERITY_TAG = "config/disturbance_severity/text_summary"

_SEVERITY_FROM_TEXT = {
    "CLEAN": DisturbanceSeverity.NONE,
    "MILD": DisturbanceSeverity.MILD,
    "MODERATE": DisturbanceSeverity.MODERATE,
    "HARD": DisturbanceSeverity.HARD,
    "SEVERE": DisturbanceSeverity.SEVERE,
}


def _load_accumulator(run_path: str) -> EventAccumulator:
    return EventAccumulator(run_path).Reload()


def rolling_mean(values, window: int) -> np.ndarray:
    """``pd.Series(values).rolling(window, min_periods=1).mean()`` as a
    float64 array: the mean of the last ``window`` values at each index (of
    all so far before the first full window)."""
    x = np.asarray(values, dtype=np.float64)
    n = len(x)
    out = np.empty(n)
    head = min(window - 1, n)
    for i in range(head):
        out[i] = x[: i + 1].sum() / (i + 1)
    if n >= window:
        out[head:] = np.lib.stride_tricks.sliding_window_view(x, window).sum(axis=1) / window
    return out


def _fill(ri: np.ndarray) -> np.ndarray:
    """``pd.Series(ri).ffill().bfill().fillna(0)``."""
    ri = ri.copy()
    valid = ~np.isnan(ri)
    if not valid.any():
        return np.zeros_like(ri)
    idx = np.where(valid, np.arange(len(ri)), -1)
    np.maximum.accumulate(idx, out=idx)
    first = int(np.argmax(valid))
    idx[idx < 0] = first
    return ri[idx]


def load_tensorboard_run(run_path: str) -> Tuple[List[int], List[float], List[float]]:
    """(timesteps, returns, episode_lengths) from a TB run directory, with
    the reference's tag-name fallback lists."""
    ea = _load_accumulator(run_path)
    scalar_tags = ea.Tags()["scalars"]
    returns_data = next((ea.Scalars(tag) for tag in RETURN_TAGS if tag in scalar_tags), None)
    if returns_data is None:
        raise ValueError(
            f"Could not find episodic return data in any expected tags: {list(RETURN_TAGS)}"
        )
    timesteps = [x.step for x in returns_data]
    returns = [x.value for x in returns_data]
    episode_lengths: List[float] = next(
        ([x.value for x in ea.Scalars(tag)] for tag in LENGTH_TAGS if tag in scalar_tags), [])
    return timesteps, returns, episode_lengths


def get_disturbance_severity(run_path: str) -> DisturbanceSeverity:
    """Severity recorded as the TB *text* tensor by the training CLIs."""
    ea = _load_accumulator(run_path)
    if SEVERITY_TAG in ea.Tags().get("tensors", []):
        text_data = ea.Tensors(SEVERITY_TAG)
        if text_data:
            severity_text = text_data[0].tensor_proto.string_val[0].decode("utf-8")
            return _SEVERITY_FROM_TEXT.get(severity_text, DisturbanceSeverity.NONE)
    raise ValueError(f"Unable to find disturbance severity in run_path {run_path}.")


def compute_robustness_index_over_time(clean_run_path: str, disturbed_run_path: str,
                                       window_size: int = 50) -> dict:
    """RI(t) = rolling-mean disturbed / clean, with the clean floor and
    fill rules of the reference: a dict of numpy columns ``timestep``,
    ``clean_return``, ``disturbed_return`` and ``robustness_index``."""
    clean_ts, clean_ret, _ = load_tensorboard_run(clean_run_path)
    _, dist_ret, _ = load_tensorboard_run(disturbed_run_path)
    clean_roll = rolling_mean(clean_ret, window_size)
    dist_roll = rolling_mean(dist_ret, window_size)
    n = min(len(clean_roll), len(dist_roll))
    clean, dist = clean_roll[:n], dist_roll[:n]

    min_clean_threshold = 0.1
    ri = np.full(n, np.nan)
    valid = clean > min_clean_threshold
    ri[valid] = dist[valid] / clean[valid]
    frame = {
        "timestep": np.asarray(clean_ts[:n]),
        "clean_return": clean,
        "disturbed_return": dist,
        "robustness_index": _fill(ri),
    }
    print(f"Final robustness index: {frame['robustness_index'][-1]:.3f}")
    print(f"Mean robustness index: {frame['robustness_index'].mean():.3f}")
    return frame


def compute_robustness_index(clean_run_path: str, disturbed_run_path: str,
                             window_size: int = 50) -> float:
    """Final-value RI (last row of the over-time series)."""
    frame = compute_robustness_index_over_time(clean_run_path, disturbed_run_path, window_size)
    return float(frame["robustness_index"][-1])


def compute_auc_metric(timesteps: List[int], returns: List[float]) -> float:
    """Normalized trapezoidal AUC of a learning curve (== time-averaged
    return over the logged span)."""
    if len(timesteps) < 2:
        return 0.0
    t = np.asarray(timesteps, dtype=np.float64)
    r = np.asarray(returns, dtype=np.float64)
    span = t[-1] - t[0]
    if span <= 0:
        return 0.0
    return float((np.diff(t) * (r[1:] + r[:-1]) / 2.0).sum() / span)


def compute_success_rate(run_path: str, success_threshold: float = 0.0) -> float:
    """% of all episodes with return > threshold."""
    _, returns, _ = load_tensorboard_run(run_path)
    if not returns:
        return 0.0
    return 100.0 * sum(1 for r in returns if r > success_threshold) / len(returns)


def compute_final_success_rate(run_path: str, window_size: int = 100,
                               success_threshold: float = 0.0) -> float:
    """% of the last ``window_size`` episodes with return > threshold."""
    _, returns, _ = load_tensorboard_run(run_path)
    if not returns:
        return 0.0
    final = returns[-window_size:]
    return 100.0 * sum(1 for r in final if r > success_threshold) / len(final)
