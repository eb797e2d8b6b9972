from clip_ppo_tpu_torch.metrics.calculate_metrics import (
    compute_auc_metric,
    compute_final_success_rate,
    compute_robustness_index,
    compute_robustness_index_over_time,
    compute_success_rate,
    get_disturbance_severity,
    load_tensorboard_run,
)

__all__ = [
    "compute_auc_metric",
    "compute_final_success_rate",
    "compute_robustness_index",
    "compute_robustness_index_over_time",
    "compute_success_rate",
    "get_disturbance_severity",
    "load_tensorboard_run",
]
