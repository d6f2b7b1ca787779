"""The workload zoo (``persia_tpu/workloads``): seeded scenario streams
(:mod:`~persia_tpu_torch.workloads.generator`), their dense towers
(:mod:`~persia_tpu_torch.workloads.models`) and the scenario registry
(:mod:`~persia_tpu_torch.workloads.registry`)."""

from persia_tpu_torch.workloads.registry import (
    Scenario,
    evaluate_auc,
    get_scenario,
    register_scenario,
    scenario_names,
)

__all__ = [
    "Scenario",
    "evaluate_auc",
    "get_scenario",
    "register_scenario",
    "scenario_names",
]
