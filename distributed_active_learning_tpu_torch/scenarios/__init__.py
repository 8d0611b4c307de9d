"""The scenario engine (the port of ``scenarios/``): an oracle that flips
and abstains, labels that cost money under a per-round budget, a rare class
to hunt and a test stream that drifts, all put into the same AL drivers
(``runtime.loop``, ``runtime.sweep``) as configuration and a grid axis
(``ScenarioConfig``; ``run.py --scenario/--scenarios``;
``runtime.sweep.run_grid(scenarios=...)``). Off by default: a run of kind
``none`` is the clean loop."""

from distributed_active_learning_tpu_torch.config import ScenarioConfig  # noqa: F401
from distributed_active_learning_tpu_torch.scenarios.engine import (  # noqa: F401
    SCENARIO_KINDS,
    apply_flips,
    drift_apply,
    flip_mask,
    flip_mask_block,
    make_costs,
    rare_recall,
    scenario_from_name,
    validate_scenario,
)
