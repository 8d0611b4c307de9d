"""Query-strategy registry of the port."""

from distributed_active_learning_tpu_torch.strategies.base import (
    Strategy,
    StrategyAux,
    available_strategies,
    get_strategy,
    register_strategy,
)

# Import for registration side effects.
from distributed_active_learning_tpu_torch.strategies import core as _core  # noqa: F401
from distributed_active_learning_tpu_torch.strategies import lal as _lal  # noqa: F401

__all__ = [
    "Strategy",
    "StrategyAux",
    "get_strategy",
    "register_strategy",
    "available_strategies",
]
