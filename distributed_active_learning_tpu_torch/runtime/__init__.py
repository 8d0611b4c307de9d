"""AL state, driver loop, results and phase timing of the port."""

from distributed_active_learning_tpu_torch.runtime.state import (
    PoolState,
    init_pool_state,
    labeled_count,
    reveal,
    set_start_state,
)

__all__ = ["PoolState", "init_pool_state", "labeled_count", "reveal", "set_start_state"]
