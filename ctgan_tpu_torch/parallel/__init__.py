"""Process grids, sharding rules, and training over them
(``torch.distributed``), the counterpart of ``ctgan_tpu/parallel``."""

from .mesh import (
    DEFAULT_RULES,
    Mesh,
    data_sharding,
    effective_param_specs,
    local_rows,
    make_mesh,
    param_spec,
    replicated,
    shard_batch,
    shard_params,
)
from .spmd import (
    SpmdHooks,
    data_parallel,
    fetch_full_params,
    fetch_full_state,
    make_hooks,
    make_spmd_trainer,
    shard_state,
)

__all__ = [
    "DEFAULT_RULES", "data_sharding", "effective_param_specs", "make_mesh",
    "param_spec", "replicated", "shard_batch", "shard_params",
    "SpmdHooks", "fetch_full_params", "make_spmd_trainer",
    "Mesh", "data_parallel", "fetch_full_state", "local_rows", "make_hooks", "shard_state",
]
