"""Several ranks or devices: process groups, the ('data', 'model') mesh of
ranks, the ddp / fsdp sharding rules and the sharded train state.

Counterpart of picopose_tpu/parallel/.  The JAX package shards one
global program over a device mesh and lets its compiler insert the
collectives; here each rank is a process with its own device, and the
collectives are explicit (parallel/collectives.py), placed so that a
sharded training step computes what the JAX package's computes: the loss
and gradient of the whole global batch.
"""

from picopose_tpu_torch.parallel.mesh import (
    Mesh,
    batch_rows,
    make_mesh,
    replicated,
    shard_batch,
)
from picopose_tpu_torch.parallel.shardings import (
    MODES,
    full_optimizer_state,
    full_state_dict,
    leaf_spec,
    shard_state,
    state_shardings,
)
