"""Mesh / fleet parallelism layer (the scenario-parallel scaling axis, SURVEY §2.3).

Public surface re-exported here so users can write::

    from libmpc_tpu.parallel import make_mesh, LMPCFleet
"""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    init_distributed,
    make_mesh,
    replicated,
    shard_batch,
)
from .fleet import FleetStats, LMPCFleet, NLMPCFleet  # noqa: F401
from .qp_sharded import ShardedQPSolution, solve_sharded  # noqa: F401

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "FleetStats",
    "LMPCFleet",
    "NLMPCFleet",
    "ShardedQPSolution",
    "batch_sharding",
    "init_distributed",
    "make_mesh",
    "replicated",
    "shard_batch",
    "solve_sharded",
]
