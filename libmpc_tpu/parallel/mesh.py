"""Device-mesh utilities.

The reference is single-process/single-thread (SURVEY §2.3); scaling there
means "run more controller objects".  Here the scaling axis is the *batch of
problem instances*: a fleet of MPC problems is sharded over a
``jax.sharding.Mesh`` and solved in lockstep, with ``psum``/``pmax``
collectives for fleet-level reductions.  This module holds the
mesh/axis conventions shared by the fleet solvers.

Axes:

* ``data`` — scenario/batch parallelism (the DP analog; each device solves
  its slice of the fleet independently, collectives only aggregate stats).
* ``model`` — optional within-problem parallelism: the ADMM kernel's
  constraint-row dimension can be sharded over this axis for very large QPs
  (the TP analog).  Most MPC problems fit one chip and use ``model=1``.

Multi-host: call :func:`init_distributed` once per process before building
meshes; ``jax.devices()`` then spans all hosts and the same code scales from
one device to many hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX (no-op on a single process).

    Wraps ``jax.distributed.initialize``; managed cluster environments
    detect the arguments, elsewhere pass the coordinator's address, the
    process count and this process's id.
    """
    try:
        jax.distributed.initialize(coordinator_address, num_processes, process_id)
    except (RuntimeError, ValueError):
        # already initialized or single-process environment
        pass


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(data, model)`` mesh over the available devices.

    ``data`` defaults to ``len(devices) // model``.  Devices fill the grid
    in order; the cards of one host reach each other at the same rate
    (NVLink, all to all), so the mesh follows the algorithm only.
    """
    devices = list(devices if devices is not None else jax.devices())
    if data is None:
        data = len(devices) // model
    if data * model > len(devices):
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices, "
            f"have {len(devices)}"
        )
    grid = np.array(devices[: data * model]).reshape(data, model)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding that splits a leading batch axis over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree):
    """Place a pytree of batched arrays with the batch axis split over
    ``data`` (host arrays become globally-sharded jax.Arrays)."""
    sh = batch_sharding(mesh)
    return jax.tree.map(lambda a: jax.device_put(a, sh), tree)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k
