"""libmpc-tpu: a batched, accelerator-native Model Predictive Control framework.

A from-scratch JAX/XLA re-design with the capabilities of libmpc++
(nicolapiccinelli/libmpc): linear MPC over a sparse simultaneous QP solved by
a batched OSQP-equivalent ADMM kernel, and nonlinear MPC over a simultaneous
NLP solved by an SQP loop with exact autodiff derivatives.  One controller
object can solve thousands of scenario instances per step on a GPU, or on a
mesh of them.
"""

from .dims import LDims, NLDims
from .lmpc.controller import LMPC
from .types import (
    ConstraintsType,
    HorizonSlice,
    LParameters,
    NLParameters,
    OptSequence,
    Parameters,
    Result,
    ResultStatus,
    inf,
)
from .utils.discretization import (
    discretization,
    discretization_with_disturbance,
    discretization_with_output,
)
from .utils.integrators import rk4, rk4_step
from .utils.logger import Logger, LogLevel, LogType
from .utils.profiler import Profiler, SolutionStats

__version__ = "0.5.0"

__all__ = [
    "LMPC",
    "NLMPC",
    "LDims",
    "NLDims",
    "HorizonSlice",
    "ResultStatus",
    "ConstraintsType",
    "Parameters",
    "LParameters",
    "NLParameters",
    "Result",
    "OptSequence",
    "Logger",
    "LogLevel",
    "LogType",
    "Profiler",
    "SolutionStats",
    "discretization",
    "discretization_with_disturbance",
    "discretization_with_output",
    "rk4",
    "rk4_step",
    "inf",
]


_LAZY = {
    "NLMPC": ("libmpc_tpu.nlmpc.controller", "NLMPC"),
    "LMPCFleet": ("libmpc_tpu.parallel.fleet", "LMPCFleet"),
    "NLMPCFleet": ("libmpc_tpu.parallel.fleet", "NLMPCFleet"),
    "FleetStats": ("libmpc_tpu.parallel.fleet", "FleetStats"),
    "make_mesh": ("libmpc_tpu.parallel.mesh", "make_mesh"),
    "init_distributed": ("libmpc_tpu.parallel.mesh", "init_distributed"),
    "solve_sharded": ("libmpc_tpu.parallel.qp_sharded", "solve_sharded"),
    "lmpc_rollout": ("libmpc_tpu.rollout", "lmpc_rollout"),
    "nlmpc_rollout": ("libmpc_tpu.rollout", "nlmpc_rollout"),
    "Rollout": ("libmpc_tpu.rollout", "Rollout"),
}

__all__ += list(_LAZY)


def __getattr__(name):
    # heavier subsystems import lazily so `import libmpc_tpu` stays light
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
