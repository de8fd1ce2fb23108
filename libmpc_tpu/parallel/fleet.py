"""Scenario-parallel fleet solvers.

The headline capability (BASELINE.json): one controller configuration,
thousands of problem instances (initial states, references, disturbances)
solved in lockstep, sharded over a device mesh.  Each device solves its slice
of the fleet entirely on-chip — the only collectives are ``psum``/``pmax``
over the ``data`` axis to aggregate fleet-level statistics (the distributed
analog of the reference's per-controller ``SolutionStats``,
include/mpc/Profiler.hpp:88-120).

Multi-host: the same ``shard_map`` program runs unchanged across hosts
after ``mesh.init_distributed()``; batch shards stay on their devices and
the stats reductions cross the network only at the end of each step.
"""

from __future__ import annotations

import dataclasses
import time as _time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..dims import LDims
from ..lmpc import controller as lmpc_controller
from ..lmpc import problem as lmpc_problem
from ..types import ResultStatus
from ..utils import deadline
from . import mesh as mesh_lib


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FleetStats:
    """Fleet-level solve statistics, aggregated across the whole mesh."""

    n_total: jax.Array
    n_success: jax.Array
    n_max_iteration: jax.Array
    n_infeasible: jax.Array
    n_error: jax.Array
    # UNKNOWN covers the reference's residual statuses — notably LMPC
    # time-limit stops (OSQP_TIME_LIMIT_REACHED -> ResultStatus::UNKNOWN,
    # reference: include/mpc/LMPC/LOptimizer.hpp:406-407) — so the five
    # buckets always sum to n_total
    n_unknown: jax.Array
    mean_iterations: jax.Array
    max_iterations: jax.Array

    def __str__(self):
        pct = lambda n: 100.0 * float(n) / max(1, int(self.n_total))
        return (
            "Fleet stats:\n"
            f"  - instances: {int(self.n_total)}\n"
            f"  - SUCCESS: {pct(self.n_success):.2f}%\n"
            f"  - MAX_ITERATION: {pct(self.n_max_iteration):.2f}%\n"
            f"  - INFEASIBLE: {pct(self.n_infeasible):.2f}%\n"
            f"  - ERROR: {pct(self.n_error):.2f}%\n"
            f"  - UNKNOWN: {pct(self.n_unknown):.2f}%\n"
            f"  - iterations: mean {float(self.mean_iterations):.1f}, "
            f"max {int(self.max_iterations)}\n"
        )


def _local_stats(status, iters, axis: str) -> FleetStats:
    count = lambda s: jnp.sum(status == int(s)).astype(jnp.float32)
    n = jnp.asarray(status.shape[0], jnp.float32)
    stats = FleetStats(
        n_total=n,
        n_success=count(ResultStatus.SUCCESS),
        n_max_iteration=count(ResultStatus.MAX_ITERATION),
        n_infeasible=count(ResultStatus.INFEASIBLE),
        n_error=count(ResultStatus.ERROR),
        n_unknown=count(ResultStatus.UNKNOWN),
        mean_iterations=jnp.sum(iters.astype(jnp.float32)),
        max_iterations=jnp.max(iters),
    )
    # fleet-level reductions over the data axis
    summed = jax.tree.map(
        lambda a: jax.lax.psum(a, axis),
        dataclasses.replace(stats, max_iterations=jnp.asarray(0, jnp.int32)),
    )
    return dataclasses.replace(
        summed,
        mean_iterations=summed.mean_iterations / jnp.maximum(summed.n_total, 1.0),
        max_iterations=jax.lax.pmax(stats.max_iterations, axis),
    )


class LMPCFleet:
    """Mesh-sharded batched linear MPC.

    Wraps a configured :class:`~libmpc_tpu.lmpc.controller.LMPC` and solves a
    whole fleet per call::

        fleet = LMPCFleet(controller, mesh)          # mesh from make_mesh()
        result, stats = fleet.optimize(x0_batch, u_batch)

    Per-instance references/disturbances may be supplied as batched arrays;
    unbatched controller settings are replicated.  The batch size must divide
    evenly over the mesh's data axis.
    """

    def __init__(self, controller, mesh: Mesh):
        self.controller = controller
        self.mesh = mesh
        self.dims: LDims = controller.dims
        self._warm_x = None
        self._warm_y = None
        self._prev_cmd = None  # hold-last-command state, carried across steps
        self._budgeter = deadline.IterationBudgeter()
        self._budget_key = None
        self._step_fn = None
        self._step_key = None

    def _build(self, batched_refs: bool, prob_pattern, batched_bounds: bool):
        dims = self.dims
        params = self.controller._params
        axis = mesh_lib.DATA_AXIS
        ref_spec = P(axis) if batched_refs else P()
        # problem-data leaves with a leading batch axis (per-instance bounds)
        # shard over data; shared leaves replicate
        template = lmpc_problem.init_problem(dims, self.controller.dtype)
        prob_spec = jax.tree.map(
            lambda t, batched: P(axis) if batched else P(),
            template,
            prob_pattern,
        )
        # time-invariant cache: P/A and the PreparedQP replicate; the static
        # inequality bound vectors shard when per-instance bounds are set
        bnd_spec = P(axis) if batched_bounds else P()
        from ..ops import admm as admm_mod

        built_spec = (P(), P(), bnd_spec, bnd_spec,
                      admm_mod.PreparedQP(*([P()] * len(admm_mod.PreparedQP._fields))))

        def step(prob, built, x0, u0, y_ref, u_ref, du_ref, u_meas,
                 warm_x, warm_y, have_warm, prev_cmd, iter_budget):
            result, seq, sol_x, sol_y, iters = lmpc_controller.solve_body(
                dims, params, prob, x0, u0, y_ref, u_ref, du_ref, u_meas,
                warm_x, warm_y, have_warm, prev_cmd, iter_budget, built,
            )
            stats = _local_stats(result.status, iters, axis)
            return result, seq, sol_x, sol_y, stats

        sharded = jax.shard_map(
            step,
            mesh=self.mesh,
            in_specs=(
                prob_spec,  # problem data (bound leaves may shard over data)
                built_spec,  # hoisted time-invariant solver state
                P(axis), P(axis),  # x0, u0
                ref_spec, ref_spec, ref_spec, ref_spec,  # references
                P(axis), P(axis), P(), P(axis),  # warm state, flag, prev cmd
                P(),  # iteration budget (time_limit contract)
            ),
            out_specs=(P(axis), P(axis), P(axis), P(axis), P()),
            check_vma=False,
        )
        return jax.jit(sharded)

    def optimize(self, x0, last_u, y_ref=None, u_ref=None, du_ref=None,
                 u_meas=None):
        """Solve the fleet step; returns ``(Result, FleetStats)`` with all
        result leaves batched over the fleet."""
        c = self.controller
        x0 = jnp.asarray(x0, c.dtype)
        last_u = jnp.asarray(last_u, c.dtype)
        B = x0.shape[0]
        n_data = self.mesh.shape[mesh_lib.DATA_AXIS]
        if B % n_data:
            raise ValueError(f"batch {B} must divide over data axis {n_data}")

        batched_refs = y_ref is not None
        if batched_refs:
            y_ref = jnp.asarray(y_ref, c.dtype)
            u_ref = jnp.asarray(u_ref, c.dtype) if u_ref is not None else jnp.zeros(
                (B, self.dims.ph, self.dims.nu), c.dtype)
            du_ref = jnp.asarray(du_ref, c.dtype) if du_ref is not None else jnp.zeros(
                (B, self.dims.ph, self.dims.nu), c.dtype)
            u_meas = jnp.asarray(u_meas, c.dtype) if u_meas is not None else jnp.zeros(
                (B, self.dims.ph, self.dims.ndu), c.dtype)
        else:
            y_ref, u_ref, du_ref, u_meas = c._y_ref, c._u_ref, c._du_ref, c._u_meas

        template = lmpc_problem.init_problem(self.dims, c.dtype)
        prob_pattern = jax.tree.map(
            lambda t, leaf: leaf.ndim > t.ndim, template, c._prob
        )
        built = c._ensure_built()
        batched_bounds = built[2].ndim > 1  # lineq carries the fleet batch
        # params are in the key: the step closes over them as jit-static
        # settings, so a set_optimizer_parameters on the wrapped controller
        # must rebuild the fleet program too
        cache_key = (batched_refs, tuple(jax.tree.leaves(prob_pattern)),
                     batched_bounds, c._params)
        if self._step_fn is None or self._step_key != cache_key:
            self._step_fn = self._build(batched_refs, prob_pattern,
                                        batched_bounds)
            self._step_key = cache_key

        have_warm = (
            c._params.enable_warm_start
            and self._warm_x is not None
            and self._warm_x.shape[0] == B
        )
        warm_x = self._warm_x if have_warm else jnp.zeros((B, self.dims.nz), c.dtype)
        warm_y = self._warm_y if have_warm else jnp.zeros((B, self.dims.m), c.dtype)
        # hold-last-command across fleet steps: a failing instance keeps its
        # previous command rather than snapping to zero, mirroring the
        # single-controller path (reference: LOptimizer.hpp:349-361)
        prev_cmd = (
            self._prev_cmd
            if self._prev_cmd is not None and self._prev_cmd.shape == (B, self.dims.nu)
            else jnp.zeros((B, self.dims.nu), c.dtype)
        )

        # time_limit -> traced iteration budget, calibrated on fleet solves
        if self._budget_key != B:
            self._budgeter.reset()
            self._budget_key = B
        iter_budget = self._budgeter.budget(c._params.time_limit)

        t0 = _time.monotonic()
        result, seq, sol_x, sol_y, stats = self._step_fn(
            c._prob, built, x0, last_u, y_ref, u_ref, du_ref, u_meas,
            warm_x, warm_y, jnp.asarray(have_warm), prev_cmd,
            jnp.asarray(iter_budget, jnp.int32),
        )
        jax.block_until_ready(result.cmd)
        self._budgeter.record(
            _time.monotonic() - t0, int(np.max(np.asarray(stats.max_iterations)))
        )
        self._warm_x, self._warm_y = sol_x, sol_y
        self._prev_cmd = result.cmd
        return result, stats


class NLMPCFleet:
    """Mesh-sharded batched nonlinear MPC.

    Same pattern as :class:`LMPCFleet`: the controller's SQP solve is vmapped
    over the local shard and shard_mapped over the data axis.
    """

    def __init__(self, controller, mesh: Mesh):
        self.controller = controller
        self.mesh = mesh
        self._opt_vector = None
        self._slack = None
        self._prev_cmd = None  # hold-last-command state, carried across steps
        self._prev_status = None  # per-lane cold_restart_on_failure state
        self._budgeter = deadline.IterationBudgeter()
        self._budget_key = None
        self._step_fn = None
        self._step_key = None

    def _build(self):
        c = self.controller
        dims = c.dims
        axis = mesh_lib.DATA_AXIS
        solve_one = c._make_solve_one()

        p_axis = 0 if c._runtime_params_batched else None
        p_spec = P(axis) if c._runtime_params_batched else P()
        b_batched = c._instance_bounds is not None
        b_axis = 0 if b_batched else None
        b_spec = P(axis) if b_batched else P()

        def step(z_prev, use_prev, x0, u0, slack0, prev_cmd, p, lb, ub,
                 iter_budget):
            sol, X, U, Y, slack, feas = jax.vmap(
                solve_one,
                in_axes=(0, 0, 0, 0, 0, p_axis, b_axis, b_axis, None),
            )(z_prev, use_prev, x0, u0, slack0, p, lb, ub, iter_budget)
            result, seq = c._pack_result(sol, X, U, Y, feas, prev_cmd)
            stats = _local_stats(result.status, sol.iters, axis)
            return result, seq, sol.z, slack, stats

        sharded = jax.shard_map(
            step,
            mesh=self.mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
                      p_spec, b_spec, b_spec, P()),
            out_specs=(P(axis), P(axis), P(axis), P(axis), P()),
            check_vma=False,
        )
        return jax.jit(sharded)

    def optimize(self, x0, last_u):
        c = self.controller
        x0 = jnp.asarray(x0, c.dtype)
        last_u = jnp.asarray(last_u, c.dtype)
        B = x0.shape[0]
        n_data = self.mesh.shape[mesh_lib.DATA_AXIS]
        if B % n_data:
            raise ValueError(f"batch {B} must divide over data axis {n_data}")
        # rebuild when the wrapped controller is reconfigured: the step
        # closes over params, the user callables and the scaling vectors —
        # all jit-static from the fleet program's point of view
        cache_key = (
            c._params, c._fns, c._runtime_params_batched,
            c._instance_bounds is not None,
            id(c._state_scaling), id(c._input_scaling),
        )
        if self._step_fn is None or self._step_key != cache_key:
            self._step_fn = self._build()
            self._step_key = cache_key

        use_prev = (
            c._params.enable_warm_start
            and self._opt_vector is not None
            and self._opt_vector.shape[0] == B
        )
        z_prev = (
            self._opt_vector if use_prev else jnp.zeros((B, c.dims.nz), c.dtype)
        )
        slack0 = (
            self._slack if (use_prev and self._slack is not None)
            else jnp.zeros((B,), c.dtype)
        )
        # hold-last-command across fleet steps (reference:
        # NLOptimizer.hpp:613-624 keeps the previous command on failure)
        prev_cmd = (
            self._prev_cmd
            if self._prev_cmd is not None and self._prev_cmd.shape == (B, c.dims.nu)
            else jnp.zeros((B, c.dims.nu), c.dtype)
        )

        if self._budget_key != B:
            self._budgeter.reset()
            self._budget_key = B
        iter_budget = self._budgeter.budget(c._params.time_limit)

        # per-lane warm flag: under cold_restart_on_failure, lanes whose
        # previous solve FAILED re-enter from the cold initial guess
        use_arr = jnp.broadcast_to(jnp.asarray(use_prev), (B,))
        if (
            use_prev
            and c._params.cold_restart_on_failure
            and self._prev_status is not None
            and self._prev_status.shape == (B,)
        ):
            use_arr = use_arr & (
                self._prev_status != int(ResultStatus.ERROR)
            )

        t0 = _time.monotonic()
        lb, ub, _ = c._bounds_args()
        result, seq, z_out, slack, stats = self._step_fn(
            z_prev, use_arr, x0, last_u, slack0, prev_cmd,
            c._runtime_params, lb, ub, jnp.asarray(iter_budget, jnp.int32),
        )
        jax.block_until_ready(result.cmd)
        self._budgeter.record(
            _time.monotonic() - t0, int(np.max(np.asarray(stats.max_iterations)))
        )
        self._opt_vector, self._slack = z_out, slack
        self._prev_cmd = result.cmd
        self._prev_status = result.status
        return result, stats
