"""Nonlinear MPC controller front-end.

API-parity shell over the functional NLP core: setter surface and error
semantics mirror ``mpc::NLMPC`` (reference: include/mpc/NLMPC.hpp:54-418);
the solve path jits [warm-start shift -> SQP with exact autodiff derivatives
-> sequence unpack] into one device program, replacing the reference's
NLopt-SLSQP + finite-difference pipeline
(reference: include/mpc/NLMPC/NLOptimizer.hpp:412-638).

Batching: ``optimize`` accepts a leading batch axis on ``x0``/``last_u``;
the SQP (including its inner ADMM QPs) is vmapped across the fleet.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..dims import NLDims
from ..ops import sqp
from ..types import (
    HorizonSlice,
    NLParameters,
    OptSequence,
    Result,
    ResultStatus,
    default_dtype,
)
from ..utils import deadline
from ..utils.logger import Logger, LogLevel
from ..utils.profiler import Profiler, SolutionStats
from . import problem as nlp


def _status_from_nlopt(code):
    """nlopt result -> ResultStatus
    (reference: include/mpc/NLMPC/NLOptimizer.hpp:729-750)."""
    out = jnp.full(code.shape, int(ResultStatus.UNKNOWN), jnp.int32)
    for nl, rs in [
        (sqp.NLOPT_FAILURE, ResultStatus.ERROR),
        (sqp.NLOPT_ROUNDOFF_LIMITED, ResultStatus.ERROR),
        (sqp.NLOPT_SUCCESS, ResultStatus.SUCCESS),
        (sqp.NLOPT_STOPVAL_REACHED, ResultStatus.SUCCESS),
        (sqp.NLOPT_FTOL_REACHED, ResultStatus.SUCCESS),
        (sqp.NLOPT_XTOL_REACHED, ResultStatus.SUCCESS),
        (sqp.NLOPT_MAXEVAL_REACHED, ResultStatus.MAX_ITERATION),
        (sqp.NLOPT_MAXTIME_REACHED, ResultStatus.MAX_ITERATION),
    ]:
        out = jnp.where(code == nl, int(rs), out)
    return out


class NLMPC:
    """Nonlinear MPC (reference: include/mpc/NLMPC.hpp:30)::

        controller = NLMPC(nx=2, nu=1, ny=2, ph=10, ch=5, ineq=11, eq=0)

    User model callables are JAX-traceable, return-value style (like the
    reference's Python bindings, python/pybind_export.cpp:20-57)::

        controller.set_state_space_function(lambda x, u, k: dx)
        controller.set_objective_function(lambda X, Y, U, e: cost)
        controller.set_ineq_con_function(lambda X, Y, U, e: values)
        controller.set_eq_con_function(lambda X, U: values)
    """

    def __init__(self, nx, nu, ny, ph, ch, ineq, eq, dtype=None):
        self.dims = NLDims(nx, nu, ny, ph, ch, ineq, eq).validate()
        self.dtype = dtype or default_dtype()
        self._fns = nlp.NLFunctions()
        self._params = NLParameters()
        self._state_scaling = jnp.ones((nx,), self.dtype)
        self._input_scaling = jnp.ones((nu,), self.dtype)
        self._ineq_tol = 1e-10
        self._eq_tol = 1e-10
        nz = self.dims.nz
        self._lb = np.full(nz, -np.inf)
        self._ub = np.full(nz, np.inf)
        # the slack entry is pinned to zero under hard constraints
        # (reference: include/mpc/NLMPC/NLOptimizer.hpp:180-186); with soft
        # constraints it is released to [0, inf) — a deliberate fix of the
        # reference, which never un-pins it once set
        self._apply_slack_bounds()
        self._opt_vector: Optional[jax.Array] = None
        self._current_slack = 0.0
        self._first_iteration = True
        self._result = Result(
            cmd=jnp.zeros((nu,), self.dtype),
            cost=jnp.zeros((), self.dtype),
            status=jnp.asarray(int(ResultStatus.UNKNOWN), jnp.int32),
            solver_status=jnp.asarray(0, jnp.int32),
            is_feasible=jnp.asarray(False),
        )
        self._sequence = OptSequence(
            state=jnp.zeros((ph + 1, nx), self.dtype),
            output=jnp.zeros((ph + 1, ny), self.dtype),
            input=jnp.zeros((ph + 1, nu), self.dtype),
        )
        self._profiler = Profiler()
        self._stats_mode = "sync"  # see set_stats_mode
        # time_limit support: measured-cost iteration budget
        # (reference: NLMPC.hpp:142-144 -> nlopt set_maxtime)
        self._budgeter = deadline.IterationBudgeter()
        self._budget_key = None
        self._runtime_params = ()  # traced per-solve parameter pytree
        self._runtime_params_batched = False
        self._instance_bounds = None  # optional (B, nz) lb/ub override pair
        self._solve_fn = None  # compiled closure, invalidated by setters

    # ------------------------------------------------------------------
    # configuration surface (parity with NLMPC.hpp setters)
    # ------------------------------------------------------------------
    def set_logger_level(self, level: LogLevel) -> bool:
        Logger.instance().set_level(level)
        return True

    def set_logger_prefix(self, prefix: str) -> bool:
        Logger.instance().set_prefix(prefix)
        return True

    def set_discretization_sampling_time(self, ts: float) -> bool:
        """Marks the model continuous-time with trapezoidal defects
        (reference: include/mpc/NLMPC.hpp:80-90)."""
        self._fns = dataclasses.replace(self._fns, continuous=True, ts=float(ts))
        self._invalidate()
        return True

    def set_optimizer_parameters(self, params: NLParameters) -> None:
        if not isinstance(params, NLParameters):
            raise TypeError("NLMPC expects NLParameters")
        self._params = params
        self._apply_slack_bounds()
        self._invalidate()

    def _apply_slack_bounds(self):
        if self._params.hard_constraints:
            self._lb[-1] = 0.0
            self._ub[-1] = 0.0
        else:
            self._lb[-1] = 0.0
            self._ub[-1] = np.inf

    def set_instance_bounds(self, state=None, input=None) -> bool:
        """Per-instance hard box bounds for batched/fleet solves.

        ``state``/``input`` are optional ``(min, max)`` pairs of batched
        time-major arrays: state ``(B, ph, nx)`` (bounds on the decision
        states x_1..x_ph), input ``(B, ch, nu)`` (bounds on the blocked
        moves).  Unspecified parts inherit the shared bounds.  Packing
        matches the reference's decision layout
        (NLOptimizer.hpp:346-404); call with no arguments to clear.
        """
        if state is None and input is None:
            self._instance_bounds = None
            self._invalidate()
            return True
        dims = self.dims
        # determine the batch size from whichever pair is given
        ref = state if state is not None else input
        B = np.asarray(ref[0]).shape[0]
        lb = np.broadcast_to(self._lb, (B, dims.nz)).copy()
        ub = np.broadcast_to(self._ub, (B, dims.nz)).copy()
        if state is not None:
            mn, mx = (np.asarray(v, float) for v in state)
            if mn.shape[1:] != (dims.ph, dims.nx):
                raise ValueError(f"state bounds must be (B, {dims.ph}, {dims.nx})")
            lb[:, : dims.ph * dims.nx] = mn.reshape(B, -1)
            ub[:, : dims.ph * dims.nx] = mx.reshape(B, -1)
        if input is not None:
            mn, mx = (np.asarray(v, float) for v in input)
            if mn.shape[1:] != (dims.ch, dims.nu):
                raise ValueError(f"input bounds must be (B, {dims.ch}, {dims.nu})")
            off = dims.ph * dims.nx
            lb[:, off : off + dims.ch * dims.nu] = mn.reshape(B, -1)
            ub[:, off : off + dims.ch * dims.nu] = mx.reshape(B, -1)
        self._instance_bounds = (
            jnp.asarray(lb, self.dtype),
            jnp.asarray(ub, self.dtype),
        )
        self._invalidate()
        return True

    def set_runtime_params(self, params, batched: bool = False) -> None:
        """Set the runtime-parameter pytree passed (traced) to callbacks that
        declare a trailing ``p`` argument.  Changing the *values* costs no
        recompilation; changing the tree structure re-jits once.

        With ``batched=True`` every leaf carries a leading batch axis matched
        to the batch of ``optimize`` — per-instance scenario data (e.g. each
        instance its own obstacle set)."""
        if batched != self._runtime_params_batched:
            self._invalidate()
        self._runtime_params = params
        self._runtime_params_batched = batched

    def set_input_scale(self, scaling) -> None:
        """(reference: include/mpc/NLMPC.hpp:108-115)."""
        self._input_scaling = jnp.asarray(scaling, self.dtype).reshape(self.dims.nu)
        self._invalidate()

    def set_state_scale(self, scaling) -> None:
        """(reference: include/mpc/NLMPC.hpp:123-130)."""
        self._state_scaling = jnp.asarray(scaling, self.dtype).reshape(self.dims.nx)
        self._invalidate()

    def set_objective_function(self, handle: Callable) -> bool:
        """(reference: include/mpc/NLMPC.hpp:139-153)."""
        self._fns = dataclasses.replace(
            self._fns, objective_fn=nlp.canonicalize(handle, 4)
        )
        self._invalidate()
        return True

    def set_state_space_function(self, handle: Callable, eq_tol: float = 1e-10) -> bool:
        """(reference: include/mpc/NLMPC.hpp:165-193)."""
        self._fns = dataclasses.replace(
            self._fns, state_fn=nlp.canonicalize(handle, 3)
        )
        self._defect_tol = eq_tol
        self._invalidate()
        return True

    def set_output_function(self, handle: Callable) -> bool:
        """(reference: include/mpc/NLMPC.hpp:202-215)."""
        self._fns = dataclasses.replace(
            self._fns, output_fn=nlp.canonicalize(handle, 3)
        )
        self._invalidate()
        return True

    def set_ineq_con_function(self, handle: Callable, tol: float = 1e-10) -> bool:
        """Refuses when the ineq count is zero
        (reference: include/mpc/NLMPC.hpp:228-248)."""
        if self.dims.ineq == 0:
            Logger.instance().error(
                "The number of inequality constraints is zero, you cannot "
                "define a custom callback for the inequality constraints"
            )
            return False
        self._fns = dataclasses.replace(
            self._fns, ineq_fn=nlp.canonicalize(handle, 4)
        )
        self._ineq_tol = tol
        self._invalidate()
        return True

    def set_eq_con_function(self, handle: Callable, tol: float = 1e-10) -> bool:
        """Refuses when the eq count is zero
        (reference: include/mpc/NLMPC.hpp:261-281)."""
        if self.dims.eq == 0:
            Logger.instance().error(
                "The number of equality constraints is zero, you cannot "
                "define a custom callback for the equality constraints"
            )
            return False
        self._fns = dataclasses.replace(
            self._fns, eq_fn=nlp.canonicalize(handle, 2)
        )
        self._eq_tol = tol
        self._invalidate()
        return True

    # -- bounds (decision-space, like NLOptimizer.hpp:346-404) -----------
    def set_state_bounds(self, x_min, x_max, slice: Optional[HorizonSlice] = None) -> bool:
        x_min = np.asarray(x_min, float)
        x_max = np.asarray(x_max, float)
        if x_min.ndim == 2 and slice is None:
            ok = True
            for i in range(self.dims.ph):
                ok &= self.set_state_bounds(x_min[:, i], x_max[:, i], HorizonSlice(i, i + 1))
            return ok
        slice = slice if slice is not None else HorizonSlice.all()
        if not (slice.is_unset or self.is_prediction_horizon_slice_valid(slice)):
            return False
        start = 0 if slice.start == -1 else slice.start
        end = self.dims.ph if slice.end == -1 else slice.end
        nx = self.dims.nx
        for i in range(start, end):
            self._lb[i * nx : (i + 1) * nx] = x_min
            self._ub[i * nx : (i + 1) * nx] = x_max
        self._invalidate()
        return True

    def set_input_bounds(self, u_min, u_max, slice: Optional[HorizonSlice] = None) -> bool:
        u_min = np.asarray(u_min, float)
        u_max = np.asarray(u_max, float)
        if u_min.ndim == 2 and slice is None:
            ok = True
            for i in range(self.dims.ch):
                ok &= self.set_input_bounds(u_min[:, i], u_max[:, i], HorizonSlice(i, i + 1))
            return ok
        slice = slice if slice is not None else HorizonSlice.all()
        if not (slice.is_unset or self.is_control_horizon_slice_valid(slice)):
            return False
        start = 0 if slice.start == -1 else slice.start
        end = self.dims.ch if slice.end == -1 else slice.end
        nu, off = self.dims.nu, self.dims.ph * self.dims.nx
        for i in range(start, end):
            self._lb[off + i * nu : off + (i + 1) * nu] = u_min
            self._ub[off + i * nu : off + (i + 1) * nu] = u_max
        self._invalidate()
        return True

    def set_output_bounds(self, y_min, y_max, slice: Optional[HorizonSlice] = None) -> bool:
        """Output bounds are not available for NLMPC
        (reference: include/mpc/NLMPC.hpp:342-350)."""
        raise RuntimeError("Output constraints cannot be set for this type of MPC")

    # ------------------------------------------------------------------
    # solve
    # ------------------------------------------------------------------
    def _invalidate(self):
        self._solve_fn = None
        self._traj_plan = None, False  # (plan, probed?)
        self._budgeter.reset()  # new compiled program -> new calibration

    def _get_traj_plan(self):
        """Probe-once cache of the trajectory-structure plan
        (ops/trajectory_kkt.make_plan): enables the banded inner-QP engine
        when the NLP's sparsity is verified stage-local.  Invalidated by
        every setter that can change the structure."""
        plan, probed = getattr(self, "_traj_plan", (None, False))
        if probed:
            return plan
        from ..ops import trajectory_kkt

        p = self._runtime_params
        if self._runtime_params_batched and p is not None:
            # probe with a single instance's parameters
            p = jax.tree.map(lambda a: jnp.asarray(a)[0], p)
        plan = trajectory_kkt.make_plan(
            self.dims, self._fns, self._state_scaling, self._input_scaling,
            self._params.hessian_reg, self.dtype, p=p,
        )
        self._traj_plan = plan, True
        return plan

    def _make_solve_one(self, params_override: Optional[NLParameters] = None):
        """Single-instance solve closure (z_prev, use_prev, x0, u0, slack0)
        -> (sqp solution, X, U, Y, slack, feasible); the unit that vmap/
        shard_map scale over.  ``params_override`` builds the closure with
        different solver parameters over the same problem (the rollout's
        compacted rescue phase)."""
        dims = self.dims
        fns = self._fns
        ss, us = self._state_scaling, self._input_scaling
        params = params_override if params_override is not None else self._params
        ineq_tol = self._ineq_tol
        eq_tol = self._eq_tol

        if fns.state_fn is None or fns.objective_fn is None:
            raise RuntimeError(
                "NLMPC requires a state-space function and an objective "
                "function before optimize()"
            )
        traj_plan = self._get_traj_plan()

        def solve_one(z_prev, use_prev, x0, u0, slack0, p, lb, ub,
                      iter_budget=None):
            guess = nlp.initial_guess(dims, x0, u0, slack0, self.dtype)
            z = jnp.where(use_prev, z_prev, guess)
            z = nlp.fix_bounds(z, lb, ub)
            z = nlp.shift_warm_start(dims, z)
            z = z.at[-1].set(slack0)

            f_fn = lambda zz: nlp.objective(dims, fns, ss, us, zz, x0, p)
            ceq_parts = [lambda zz: nlp.state_defects(dims, fns, ss, us, zz, x0, p)]
            if fns.eq_fn is not None:
                ceq_parts.append(lambda zz: nlp.user_eq(dims, fns, ss, us, zz, x0, p))
            ceq_fn = lambda zz: jnp.concatenate([part(zz) for part in ceq_parts])
            cin_fn = (
                (lambda zz: nlp.user_ineq(dims, fns, ss, us, zz, x0, p))
                if fns.ineq_fn is not None
                else None
            )

            sol = sqp.sqp_solve(
                f_fn, ceq_fn, cin_fn, z, lb, ub, params,
                iter_budget=iter_budget, traj_plan=traj_plan,
            )

            X, U, slack = nlp.unwrap(dims, sol.z, x0, ss, us)
            Y = nlp.get_output(dims, fns, X, U, p)
            feas = nlp.is_feasible(dims, fns, ss, us, sol.z, x0, ineq_tol, eq_tol, p)
            return sol, X, U, Y, slack, feas

        return solve_one

    def _make_solve_stages(self):
        """The single-instance solve split into resumable stages so the
        batched path can compact stragglers: ``z_init`` (warm-start
        repair), ``begin`` (loop carry at iteration 0), ``chunk`` (run the
        SQP loop up to a traced iteration bound), ``finish`` (finalize
        statuses and unwrap sequences).  Chunking partitions the exact
        per-instance iteration sequence of :meth:`_make_solve_one`."""
        dims = self.dims
        fns = self._fns
        ss, us = self._state_scaling, self._input_scaling
        params = self._params
        ineq_tol = self._ineq_tol
        eq_tol = self._eq_tol
        traj_plan = self._get_traj_plan()

        def make_fns(x0, p):
            f_fn = lambda zz: nlp.objective(dims, fns, ss, us, zz, x0, p)
            ceq_parts = [
                lambda zz: nlp.state_defects(dims, fns, ss, us, zz, x0, p)
            ]
            if fns.eq_fn is not None:
                ceq_parts.append(
                    lambda zz: nlp.user_eq(dims, fns, ss, us, zz, x0, p)
                )
            ceq_fn = lambda zz: jnp.concatenate([part(zz) for part in ceq_parts])
            cin_fn = (
                (lambda zz: nlp.user_ineq(dims, fns, ss, us, zz, x0, p))
                if fns.ineq_fn is not None
                else None
            )
            return f_fn, ceq_fn, cin_fn

        def z_init(z_prev, use_prev, x0, u0, slack0, lb, ub):
            guess = nlp.initial_guess(dims, x0, u0, slack0, self.dtype)
            z = jnp.where(use_prev, z_prev, guess)
            z = nlp.fix_bounds(z, lb, ub)
            z = nlp.shift_warm_start(dims, z)
            return z.at[-1].set(slack0)

        def begin(z, x0, p, lb, ub):
            f_fn, ceq_fn, cin_fn = make_fns(x0, p)
            return sqp.sqp_solve(
                f_fn, ceq_fn, cin_fn, z, lb, ub, params,
                it_hi=jnp.asarray(0, jnp.int32), return_carry=True,
                traj_plan=traj_plan,
            )

        def chunk(carry, z, x0, p, lb, ub, budget, hi):
            f_fn, ceq_fn, cin_fn = make_fns(x0, p)
            return sqp.sqp_solve(
                f_fn, ceq_fn, cin_fn, z, lb, ub, params,
                iter_budget=budget, carry_in=carry, it_hi=hi,
                return_carry=True, traj_plan=traj_plan,
            )

        def finish(carry, z, x0, p, lb, ub, budget):
            f_fn, ceq_fn, cin_fn = make_fns(x0, p)
            sol = sqp.sqp_solve(
                f_fn, ceq_fn, cin_fn, z, lb, ub, params,
                iter_budget=budget, carry_in=carry,
                it_hi=jnp.asarray(0, jnp.int32), traj_plan=traj_plan,
            )
            X, U, slack = nlp.unwrap(dims, sol.z, x0, ss, us)
            Y = nlp.get_output(dims, fns, X, U, p)
            feas = nlp.is_feasible(
                dims, fns, ss, us, sol.z, x0, ineq_tol, eq_tol, p
            )
            return sol, X, U, Y, slack, feas

        return z_init, begin, chunk, finish

    def _pack_result(self, sol, X, U, Y, feas, prev_cmd):
        """Map raw SQP output to (Result, OptSequence) with the reference's
        failure semantics (NLOptimizer.hpp:613-624): keep the previous
        command, zero the sequences, cost=inf."""
        failed = (sol.status == sqp.NLOPT_FAILURE) | (
            sol.status == sqp.NLOPT_ROUNDOFF_LIMITED
        ) | ~jnp.all(jnp.isfinite(sol.z), axis=-1)
        cmd = U[..., 0, :]
        cmd = jnp.where(failed[..., None], prev_cmd, cmd)
        zero = failed[..., None, None]
        result = Result(
            cmd=cmd,
            cost=jnp.where(failed, jnp.inf, sol.obj),
            status=jnp.where(
                failed,
                int(ResultStatus.ERROR),
                _status_from_nlopt(sol.status),
            ).astype(jnp.int32),
            solver_status=jnp.where(failed, -1, sol.status).astype(jnp.int32),
            is_feasible=feas & ~failed,
        )
        seq = OptSequence(
            state=jnp.where(zero, 0.0, X),
            output=jnp.where(zero, 0.0, Y),
            input=jnp.where(zero, 0.0, U),
        )
        return result, seq

    def _bounds_args(self):
        """(lb, ub, batched?) for the current configuration."""
        if self._instance_bounds is not None:
            lb, ub = self._instance_bounds
            return lb, ub, True
        return (
            jnp.asarray(self._lb, self.dtype),
            jnp.asarray(self._ub, self.dtype),
            False,
        )

    def _build_solve_fn(self):
        solve_one = self._make_solve_one()
        z_init, begin, chunk, finish = self._make_solve_stages()
        params = self._params
        p_axis = 0 if self._runtime_params_batched else None
        b_axis = 0 if self._instance_bounds is not None else None

        _CHUNK = 4

        def solve_compacted(z_prev, use_prev, x0, u0, slack0, p, lb, ub,
                            iter_budget, cap):
            """Batched solve with straggler compaction: short full-batch
            chunks until the unconverged count falls to ``cap``, then
            gather those instances and finish only them (the slowest few
            no longer drag the whole batch through every SQP iteration —
            same per-instance iteration sequence either way)."""
            vz = jax.vmap(z_init, in_axes=(0, 0, 0, 0, 0, b_axis, b_axis))
            vbegin = jax.vmap(begin, in_axes=(0, 0, p_axis, b_axis, b_axis))
            vchunk = jax.vmap(
                chunk, in_axes=(0, 0, 0, p_axis, b_axis, b_axis, None, None)
            )
            vfinish = jax.vmap(
                finish, in_axes=(0, 0, 0, p_axis, b_axis, b_axis, None)
            )

            z = vz(z_prev, use_prev, x0, u0, slack0, lb, ub)
            carry0 = vbegin(z, x0, p, lb, ub)

            def ocond(st):
                carry, hi = st
                return (jnp.sum(carry.status == 0) > cap) & (
                    hi < params.maximum_iteration
                )

            def obody(st):
                carry, hi = st
                hi2 = hi + _CHUNK
                return vchunk(carry, z, x0, p, lb, ub, iter_budget, hi2), hi2

            carry, _hi = jax.lax.while_loop(
                ocond, obody, (carry0, jnp.asarray(0, jnp.int32))
            )

            def phase2(carry):
                # at outer exit every active instance beyond the first
                # `cap` has already exhausted maximum_iteration, so the
                # top-k gather covers all instances with work left
                _, idx = jax.lax.top_k(
                    (carry.status == 0).astype(jnp.float32), cap
                )
                take = lambda a: jnp.take(a, idx, axis=0)
                sub = jax.tree.map(take, carry)
                z_s, x0_s = take(z), take(x0)
                p_s = jax.tree.map(take, p) if p_axis == 0 else p
                lb_s = take(lb) if b_axis == 0 else lb
                ub_s = take(ub) if b_axis == 0 else ub
                sub = jax.vmap(
                    chunk,
                    in_axes=(0, 0, 0, p_axis, b_axis, b_axis, None, None),
                )(sub, z_s, x0_s, p_s, lb_s, ub_s, iter_budget,
                  jnp.asarray(params.maximum_iteration, jnp.int32))
                put = lambda a, b: a.at[idx].set(b)
                return jax.tree.map(put, carry, sub)

            need2 = jnp.any(
                (carry.status == 0) & (carry.it < params.maximum_iteration)
            )
            carry = jax.lax.cond(need2, phase2, lambda c: c, carry)
            return vfinish(carry, z, x0, p, lb, ub, iter_budget)

        @jax.jit
        def solve(z_prev, use_prev, x0, u0, slack0, prev_cmd, p, lb, ub,
                  iter_budget):
            batched = x0.ndim == 2
            B = x0.shape[0] if batched else 0
            compact = (
                batched
                and params.compact_stragglers
                and B >= 128
                and params.maximum_iteration > 2 * _CHUNK
            )
            if compact:
                # cap at ~B/4, a multiple of 128 instances
                cap = max(128, (B // 4 // 128) * 128)
                compact = cap < B
            if compact:
                sol, X, U, Y, slack, feas = solve_compacted(
                    z_prev, use_prev, x0, u0, slack0, p, lb, ub,
                    iter_budget, cap,
                )
            else:
                fn = (
                    jax.vmap(
                        solve_one,
                        in_axes=(0, 0, 0, 0, 0, p_axis, b_axis, b_axis,
                                 None),
                    )
                    if batched
                    else solve_one
                )
                sol, X, U, Y, slack, feas = fn(
                    z_prev, use_prev, x0, u0, slack0, p, lb, ub, iter_budget
                )
            result, seq = self._pack_result(sol, X, U, Y, feas, prev_cmd)
            return result, seq, sol.z, slack, sol.iters

        return solve

    def optimize(self, x0, last_u) -> Result:
        """Compute the optimal control action
        (reference: include/mpc/IMPC.hpp:149-166 + NLOptimizer.hpp:412-638).

        ``x0``/``last_u`` may carry one leading batch axis.
        """
        if self._solve_fn is None:
            self._solve_fn = self._build_solve_fn()
        x0 = jnp.asarray(x0, self.dtype)
        last_u = jnp.asarray(last_u, self.dtype)
        batch = x0.shape[:-1]
        if self._instance_bounds is not None:
            B = self._instance_bounds[0].shape[0]
            if batch != (B,):
                raise ValueError(
                    f"per-instance bounds are set for batch {B}; optimize() "
                    f"got batch shape {batch}"
                )

        use_prev = (
            not self._first_iteration
            and self._params.enable_warm_start
            and self._opt_vector is not None
            and self._opt_vector.shape[:-1] == batch
        )
        # per-lane warm flag: under cold_restart_on_failure, lanes whose
        # previous solve FAILED re-enter from the cold initial guess (see
        # NLParameters.cold_restart_on_failure)
        use_arr = jnp.broadcast_to(jnp.asarray(use_prev), batch)
        if (
            use_prev
            and self._params.cold_restart_on_failure
            and self._result.status.shape == batch
        ):
            use_arr = use_arr & (
                self._result.status != int(ResultStatus.ERROR)
            )
        z_prev = (
            self._opt_vector
            if use_prev
            else jnp.zeros(batch + (self.dims.nz,), self.dtype)
        )
        slack0 = jnp.broadcast_to(
            jnp.asarray(self._current_slack, self.dtype), batch
        ) if batch else jnp.asarray(self._current_slack, self.dtype)
        prev_cmd = (
            self._result.cmd
            if self._result.cmd.shape[:-1] == batch
            else jnp.zeros(batch + (self.dims.nu,), self.dtype)
        )

        # time_limit -> traced iteration budget (measured per-iteration cost)
        if self._budget_key != batch:
            self._budgeter.reset()
            self._budget_key = batch
        iter_budget = self._budgeter.budget(self._params.time_limit)

        # DETAIL-level dump of constraint values and exact Jacobians at the
        # solve's entry point, mirroring the reference's per-evaluation dumps
        # (reference: include/mpc/NLMPC/Constraints.hpp:294-313, :333-353)
        if Logger.instance().level == LogLevel.DEEP and x0.ndim == 1:
            self._dump_constraint_details(x0, last_u)

        self._profiler.solution_start()
        t0 = _time.monotonic()
        lb, ub, _ = self._bounds_args()
        result, seq, z_out, slack, iters = self._solve_fn(
            z_prev, use_arr, x0, last_u, slack0, prev_cmd,
            self._runtime_params, lb, ub, jnp.asarray(iter_budget, jnp.int32),
        )
        # "sync" stats: block for the device result so profiler/budgeter see
        # true per-solve latency (one round trip + one stacked readback).
        # "lazy" stats: return immediately after dispatch — on a
        # high-latency transport each synchronization costs milliseconds;
        # statuses are resolved in one batched transfer when stats are read.
        # time_limit calibration and verbose summaries need the sync path.
        sync = (
            self._stats_mode == "sync"
            or self._params.time_limit > 0
            or self._params.verbose
        )
        if sync:
            jax.block_until_ready(result.cmd)
            elapsed = _time.monotonic() - t0
            vals = np.asarray(
                jnp.stack([jnp.max(iters), jnp.max(result.status)])
            )
            iters_max, status_val = int(vals[0]), int(vals[1])
            self._budgeter.record(elapsed, iters_max)
            # populate the host-side status message like the reference's
            # exception reporting (NLOptimizer.hpp:550-571)
            if status_val == int(ResultStatus.ERROR):
                result = dataclasses.replace(
                    result,
                    solver_status_msg=(
                        "Internal solver error: line search could not make "
                        "progress (roundoff limited)"
                    ),
                )
        self._opt_vector = z_out
        self._current_slack = slack
        self._first_iteration = False
        self._result, self._sequence = result, seq
        self._last_iters = iters
        if sync:
            self._profiler.solution_end(result, status_max=status_val)
        else:
            self._profiler.solution_end(result, lazy=True)
        if self._params.verbose:
            it = np.asarray(iters)
            Logger.instance().info(
                f"SQP iterations: mean {it.mean():.1f}, max {int(it.max())}"
            )
        return result

    def _dump_constraint_details(self, x0, last_u) -> None:
        """DETAIL dumps of defect/user-constraint values and their exact
        Jacobians at the cold-start point (reference wording:
        Constraints.hpp:294-313 for user ineq, :333-353 for state eq)."""
        dims, fns = self.dims, self._fns
        ss, us = self._state_scaling, self._input_scaling
        p = self._runtime_params
        z = nlp.initial_guess(dims, x0, last_u, jnp.asarray(0.0, self.dtype),
                              self.dtype)
        log = Logger.instance()
        fmt = lambda a: np.array2string(
            np.asarray(a), precision=10, threshold=200
        )
        defects = lambda zz: nlp.state_defects(dims, fns, ss, us, zz, x0, p)
        log.detail(f"State equality constraints value:\n{fmt(defects(z))}")
        log.detail(
            "State equality constraints jacobian:\n"
            f"{fmt(jax.jacfwd(defects)(z))}"
        )
        if fns.ineq_fn is not None:
            ineq = lambda zz: nlp.user_ineq(dims, fns, ss, us, zz, x0, p)
            log.detail(f"User inequality constraints value:\n{fmt(ineq(z))}")
            log.detail(
                "User inequality constraints jacobian:\n"
                f"{fmt(jax.jacfwd(ineq)(z))}"
            )
        if fns.eq_fn is not None:
            eq = lambda zz: nlp.user_eq(dims, fns, ss, us, zz, x0, p)
            log.detail(f"User equality constraints value:\n{fmt(eq(z))}")
            log.detail(
                "User equality constraints jacobian:\n"
                f"{fmt(jax.jacfwd(eq)(z))}"
            )

    def get_last_result(self) -> Result:
        return self._result

    def get_optimal_sequence(self) -> OptSequence:
        return self._sequence

    def get_execution_stats(self) -> SolutionStats:
        return self._profiler.get_stats()

    def reset_stats(self) -> None:
        self._profiler.reset()

    def set_stats_mode(self, mode: str) -> None:
        """extension beyond the reference: per-solve stats synchronization policy.

        ``"sync"`` (default) blocks on the device result inside each
        ``optimize`` so the profiler records true per-solve latency —
        matching the reference, whose solves are synchronous by nature.
        ``"lazy"`` returns as soon as the solve is dispatched: solves
        pipeline on the device with no host round trip per step, statuses
        are resolved in one batched transfer when stats are read, and the
        recorded times reflect host dispatch latency only.  Ignored (forced
        sync) while ``time_limit`` or ``verbose`` are active.
        """
        if mode not in ("sync", "lazy"):
            raise ValueError(f"stats mode must be 'sync' or 'lazy', got {mode!r}")
        self._stats_mode = mode

    # -- checkpoint / resume ---------------------------------------------
    def save_state(self, path: str) -> None:
        """Snapshot warm-start state + last command to ``path`` (.npz)."""
        from ..utils import checkpoint

        checkpoint.save_nlmpc(self, path)

    def load_state(self, path: str) -> None:
        from ..utils import checkpoint

        checkpoint.load_nlmpc(self, path)

    # -- slice validation (reference: include/mpc/IMPC.hpp:244-283) -------
    def is_slice_unset(self, slice: HorizonSlice) -> bool:
        return slice.is_unset

    def is_prediction_horizon_slice_valid(self, slice: HorizonSlice) -> bool:
        return not (
            slice.start >= slice.end
            or slice.start > self.dims.ph
            or slice.end > self.dims.ph
        )

    def is_control_horizon_slice_valid(self, slice: HorizonSlice) -> bool:
        return not (
            slice.start >= slice.end
            or slice.start > self.dims.ch
            or slice.end > self.dims.ch
        )

    # -- test hooks ------------------------------------------------------
    def get_lower_bound(self) -> np.ndarray:
        """(reference: include/mpc/NLMPC/NLOptimizer.hpp:645-648)."""
        return self._lb.copy()

    def get_upper_bound(self) -> np.ndarray:
        """(reference: include/mpc/NLMPC/NLOptimizer.hpp:655-658)."""
        return self._ub.copy()
