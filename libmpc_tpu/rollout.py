"""On-device closed-loop rollouts.

The reference's application pattern is a host loop
(``r = controller.optimize(x, r.cmd); x = plant(x, r.cmd)`` —
examples/vanderpol_ex.cpp:76-85).  On an accelerator that costs a
host-device round trip per control step.  This module jits the *entire*
closed loop — solver and plant — into one ``lax.scan``, so an N-step,
B-instance simulation is a single device program: the way to run
scenario studies, Monte-Carlo evaluations and controller tuning sweeps.

The plant is any JAX-traceable ``plant_fn(x, u, k) -> x_next`` (use the
controller's own model for nominal rollouts, or a higher-fidelity /
perturbed simulator for robustness studies).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .lmpc import controller as lmpc_mod
from .ops import sqp as sqp_mod
from .types import Result


class Rollout(NamedTuple):
    """Closed-loop trajectories; leading batch axes follow the inputs."""

    states: jax.Array  # (..., n_steps+1, nx) — includes the initial state
    inputs: jax.Array  # (..., n_steps, nu) — applied commands
    costs: jax.Array  # (..., n_steps)
    statuses: jax.Array  # (..., n_steps) int32 ResultStatus values
    iterations: jax.Array  # (..., n_steps) solver iterations per step


def _runner_cache(controller) -> dict:
    """Per-controller cache of compiled rollout programs.

    The runner closures capture only hashable configuration (dims, params,
    plant_fn, batch shape); all array state flows through arguments, so a
    cached runner stays valid across setter calls — jit itself retraces on
    shape changes.  Without this every ``lmpc_rollout``/``nlmpc_rollout``
    call would build (and recompile) a fresh closure.
    """
    cache = getattr(controller, "_rollout_runner_cache", None)
    if cache is None:
        cache = {}
        controller._rollout_runner_cache = cache
    return cache


@functools.lru_cache(maxsize=None)
def _lmpc_runner(dims, params, dtype, plant_fn, batch, n_steps):
    @functools.partial(jax.jit, static_argnames=())
    def run(prob, built, y_ref, u_ref, du_ref, u_meas, x0, u0):
        warm_x = jnp.zeros(batch + (dims.nz,), dtype)
        warm_y = jnp.zeros(batch + (dims.m,), dtype)

        def step(carry, k):
            x, u, wx, wy, hw = carry
            result, seq, sol_x, sol_y, iters = lmpc_mod.solve_body(
                dims, params, prob, x, u, y_ref, u_ref, du_ref, u_meas,
                wx, wy, hw, u, None, built,
            )
            x_next = plant_fn(x, result.cmd, k)
            out = (x, result.cmd, result.cost, result.status, iters)
            return (x_next, result.cmd, sol_x, sol_y, jnp.asarray(True)), out

        (x_fin, *_), (xs, us, costs, sts, its) = jax.lax.scan(
            step, (x0, u0, warm_x, warm_y, jnp.asarray(False)),
            jnp.arange(n_steps),
        )
        return x_fin, xs, us, costs, sts, its

    return run


def lmpc_rollout(controller, plant_fn: Callable, x0, last_u, n_steps: int) -> Rollout:
    """Run ``n_steps`` closed-loop LMPC steps fully on device.

    ``x0``/``last_u`` may carry a leading batch axis; warm starting follows
    the controller's ``enable_warm_start`` parameter and is carried through
    the scan.  Repeated calls with the same (plant, horizon, batch shape)
    reuse one compiled program.
    """
    c = controller
    x0 = jnp.asarray(x0, c.dtype)
    last_u = jnp.asarray(last_u, c.dtype)
    batch = x0.shape[:-1]
    run = _lmpc_runner(c.dims, c._params, c.dtype, plant_fn, batch, n_steps)

    # the time-invariant work (assembly, Ruiz, KKT inverse) is hoisted out
    # of the scanned step entirely — one setup for the whole rollout
    x_fin, xs, us, costs, sts, its = run(
        c._prob, c._ensure_built(), c._y_ref, c._u_ref, c._du_ref, c._u_meas,
        x0, last_u
    )
    return _pack(x_fin, xs, us, costs, sts, its, batch)


def nlmpc_rollout(controller, plant_fn: Callable, x0, last_u, n_steps: int,
                  params_fn: Callable = None,
                  chunk_steps: int = 0) -> Rollout:
    """Run ``n_steps`` closed-loop NLMPC steps fully on device.

    The receding-horizon warm start (shifted previous solution + carried
    slack) lives in the scan carry, exactly like the reference carries
    ``opt_vector`` across optimize calls (NLOptimizer.hpp:426-510).

    ``params_fn(x, k) -> p`` optionally recomputes the runtime-parameter
    pytree from the current (batched) plant state each step — the on-device
    analog of the reference's host loop updating captured data before every
    optimize (e.g. the UGV example's renormalized velocity reference,
    examples/ugv_ex.cpp:143-151).  Its output must match the structure set
    via ``set_runtime_params`` (batched when the rollout is batched).

    ``chunk_steps`` splits the loop into device programs of at most that
    many steps, chained at the host with the full warm-start carry (the
    per-instance solve sequence is identical — chunking only partitions
    the scan).  A trailing remainder (``n_steps`` not a multiple) runs as
    one shorter final program.  Use it to hand results back to the host
    during very long loops; chunking also bounds device-side run-ahead.
    """
    c = controller
    dims = c.dims
    x0 = jnp.asarray(x0, c.dtype)
    last_u = jnp.asarray(last_u, c.dtype)
    batch = x0.shape[:-1]
    rt = c._runtime_params
    lb, ub, b_batched = c._bounds_args()
    chunk = n_steps if chunk_steps <= 0 else min(chunk_steps, n_steps)
    cache = _runner_cache(c)

    def get_run(csize):
        key = ("nlmpc", plant_fn, params_fn, csize, batch, c._params, c._fns,
               b_batched, c._runtime_params_batched or params_fn is not None,
               id(c._state_scaling), id(c._input_scaling))
        run = cache.get(key)
        if run is not None:
            return run
        solve_one = c._make_solve_one()
        p_axis = 0 if (c._runtime_params_batched or
                       (params_fn is not None and batch)) else None
        b_axis = 0 if b_batched else None
        # per-lane warm flag: lets cold_restart_on_failure re-enter ONLY
        # the failed lanes from the cold initial guess next step
        solve = (
            jax.vmap(solve_one,
                     in_axes=(0, 0, 0, 0, 0, p_axis, b_axis, b_axis))
            if batch
            else solve_one
        )
        from .types import ResultStatus as _RS

        err_code = int(_RS.ERROR)
        restart = c._params.cold_restart_on_failure

        # compacted two-phase rescue (NLParameters.rescue_iters): gather
        # the lanes whose fast-phase solve FAILED and re-solve only those
        # from the same entry state at the deep IPM cap.  Skipped
        # entirely (scalar lax.cond) on steps with no failures, so the
        # deep cap costs compacted-batch time only where a lane needs it
        # — unlike per-lane cap escalation, which the lockstep batch pays
        # at full width.
        rescue_k = 0
        if c._params.rescue_iters > 0 and batch:
            # the rescue re-solves from the SAME entry state, so it only
            # helps when its parameters actually change the solve — i.e.
            # when the banded-KKT (riccati) engine is in use, whose
            # inner_iters cap the rescue deepens.  With any other engine the
            # rescue would be a deterministic repeat of the same failure, so
            # it is disabled with a warning instead of burning device time.
            p_ = c._params
            dims_ = c.dims
            engine = sqp_mod.inner_engine(
                p_, c.dtype, dims_.nz, dims_.ph * dims_.nx + dims_.eq,
                dims_.ineq, c._get_traj_plan(),
            )
            if engine == "riccati":
                B = batch[0]
                rescue_k = min(B, max(16, B // 16))
                import dataclasses as _dc

                rescue_params = _dc.replace(
                    p_, rescue_iters=0,
                    inner_iters=p_.rescue_iters,
                    inner_iters_recovery=p_.rescue_iters,
                )
                rescue_solve = jax.vmap(
                    c._make_solve_one(rescue_params),
                    in_axes=(0, 0, 0, 0, 0, p_axis, b_axis, b_axis),
                )
            else:
                from .utils.logger import Logger

                Logger.instance().info(
                    "rescue_iters > 0 has no effect with the current inner "
                    "engine (it deepens the banded-KKT IPM cap only); "
                    "rescue phase disabled for this rollout"
                )

        @jax.jit
        def run(x0, u0, z0, slack0, hw0, k0, p, lb, ub):
            def step(carry, k):
                x, u, z, slack, hw = carry
                pk = params_fn(x, k) if params_fn is not None else p
                sol, X, U, Y, slack_n, feas = solve(z, hw, x, u, slack, pk, lb, ub)
                result, seq = c._pack_result(sol, X, U, Y, feas, u)
                z_out, slack_out, iters_out = sol.z, slack_n, sol.iters

                if rescue_k:
                    failed = result.status == err_code

                    def _rescue(op):
                        res, z_o, sl_o, it_o = op
                        _, idx = jax.lax.top_k(
                            failed.astype(jnp.float32), rescue_k
                        )
                        take = lambda a: jnp.take(a, idx, axis=0)
                        pk_s = (
                            jax.tree.map(take, pk) if p_axis == 0 else pk
                        )
                        lb_s = take(lb) if b_axis == 0 else lb
                        ub_s = take(ub) if b_axis == 0 else ub
                        sol2, X2, U2, Y2, sl2, feas2 = rescue_solve(
                            take(z), take(hw), take(x), take(u),
                            take(slack), pk_s, lb_s, ub_s,
                        )
                        res2, _ = c._pack_result(
                            sol2, X2, U2, Y2, feas2, take(u)
                        )
                        # replace only lanes that actually failed AND whose
                        # rescue succeeded (top_k pads with healthy lanes;
                        # a rescue that also failed keeps the original
                        # hold-last-command result)
                        good = take(failed) & (res2.status != err_code)

                        def put(a, b):
                            old = jnp.take(a, idx, axis=0)
                            g = good.reshape(
                                good.shape + (1,) * (b.ndim - 1)
                            )
                            return a.at[idx].set(jnp.where(g, b, old))

                        res_m = Result(
                            cmd=put(res.cmd, res2.cmd),
                            cost=put(res.cost, res2.cost),
                            status=put(res.status, res2.status),
                            solver_status=put(
                                res.solver_status, res2.solver_status
                            ),
                            is_feasible=put(
                                res.is_feasible, res2.is_feasible
                            ),
                        )
                        it2 = jnp.take(it_o, idx, axis=0) + sol2.iters
                        return (
                            res_m,
                            put(z_o, sol2.z),
                            put(sl_o, sl2),
                            put(it_o, it2),
                        )

                    result, z_out, slack_out, iters_out = jax.lax.cond(
                        jnp.any(failed), _rescue, lambda op: op,
                        (result, z_out, slack_out, iters_out),
                    )

                x_next = plant_fn(x, result.cmd, k)
                out = (x, result.cmd, result.cost, result.status, iters_out)
                hw_n = (
                    result.status != err_code
                    if restart
                    else jnp.ones_like(hw)
                )
                return (x_next, result.cmd, z_out, slack_out, hw_n), out

            carry_fin, (xs, us, costs, sts, its) = jax.lax.scan(
                step, (x0, u0, z0, slack0, hw0), k0 + jnp.arange(csize)
            )
            return carry_fin, xs, us, costs, sts, its

        cache[key] = run
        return run

    # chain chunks at the host with the full warm-start carry; a ragged
    # final chunk compiles one extra (shorter) program
    carry = (
        x0, last_u,
        jnp.zeros(batch + (dims.nz,), c.dtype),
        jnp.zeros(batch, c.dtype),
        jnp.zeros(batch, bool),
    )
    pieces = []
    schedule = [chunk] * (n_steps // chunk)
    if n_steps % chunk:
        schedule.append(n_steps % chunk)
    k0 = 0
    for csize in schedule:
        carry, xs, us, costs, sts, its = get_run(csize)(
            *carry, jnp.asarray(k0, jnp.int32), rt, lb, ub
        )
        pieces.append((xs, us, costs, sts, its))
        k0 += csize
        if len(schedule) > 1:
            jax.block_until_ready(carry[0])
    x_fin = carry[0]
    xs, us, costs, sts, its = (
        jnp.concatenate([p[i] for p in pieces], axis=0) for i in range(5)
    )
    return _pack(x_fin, xs, us, costs, sts, its, batch)


def _pack(x_fin, xs, us, costs, sts, its, batch) -> Rollout:
    # scan stacks along axis 0; move the time axis after the batch axes
    def t_first_to_batch(a, extra=0):
        if batch:
            return jnp.moveaxis(a, 0, len(batch))
        return a

    states = jnp.concatenate(
        [t_first_to_batch(xs), x_fin[..., None, :]], axis=-2
    )
    return Rollout(
        states=states,
        inputs=t_first_to_batch(us),
        costs=t_first_to_batch(costs),
        statuses=t_first_to_batch(sts),
        iterations=t_first_to_batch(its),
    )
