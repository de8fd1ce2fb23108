"""Model-parallel (row-sharded) ADMM for large QPs.

The scenario/data axis is the primary scaling dimension for MPC fleets
(SURVEY §2.3), but very large single problems — long horizons, plant-wide
MPC with thousands of constraint rows — can outgrow one chip.  This wrapper
shards the *constraint-row* dimension of ``A``/``z``/``y``/``l``/``u`` over
the mesh's ``model`` axis (the tensor-parallel analog) and runs the SAME
full-featured kernel as the single-chip path (``ops/admm.py`` with
``axis_rows`` set): Ruiz equilibration, per-row rho, adaptive rho,
primal/dual infeasibility certificates and active-set polish all operate on
the sharded rows — psum for cross-space contractions, pmax for row-space
norms.

Composable with the data axis: inputs may carry a batch dimension sharded
over ``data`` while rows shard over ``model`` — one ``shard_map`` over the
2D mesh runs fleet x row parallelism together, and the batch-global solver
statistics (adaptive-rho estimate, Ruiz cost scaling, loop exit) reduce over
``data`` so the sharded fleet solves exactly like an unsharded batch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..types import LParameters
from . import mesh as mesh_lib
from ..ops import admm


@functools.lru_cache(maxsize=None)
def _sharded_solve_fn(mesh: Mesh, params: LParameters, have_warm: bool):
    """Build (once per mesh/params/warm-mode) the jitted shard_map solver.

    Hoisting the shard_map + jit out of :func:`solve_sharded` means repeated
    calls with the same configuration reuse ONE compiled program instead of
    rebuilding (and retracing) a fresh closure per invocation — jit keeps
    its own per-shape cache on the returned callable, so only genuinely new
    shapes compile.  ``Mesh`` and ``LParameters`` are both hashable.
    """
    data, model = mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS
    axis_batch = data if mesh.shape[data] > 1 else None

    def body(P_mat, A_loc, q_loc, l_loc, u_loc, eq_loc, wx, wy):
        sol = admm.admm_solve(
            P_mat, A_loc, q_loc, l_loc, u_loc, params,
            warm_x=wx if have_warm else None,
            warm_y=wy if have_warm else None,
            eq_mask=eq_loc,
            axis_rows=model,
            axis_batch=axis_batch,
        )
        # obj uses the replicated x and the full q (local q is already the
        # full x-space row, only constraint rows shard) — nothing to reduce
        return sol

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(),  # P replicated
            P(model, None),  # A rows sharded
            P(data, None),  # q batch sharded
            P(data, model),  # l
            P(data, model),  # u
            P(model),  # eq mask rows
            P(data, None),  # warm x
            P(data, model),  # warm y
        ),
        out_specs=admm.QPSolution(
            x=P(data, None),
            y=P(data, model),
            z=P(data, model),
            status=P(data),
            iters=P(data),
            obj_val=P(data),
            pri_res=P(data),
            dua_res=P(data),
        ),
        check_vma=False,
    )
    return jax.jit(sharded)


class ShardedQPSolution(NamedTuple):
    x: jax.Array  # (B, n)
    y: jax.Array  # (B, m) (unpadded)
    iters: jax.Array  # (B,)
    status: jax.Array  # (B,) OSQP status values
    obj_val: jax.Array  # (B,)
    pri_res: jax.Array  # (B,)
    dua_res: jax.Array  # (B,)


def solve_sharded(
    P_mat: jax.Array,
    A: jax.Array,
    q: jax.Array,
    l: jax.Array,
    u: jax.Array,
    mesh: Mesh,
    params: LParameters = LParameters(),
    eq_mask: Optional[jax.Array] = None,
    warm_x: Optional[jax.Array] = None,
    warm_y: Optional[jax.Array] = None,
) -> ShardedQPSolution:
    """Solve a batch of QPs with constraint rows sharded over ``model`` and
    the batch sharded over ``data`` — full solver-feature parity with
    :func:`libmpc_tpu.ops.admm.admm_solve`.

    Shapes: P (n, n); A (m, n); q (B, n); l/u (B, m).  B must divide the
    data-axis size; rows are zero-padded to a multiple of the model-axis
    size (pad rows are unconstrained and never active).
    """
    n_model = mesh.shape[mesh_lib.MODEL_AXIS]
    n_data = mesh.shape[mesh_lib.DATA_AXIS]
    B, n = q.shape
    m = A.shape[0]
    dtype = P_mat.dtype
    if B % n_data:
        raise ValueError(f"batch {B} must divide over data axis {n_data}")

    if eq_mask is None:
        eq_mask = jnp.all((l == u) & jnp.isfinite(l), axis=0)

    # pad rows to a multiple of the model axis with unconstrained zero rows
    # (the kernel's loose-row handling gives them rho_min; Ruiz's
    # limit_scaling keeps their scaling at 1)
    m_pad = mesh_lib.pad_to_multiple(m, n_model)
    if m_pad != m:
        pad = m_pad - m
        A = jnp.concatenate([A, jnp.zeros((pad, n), dtype)], axis=0)
        l = jnp.concatenate([l, jnp.full((B, pad), -jnp.inf, dtype)], axis=1)
        u = jnp.concatenate([u, jnp.full((B, pad), jnp.inf, dtype)], axis=1)
        eq_mask = jnp.concatenate([eq_mask, jnp.zeros((pad,), bool)])
    have_warm = warm_x is not None
    if not have_warm:
        warm_x = jnp.zeros((B, n), dtype)
        warm_y = jnp.zeros((B, m_pad), dtype)
    elif warm_y is None:
        # primal-only warm start: default the duals to zero like
        # ops/admm.py does (None would break the shard_map spec match)
        warm_y = jnp.zeros((B, m_pad), dtype)
    elif warm_y.shape[-1] == m:
        warm_y = jnp.concatenate(
            [warm_y, jnp.zeros((B, m_pad - m), dtype)], axis=1
        )

    use_params = params if (params.enable_warm_start or not have_warm) else (
        # warm vectors supplied explicitly -> honor them
        __import__("dataclasses").replace(params, enable_warm_start=True)
    )

    sol = _sharded_solve_fn(mesh, use_params, have_warm)(
        P_mat, A, q, l, u, eq_mask, warm_x, warm_y
    )
    return ShardedQPSolution(
        x=sol.x,
        y=sol.y[:, :m],
        iters=sol.iters,
        status=sol.status,
        obj_val=sol.obj_val,
        pri_res=sol.pri_res,
        dua_res=sol.dua_res,
    )
