"""Batched OSQP-equivalent ADMM solver for box-constrained QPs.

Solves, for a *batch* of problem instances sharing one structure::

    minimize    1/2 z'Pz + q'z
    subject to  l <= Az <= u

This is the batched accelerator replacement for the OSQP v0.6.3 solver the reference
drives through ``osqp_setup``/``osqp_solve`` each control step
(reference: include/mpc/LMPC/LOptimizer.hpp:261-284).  Same algorithm family
(ADMM with rho-scaling, over-relaxation alpha, Ruiz equilibration, adaptive
rho, primal/dual infeasibility certificates, optional active-set polish) and
the same parameter/termination semantics, but redesigned for the hardware:

* ``P`` (n,n) and ``A`` (m,n) are *shared* across the batch; only
  ``q``/``l``/``u`` carry a leading batch axis.  The KKT matrix
  ``M = P + sigma*I + A' R A`` is factorized once per solve and explicitly
  inverted, so every ADMM iteration is three dense matmuls
  ``(B,n)x(n,n)/(n,m)`` — no sparse
  scatter/gather, no per-instance factorization.
* All instances iterate in lockstep with per-instance convergence masks
  (frozen once done); termination is checked every ``check_termination``
  iterations so the hot loop stays free of reductions.
* Heterogeneous-structure fleets are handled by ``vmap`` of this function
  (P/A then batch automatically); the homogeneous fast path never pays for
  that generality.

Status codes reuse OSQP's integer values so ``Result.solver_status`` is
directly comparable with the reference's
(reference: include/mpc/LMPC/LOptimizer.hpp:386-415).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import LParameters
from . import batched_linalg

# -- OSQP status values (osqp/include/constants.h of OSQP v0.6.3) -----------
OSQP_SOLVED = 1
OSQP_SOLVED_INACCURATE = 2
OSQP_PRIMAL_INFEASIBLE_INACCURATE = 3
OSQP_DUAL_INFEASIBLE_INACCURATE = 4
OSQP_MAX_ITER_REACHED = -2
OSQP_PRIMAL_INFEASIBLE = -3
OSQP_DUAL_INFEASIBLE = -4
OSQP_SIGINT = -5
OSQP_TIME_LIMIT_REACHED = -6
OSQP_NON_CVX = -7
OSQP_UNSOLVED = -10

# "no budget" sentinel for the traced iteration budget (time_limit support)
NO_BUDGET = 2**31 - 1

RHO_MIN = 1e-6
RHO_MAX = 1e6
RHO_EQ_OVER_RHO_INEQ = 1e3
ADAPTIVE_RHO_TOLERANCE = 5.0
INF_BOUND = 1e30  # OSQP's OSQP_INFTY cut-off for "infinite" bounds
# relaxation factor of the final approximate termination check: a
# max-iteration exit re-tests the last iterate with every tolerance
# multiplied by this and reports the *_INACCURATE statuses when only the
# relaxed test passes (reference: include/mpc/LMPC/LOptimizer.hpp:398-403)
INACCURATE_TOL_FACTOR = 100.0


class QPSolution(NamedTuple):
    """Solver output; every leaf has a leading batch axis."""

    x: jax.Array  # (B, n) primal
    y: jax.Array  # (B, m) dual
    z: jax.Array  # (B, m) constraint activity A x (projected)
    status: jax.Array  # (B,) int32, OSQP status values
    iters: jax.Array  # (B,) int32, iterations until this instance froze
    obj_val: jax.Array  # (B,)
    pri_res: jax.Array  # (B,) unscaled primal residual (inf-norm)
    dua_res: jax.Array  # (B,) unscaled dual residual (inf-norm)


def _inf_norm(v, axis=-1):
    return jnp.max(jnp.abs(v), axis=axis)


# -- distribution helpers ----------------------------------------------------
# The kernel is written once and runs in three layouts: single device
# (axis_rows=axis_batch=None), constraint rows sharded over a mesh axis
# (axis_rows="model": A/l/u/z/y hold the local row block, x-space quantities
# replicate, cross-space contractions psum, row-space norms pmax), and batch
# sharded over a data axis (axis_batch="data": only the *statistics* that are
# batch-global — the adaptive-rho estimate — reduce over it, so a sharded
# fleet makes the same rho decisions as the equivalent unsharded batch).


def _psum_rows(v, axis_rows):
    return jax.lax.psum(v, axis_rows) if axis_rows else v


def _pmax_rows(v, axis_rows):
    return jax.lax.pmax(v, axis_rows) if axis_rows else v


def _pall_rows(v, axis_rows):
    """all() across the row shards (v is a bool array already all-reduced
    locally)."""
    if not axis_rows:
        return v
    return jax.lax.psum(v.astype(jnp.int32), axis_rows) == jax.lax.psum(
        jnp.ones((), jnp.int32), axis_rows
    )


def _ruiz_equilibration(P, A, q_ref, iters: int, axis_rows=None):
    """Modified Ruiz equilibration of the KKT-stacked matrix (OSQP scaling.c).

    Returns diagonal scalings ``d`` (n,), ``e`` (m,) and cost scaling ``c``
    such that the scaled problem is ``(c d P d, c d q, e A d, e l, e u)``.
    ``q_ref`` is a representative linear term (batch max-abs) used only for
    the cost scaling; it does not affect the fixed point being computed.
    """
    n = P.shape[0]
    m = A.shape[0]
    dtype = P.dtype

    d = jnp.ones((n,), dtype)
    e = jnp.ones((m,), dtype)
    c = jnp.asarray(1.0, dtype)

    def limit(norm):
        # OSQP scaling.c limit_scaling: degenerate (near-zero) norms scale by
        # 1.0 — essential for structurally-zero rows (e.g. an unset scalar
        # constraint row), which would otherwise blow the scaling up by 1e6
        # per Ruiz sweep and overflow float32
        return jnp.where(norm < 1e-4, 1.0, jnp.minimum(norm, 1e4))

    def body(_, carry):
        d, e, c, P, A, q = carry
        # column inf-norms of the stacked [[P, A'], [A, 0]]; the A column
        # norms span all row shards
        col_norm_x = jnp.maximum(
            _inf_norm(P, axis=0), _pmax_rows(_inf_norm(A, axis=0), axis_rows)
        )
        col_norm_y = _inf_norm(A, axis=1)
        dd = 1.0 / jnp.sqrt(limit(col_norm_x))
        ee = 1.0 / jnp.sqrt(limit(col_norm_y))
        P = P * dd[None, :] * dd[:, None]
        A = A * ee[:, None] * dd[None, :]
        q = q * dd
        # cost normalization (OSQP: gamma = 1/max(mean colnorm P, ||q||inf))
        mean_col_p = jnp.mean(_inf_norm(P, axis=0))
        gamma = 1.0 / limit(jnp.maximum(mean_col_p, _inf_norm(q)))
        P = P * gamma
        q = q * gamma
        return d * dd, e * ee, c * gamma, P, A, q

    d, e, c, _, _, _ = jax.lax.fori_loop(
        0, iters, body, (d, e, c, P, A, q_ref), unroll=True
    )
    return d, e, c


class PreparedQP(NamedTuple):
    """Time-invariant solver state hoisted out of the per-step solve.

    The reference pays ``osqp_setup`` (scaling + KKT factorization) on every
    control step (reference: include/mpc/LMPC/LOptimizer.hpp:261); OSQP
    itself computes Ruiz scaling ONCE per workspace and keeps it across
    ``osqp_update_lin_cost``/``osqp_update_bounds`` calls.  ``prepare_qp``
    reproduces that setup-once semantics: controllers cache the result and
    re-solve each step with only the cheap q/l/u scaling in the hot path
    (SURVEY §3.2: "keeping P/A static on-device").
    """

    Ps: jax.Array  # (n, n) scaled quadratic cost
    As: jax.Array  # (m, n) scaled constraints
    d: jax.Array  # (n,) primal scaling
    e: jax.Array  # (m,) dual scaling
    c: jax.Array  # () cost scaling
    eq_mask: jax.Array  # (m,) structural equality rows
    loose_mask: jax.Array  # (m,) rows loose in every instance
    M0: jax.Array  # (n, n) KKT matrix at the initial rho
    Minv0: jax.Array  # (n, n) its explicit inverse
    Mpinv: Optional[jax.Array]  # (n, n) shared polish base inverse:
    # (P + delta I + delta^-1 Aeq' Aeq)^-1 on the UNSCALED problem — the
    # equality rows are active in every instance, so each instance's
    # active-set system is this matrix plus a low-rank term over its few
    # active inequality rows, handled exactly by a Woodbury correction.
    # None when the prepare-time params do not use the shared polish
    # (admm_solve recomputes it on the fly if later params do).
    Mpinv_lo: Optional[jax.Array]  # (n, n) double-single low word of Mpinv:
    # a plain float32 inverse of the ~1/delta^2-conditioned Mp carries
    # ~eps.kappa SYSTEMATIC error, which caps the polish refinement
    # contraction near 1; applying the (hi, lo) pair (two matmuls)
    # removes the systematic part (setup splits a float64 inverse into
    # the two float32 words)


def _rho_bounds(dtype, params):
    """float32 numerics: the reference's default rho/sigma (fine for OSQP's
    pivoted f64 LDL) make M nearly singular in single precision; floor them
    and refine the x-update instead."""
    f32 = dtype == jnp.float32
    sigma_v = max(params.sigma, 1e-5) if f32 else params.sigma
    rho_lo = 1e-3 if f32 else RHO_MIN
    rho_hi = 1e3 if f32 else RHO_MAX
    return sigma_v, rho_lo, rho_hi


def _rho_vec_of(rho, eq_mask, loose_mask):
    rv = jnp.where(eq_mask, RHO_EQ_OVER_RHO_INEQ * rho, rho)
    return jnp.where(loose_mask, RHO_MIN, rv)


def prepare_qp(P, A, q_ref, eq_mask, loose_mask, params: LParameters,
               axis_rows=None) -> PreparedQP:
    """One-time setup: Ruiz equilibration + initial KKT inverse.

    ``q_ref`` is a representative linear term used only for the cost scaling
    (OSQP computes it from the q present at ``osqp_setup`` and keeps it when
    q is later updated — the same stale-c semantics apply here).
    """
    with jax.default_matmul_precision("highest"):
        n = P.shape[0]
        m = A.shape[0]
        dtype = P.dtype
        if params.scaling_iters > 0:
            d, e, c = _ruiz_equilibration(
                P, A, q_ref, params.scaling_iters, axis_rows
            )
        else:
            d = jnp.ones((n,), dtype)
            e = jnp.ones((m,), dtype)
            c = jnp.asarray(1.0, dtype)
        Ps = c * (P * d[None, :] * d[:, None])
        As = A * e[:, None] * d[None, :]
        sigma_v, rho_lo, rho_hi = _rho_bounds(dtype, params)
        rho_init = jnp.clip(jnp.asarray(params.rho, dtype), rho_lo, rho_hi)
        M0, Minv0 = _build_kkt_inverse(
            Ps, As, _rho_vec_of(rho_init, eq_mask, loose_mask),
            jnp.asarray(sigma_v, dtype), axis_rows,
        )
        # the shared-polish base inverse is only built when these params
        # will actually run that polish (it costs several (n, n) matmuls,
        # a Cholesky and compensated products); admm_solve recomputes it
        # on the fly if it is handed a prepared cache built without it
        if params.polish and params.polish_mode == "shared" \
                and axis_rows is None:
            Mpinv, Mpinv_lo = _polish_prep(P, A, eq_mask)
        else:
            Mpinv = Mpinv_lo = None
        return PreparedQP(
            Ps=Ps, As=As, d=d, e=e, c=c,
            eq_mask=eq_mask, loose_mask=loose_mask, M0=M0, Minv0=Minv0,
            Mpinv=Mpinv, Mpinv_lo=Mpinv_lo,
        )


def _polish_prep(P, A, eq_mask):
    """Shared-polish base inverse pair (hi, lo) on the UNSCALED problem
    (the polish operates unscaled): equality rows are active in every
    instance.

    ``Mp = P + delta I + delta^-1 Aeq'Aeq`` has condition ~1/delta^2, past
    what a float32 factorization resolves: a float32 inverse, even Jacobi-
    scaled and Newton-refined, leaves the polish refinement's contraction
    near 1, and the device's own Cholesky decides on which side (on the
    H100 it diverged and every instance fell back to the unpolished
    iterate).  So the pair is built on the host in float64 NumPy and split
    into words of the problem's dtype: hi = Mp^-1 rounded, lo = the rounded
    remainder.  P, A and the equality rows are fixed per configuration, so
    this runs once per prepared problem; under ``vmap`` (per-instance P and
    A) the callback inverts the whole stack at once."""
    n = P.shape[-1]
    dtype = P.dtype
    delta = _polish_delta_shared(dtype)

    def host(P, A, eq):
        P = np.asarray(P, np.float64)
        A = np.asarray(A, np.float64)
        w = np.asarray(eq, np.float64) / delta
        Mp = P + delta * np.eye(n) + np.swapaxes(A, -1, -2) @ (A * w[..., None])
        inv = np.linalg.inv(Mp)
        hi = inv.astype(dtype)
        lo = (inv - hi).astype(dtype)
        return hi, lo

    out = jax.ShapeDtypeStruct(P.shape, dtype)
    return jax.pure_callback(host, (out, out), P, A, eq_mask,
                             vmap_method="expand_dims")


def _build_kkt_inverse(P, A, rho_vec, sigma, axis_rows=None):
    """Explicit inverse (and the matrix itself) of
    M = P + sigma*I + A' diag(rho) A.

    An explicit inverse (rather than keeping a Cholesky factor) turns every
    ADMM x-update into a plain matmul: ideal for very wide
    batches.  M is SPD so the inverse is well-defined.  M is returned too so
    float32 runs can iteratively refine the x-update against it.  With
    row-sharded A the per-shard contributions psum into the replicated M.
    """
    n = P.shape[0]
    eye = jnp.eye(n, dtype=P.dtype)
    AtRA = _psum_rows((A.T * rho_vec[None, :]) @ A, axis_rows)
    M = P + sigma * eye + AtRA
    Minv = batched_linalg.spd_inverse(M)
    return M, Minv


class _LoopState(NamedTuple):
    x: jax.Array
    z: jax.Array
    y: jax.Array
    x_prev: jax.Array  # snapshot at last check (for dual-infeas cert)
    y_prev: jax.Array
    iters: jax.Array
    done: jax.Array
    stop: jax.Array  # scalar: every instance done, globally agreed across
    # shards (loop-exit flag; with a sharded batch axis all shards must run
    # the same number of blocks because the checks contain collectives)
    status: jax.Array
    pri_res: jax.Array
    dua_res: jax.Array
    inacc_status: jax.Array  # status a max-iter exit would report: OSQP's
    # final check_termination(approximate) with 100x-relaxed tolerances,
    # refreshed at every periodic check for still-active instances
    # (OSQP osqp_solve: on max_iter the last iterate is re-checked with
    # relaxed tolerances to emit *_INACCURATE statuses)
    pri_chk: jax.Array  # (B,) residuals at the previous check — stall
    dua_chk: jax.Array  # detection state (params.stall_checks)
    stall_ct: jax.Array  # (B,) consecutive no-improvement checks
    rho: jax.Array  # scalar, shared across batch
    M: jax.Array
    Minv: jax.Array


@partial(
    jax.jit,
    static_argnames=("params", "n_iters", "check_every", "axis_rows",
                     "axis_batch"),
)
def _admm_loop(P, A, qs, ls, us, x0, y0, rho0, rho_mask_eq, rho_mask_loose,
               d, e, c, M0, Minv0, iter_budget, params: LParameters,
               n_iters: int, check_every: int, axis_rows=None,
               axis_batch=None):
    """Scaled-problem ADMM iterations with periodic termination checks.

    All of P/A/q/l/u here are the *scaled* quantities; d/e/c unscale
    residuals for termination (OSQP checks unscaled residuals by default).
    ``M0``/``Minv0`` are the KKT matrix/inverse at the initial rho (built by
    :func:`prepare_qp`, hoisted out of the per-step hot path).

    ``iter_budget`` is a *traced* iteration cap implementing the
    ``time_limit`` contract (reference: Types.hpp:108-110 via OSQP's
    settings->time_limit, LOptimizer.hpp:256): the loop stops at the first
    termination check past the budget and unconverged instances report
    ``OSQP_TIME_LIMIT_REACHED``.  Pass ``NO_BUDGET`` for no limit.
    """
    B = qs.shape[0]
    n = P.shape[1]
    m = A.shape[0]
    dtype = P.dtype
    f32 = dtype == jnp.float32
    sigma_v, rho_lo, rho_hi = _rho_bounds(dtype, params)
    sigma = jnp.asarray(sigma_v, dtype)
    alpha = jnp.asarray(params.alpha, dtype)

    def rho_vec_of(rho):
        return _rho_vec_of(rho, rho_mask_eq, rho_mask_loose)

    rho_init = jnp.clip(jnp.asarray(rho0, dtype), rho_lo, rho_hi)
    z0 = x0 @ A.T
    init = _LoopState(
        x=x0,
        z=z0,
        y=y0,
        x_prev=x0,
        y_prev=y0,
        iters=jnp.zeros((B,), jnp.int32),
        done=jnp.zeros((B,), bool),
        stop=jnp.asarray(False),
        status=jnp.full((B,), OSQP_UNSOLVED, jnp.int32),
        pri_res=jnp.full((B,), jnp.inf, dtype),
        dua_res=jnp.full((B,), jnp.inf, dtype),
        inacc_status=jnp.full((B,), OSQP_MAX_ITER_REACHED, jnp.int32),
        pri_chk=jnp.full((B,), jnp.inf, dtype),
        dua_chk=jnp.full((B,), jnp.inf, dtype),
        stall_ct=jnp.zeros((B,), jnp.int32),
        rho=rho_init,
        M=M0,
        Minv=Minv0,
    )

    # qs/ls/us are explicit parameters (shadowing the full-batch closure
    # variables) so the same block functions serve both the full batch and
    # the compacted straggler batch (see "straggler compaction" below)
    def one_iteration(state: _LoopState, qs, ls, us) -> _LoopState:
        x, z, y = state.x, state.z, state.y
        rho_vec = rho_vec_of(state.rho)
        # x-update: (P + sigma I + A'RA) xt = sigma x - q + A'(R z - y)
        rhs = sigma * x - qs + _psum_rows((rho_vec * z - y) @ A, axis_rows)
        xt = rhs @ state.Minv  # Minv symmetric
        if f32 and params.x_refine:
            # one refinement pass against M recovers the digits the explicit
            # f32 inverse loses
            xt = xt + (rhs - xt @ state.M) @ state.Minv
        zt = xt @ A.T
        x_new = alpha * xt + (1.0 - alpha) * x
        z_relax = alpha * zt + (1.0 - alpha) * z
        z_unc = z_relax + y / rho_vec
        z_new = jnp.clip(z_unc, ls, us)
        # y is exactly zero on rows where the projection did not clip
        # (mathematically y+ = y - rho*(y/rho); forcing the exact zero keeps
        # inactive duals at 0.0 so the polish active set is unambiguous)
        clipped = (z_unc < ls) | (z_unc > us)
        y_new = jnp.where(clipped, y + rho_vec * (z_relax - z_new), 0.0)
        # freeze finished instances
        keep = state.done[:, None]
        return state._replace(
            x=jnp.where(keep, x, x_new),
            z=jnp.where(keep, z, z_new),
            y=jnp.where(keep, y, y_new),
            iters=state.iters + jnp.where(state.done, 0, 1),
        )

    def termination_check(state: _LoopState, qs, ls, us) -> _LoopState:
        x, z, y = state.x, state.z, state.y
        # -- unscaled residuals ------------------------------------------
        Ax = x @ A.T
        Px = x @ P
        Aty = _psum_rows(y @ A, axis_rows)
        pri = _pmax_rows(_inf_norm((Ax - z) / e[None, :]), axis_rows)
        dua = _inf_norm((Px + qs + Aty) / d[None, :]) / c
        pri_rel = _pmax_rows(
            jnp.maximum(_inf_norm(Ax / e[None, :]), _inf_norm(z / e[None, :])),
            axis_rows,
        )
        dua_rel = jnp.maximum(
            jnp.maximum(_inf_norm(Px / d[None, :]), _inf_norm(Aty / d[None, :])),
            _inf_norm(qs / d[None, :]),
        ) / c
        eps_pri = params.eps_abs + params.eps_rel * pri_rel
        eps_dua = params.eps_abs + params.eps_rel * dua_rel
        solved = (pri <= eps_pri) & (dua <= eps_dua)

        # -- infeasibility certificates (unscaled deltas) ----------------
        # unscaling: x = D x_bar, y = c^-1 E y_bar
        dy = (y - state.y_prev) * e[None, :] / c
        dx = (x - state.x_prev) * d[None, :]
        norm_dy = _pmax_rows(_inf_norm(dy), axis_rows)
        norm_dx = _inf_norm(dx)

        # primal infeasibility: ||A' dy|| small and support function negative
        Atdy = (
            _inf_norm(_psum_rows((y - state.y_prev) @ A, axis_rows) / d[None, :])
            / c
        )
        u_unscaled = us / e[None, :]
        l_unscaled = ls / e[None, :]
        dy_plus = jnp.maximum(dy, 0.0)
        dy_minus = jnp.minimum(dy, 0.0)
        sup = _psum_rows(
            jnp.sum(
                jnp.where(dy_plus > 0, jnp.minimum(u_unscaled, INF_BOUND) * dy_plus, 0.0)
                + jnp.where(dy_minus < 0, jnp.maximum(l_unscaled, -INF_BOUND) * dy_minus, 0.0),
                axis=-1,
            ),
            axis_rows,
        )
        # OSQP auxil.c is_primal_infeasible: ||dy|| > eps, support function
        # strictly negative, and A'dy ~ 0
        eps_p = params.eps_prim_inf * norm_dy
        prim_inf = (norm_dy > params.eps_prim_inf) & (sup < -eps_p) & (Atdy < eps_p)

        # dual infeasibility: P dx ~ 0, q'dx < 0, A dx in recession cone
        Pdx = _inf_norm((dx / d[None, :]) @ P / d[None, :]) / c
        qdx = jnp.sum(qs / d[None, :] * dx, axis=-1) / c
        Adx = (dx / d[None, :]) @ A.T / e[None, :]
        u_inf = u_unscaled >= INF_BOUND
        l_inf = l_unscaled <= -INF_BOUND

        def cone_recession(eps_d):
            return _pall_rows(
                jnp.all(
                    jnp.where(
                        u_inf & l_inf,
                        True,
                        jnp.where(
                            u_inf,
                            Adx >= -eps_d[:, None],
                            jnp.where(l_inf, Adx <= eps_d[:, None], jnp.abs(Adx) <= eps_d[:, None]),
                        ),
                    ),
                    axis=-1,
                ),
                axis_rows,
            )

        def is_dual_infeasible(eps_dual_inf):
            # OSQP auxil.c is_dual_infeasible: ||dx|| > eps, q'dx strictly
            # negative, P dx ~ 0, and A dx in the recession cone
            eps_d = eps_dual_inf * norm_dx
            return (
                (norm_dx > eps_dual_inf)
                & (Pdx < eps_d)
                & (qdx < -eps_d)
                & cone_recession(eps_d)
            )

        dual_inf = is_dual_infeasible(params.eps_dual_inf)

        # -- relaxed re-check: the status a max-iteration exit reports -----
        # OSQP's osqp_solve re-runs check_termination(approximate) on the
        # final iterate with every tolerance relaxed 100x and reports
        # OSQP_SOLVED_INACCURATE / OSQP_{PRIMAL,DUAL}_INFEASIBLE_INACCURATE
        # when only the relaxed test passes (the reference maps all three,
        # include/mpc/LMPC/LOptimizer.hpp:398-403).  The relaxed solved test
        # keeps the full relative form (100*eps_abs + 100*eps_rel*||.||), not
        # an absolute cut-off.  Refreshing the verdict at every periodic
        # check for still-active instances makes the value at loop exit the
        # final-iterate verdict OSQP computes.
        fac = INACCURATE_TOL_FACTOR
        solved_inacc = (pri <= fac * eps_pri) & (dua <= fac * eps_dua)
        eps_p_i = fac * params.eps_prim_inf * norm_dy
        prim_inf_inacc = (
            (norm_dy > fac * params.eps_prim_inf)
            & (sup < -eps_p_i)
            & (Atdy < eps_p_i)
        )
        dual_inf_inacc = is_dual_infeasible(fac * params.eps_dual_inf)
        inacc = jnp.where(
            solved_inacc,
            OSQP_SOLVED_INACCURATE,
            jnp.where(
                prim_inf_inacc,
                OSQP_PRIMAL_INFEASIBLE_INACCURATE,
                jnp.where(
                    dual_inf_inacc,
                    OSQP_DUAL_INFEASIBLE_INACCURATE,
                    OSQP_MAX_ITER_REACHED,
                ),
            ),
        ).astype(jnp.int32)

        newly = ~state.done
        # -- straggler stall detection ------------------------------------
        # float32 runs leave ~1% of instances at a residual noise floor
        # just above eps: they would burn every remaining iteration and
        # report OSQP_SOLVED_INACCURATE at the cap (measured: the same
        # instances still unconverged at a 1000-iteration cap).  When the
        # residuals have improved by <1% for `stall_checks` consecutive
        # checks AND the 100x-relaxed verdict already passes, freeze NOW
        # with that exact verdict — the identical status and (polish-
        # repaired) solution the cap exit would produce, minus the wasted
        # iterations.  Disabled with stall_checks=0 for strict OSQP
        # iteration parity.
        # f32 only: the detector exists to cut the float32 residual-floor
        # tail; f64 runs have no floor, and on degenerate problems (e.g. a
        # zero-weight pure-feasibility QP) small residuals do not bound the
        # distance to the solution, so an early freeze there trades real
        # accuracy for nothing
        if params.stall_checks > 0 and f32:
            improved = (pri <= 0.99 * state.pri_chk) | (
                dua <= 0.99 * state.dua_chk
            )
            stall_ct = jnp.where(
                newly, jnp.where(improved, 0, state.stall_ct + 1),
                state.stall_ct,
            )
            # freeze only inside a TIGHT (10x) band around the tolerance:
            # the f32 floor-stalled instances sit a small factor above eps
            # (measured p50 ~3x), while a hard-but-converging problem can
            # plateau for several checks at a genuinely bad iterate that
            # still passes the official 100x relaxed verdict (observed on
            # the zero-weight terminal-constraint QP: a 0.3 state error
            # inside the 100x band) — the 10x gate separates the two
            solved_near = (pri <= 10.0 * eps_pri) & (dua <= 10.0 * eps_dua)
            stalled = (
                newly
                & ~(solved | prim_inf | dual_inf)
                & (stall_ct >= params.stall_checks)
                & solved_near
            )
        else:
            stall_ct = state.stall_ct
            stalled = jnp.zeros_like(newly)

        status = jnp.where(
            newly & solved,
            OSQP_SOLVED,
            jnp.where(
                newly & prim_inf,
                OSQP_PRIMAL_INFEASIBLE,
                jnp.where(
                    newly & dual_inf,
                    OSQP_DUAL_INFEASIBLE,
                    jnp.where(stalled, OSQP_SOLVED_INACCURATE, state.status),
                ),
            ),
        )
        done = state.done | solved | prim_inf | dual_inf | stalled

        # -- adaptive rho (shared across batch to keep one shared factor) -
        if params.adaptive_rho:
            ratio = jnp.sqrt(
                jnp.clip(
                    (pri / jnp.clip(pri_rel, 1e-12))
                    / jnp.clip(dua / jnp.clip(dua_rel, 1e-12), 1e-12),
                    1e-10,
                    1e10,
                )
            )
            ratio = jnp.nan_to_num(ratio, nan=1.0, posinf=1e10, neginf=1e-10)
            # geometric mean over still-active instances — across the WHOLE
            # fleet batch when it is sharded over a data axis, so every
            # shard makes the same rho decision as an unsharded batch would
            active = ~done
            log_sum = jnp.sum(jnp.where(active, jnp.log(ratio), 0.0))
            n_act = jnp.sum(active)
            if axis_batch:
                log_sum = jax.lax.psum(log_sum, axis_batch)
                n_act = jax.lax.psum(n_act, axis_batch)
            rho_est = state.rho * jnp.exp(log_sum / jnp.maximum(n_act, 1))
            rho_est = jnp.clip(jnp.nan_to_num(rho_est, nan=rho_lo), rho_lo, rho_hi)
            need_update = (n_act > 0) & (
                (rho_est > state.rho * ADAPTIVE_RHO_TOLERANCE)
                | (rho_est < state.rho / ADAPTIVE_RHO_TOLERANCE)
            )
            rho_new, (M_new, Minv_new) = jax.lax.cond(
                need_update,
                lambda: (
                    rho_est,
                    _build_kkt_inverse(
                        P, A, rho_vec_of(rho_est), sigma, axis_rows
                    ),
                ),
                lambda: (state.rho, (state.M, state.Minv)),
            )
        else:
            rho_new, M_new, Minv_new = state.rho, state.M, state.Minv

        all_done = jnp.all(done)
        if axis_batch:
            # loop-exit agreement across the sharded batch axis
            all_done = (
                jax.lax.psum((~all_done).astype(jnp.int32), axis_batch) == 0
            )

        return state._replace(
            x_prev=x,
            y_prev=y,
            done=done,
            stop=all_done,
            status=status,
            pri_res=jnp.where(newly, pri, state.pri_res),
            dua_res=jnp.where(newly, dua, state.dua_res),
            inacc_status=jnp.where(newly, inacc, state.inacc_status),
            pri_chk=jnp.where(newly, pri, state.pri_chk),
            dua_chk=jnp.where(newly, dua, state.dua_chk),
            stall_ct=stall_ct,
            rho=rho_new,
            M=M_new,
            Minv=Minv_new,
        )

    n_blocks = max(1, (n_iters + check_every - 1) // check_every)

    def block(state: _LoopState, qs, ls, us):
        state = jax.lax.fori_loop(
            0, check_every, lambda _, s: one_iteration(s, qs, ls, us),
            state,
        )
        return termination_check(state, qs, ls, us)

    budget = jnp.asarray(iter_budget, jnp.int32)

    def cond(state_k):
        state, k = state_k
        return (k < n_blocks) & ~state.stop & (k * check_every < budget)

    def body(state_k):
        state, k = state_k
        return block(state, qs, ls, us), k + 1

    # -- straggler compaction ------------------------------------------
    # Lockstep batches pay for their slowest instance: at the production
    # bench ~1% of a warm 16k batch stalls past the first check and drags
    # the WHOLE batch through every remaining block.  When the active
    # count falls to ``cap`` (a static 1/16th of the batch), the
    # unconverged instances are compacted into a cap-sized batch and only
    # that continues — identical per-row math (frozen rows never update;
    # gathers preserve rows) and identical check cadence.  With fixed rho
    # the results are bitwise identical; with adaptive rho the statistics
    # average over the same active instances but the reduction SHAPE
    # changes (B -> cap), so the masked log-sum may associate differently
    # and rho can move by an ulp — results then agree to rounding, not
    # bitwise.
    # Single-chip batched path only: under a sharded batch axis the
    # per-shard psum counts must stay aligned across shards.
    cap = 8
    while cap * 32 <= B:
        cap *= 2
    compact = (
        params.compact_stragglers
        and axis_rows is None
        and axis_batch is None
        and cap < B
        and B >= 256
    )

    if compact:
        def cond1(state_k):
            state, k = state_k
            return cond(state_k) & (jnp.sum(~state.done) > cap)
    else:
        cond1 = cond

    state, k_fin = jax.lax.while_loop(
        cond1, body, (init, jnp.asarray(0, jnp.int32))
    )

    if compact:
        def phase2(state, k1):
            _, idx = jax.lax.top_k((~state.done).astype(jnp.float32), cap)
            take = lambda a: jnp.take(a, idx, axis=0)
            sub = state._replace(
                x=take(state.x), z=take(state.z), y=take(state.y),
                x_prev=take(state.x_prev), y_prev=take(state.y_prev),
                iters=take(state.iters), done=take(state.done),
                status=take(state.status), pri_res=take(state.pri_res),
                dua_res=take(state.dua_res),
                inacc_status=take(state.inacc_status),
                pri_chk=take(state.pri_chk), dua_chk=take(state.dua_chk),
                stall_ct=take(state.stall_ct),
            )
            qs_c, ls_c, us_c = take(qs), take(ls), take(us)

            def body_sub(state_k):
                s, k = state_k
                return block(s, qs_c, ls_c, us_c), k + 1

            sub, k2 = jax.lax.while_loop(cond, body_sub, (sub, k1))
            put = lambda a, b: a.at[idx].set(b)
            state = state._replace(
                x=put(state.x, sub.x), z=put(state.z, sub.z),
                y=put(state.y, sub.y),
                x_prev=put(state.x_prev, sub.x_prev),
                y_prev=put(state.y_prev, sub.y_prev),
                iters=put(state.iters, sub.iters),
                done=put(state.done, sub.done),
                status=put(state.status, sub.status),
                pri_res=put(state.pri_res, sub.pri_res),
                dua_res=put(state.dua_res, sub.dua_res),
                inacc_status=put(state.inacc_status, sub.inacc_status),
                pri_chk=put(state.pri_chk, sub.pri_chk),
                dua_chk=put(state.dua_chk, sub.dua_chk),
                stall_ct=put(state.stall_ct, sub.stall_ct),
                rho=sub.rho, M=sub.M, Minv=sub.Minv, stop=sub.stop,
            )
            return state, k2

        state, k_fin = jax.lax.cond(
            cond((state, k_fin)), phase2, lambda s, k: (s, k), state, k_fin
        )

    # instances that never converged: distinguish a budget (time-limit) stop
    # from an ordinary max-iteration exhaustion, like OSQP's
    # exceeds_max_time check in its iteration loop
    budget_hit = (k_fin < n_blocks) & (k_fin * check_every >= budget)
    # a max-iteration exit reports the relaxed-tolerance verdict from the
    # final termination check: SOLVED_INACCURATE or the infeasibility
    # INACCURATE certificates (OSQP's check_termination(approximate) on the
    # last iterate; the relative forms live in termination_check above)
    max_iter_status = jnp.where(
        budget_hit, OSQP_TIME_LIMIT_REACHED, state.inacc_status
    )
    status = jnp.where(state.status == OSQP_UNSOLVED, max_iter_status, state.status)
    return state._replace(status=status)


def _polish_delta(dtype) -> float:
    """Dense-polish penalty regularizer: float32 needs a larger delta (and
    more refinement) than f64; delta must stay below the KKT system's
    smallest relevant eigenvalue or the refinement iteration diverges."""
    return 1e-4 if dtype == jnp.float32 else 1e-6


def _polish_delta_shared(dtype) -> float:
    """Shared-polish penalty regularizer.  The refinement contraction per
    pass is ~(c.delta + kappa(Mp).eps): delta controls the penalty bias,
    while the float32 factorization error of the shared base
    ``Mp = P + delta I + delta^-1 Aeq'Aeq`` (condition ~1/delta^2) grows as
    delta shrinks.  1e-2 keeps the factorization comfortably inside float32
    (a smaller delta makes the float32 Cholesky residual O(1) and the
    refinement diverges outright); the resulting modest ~0.7/pass
    contraction is paid for with MANY incremental refinement passes, which
    the compensated-residual scheme makes cheap and exact-residual."""
    return 1e-2 if dtype == jnp.float32 else 1e-4


def _split12(a):
    """Dekker split of float32 into an 8-bit-mantissa head and a tail.

    The head is exactly bfloat16-representable, so a head x head product
    is exact even where a float32 matmul decomposes each operand into
    bfloat16 passes (8+8 mantissa bits; a 12-bit Dekker head would span two
    passes whose float32 accumulation rounds, destroying the
    compensation).  The wider tails only enter the low word through plain
    matmuls whose ~n.eps.2^-8 relative error is below the compensation
    target."""
    c = a * 65537.0  # 2^16 + 1 -> 8-bit head, 16-bit tail
    hi = c - (c - a)
    return hi, a - hi


def _two_sum(a, b):
    """Knuth's error-free addition: s + e == a + b exactly (float32)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _comp_mm(X, M, chunk=32):
    """Compensated ``X @ M`` -> (hi, lo) double-single pair, float32 ops.

    The head-product partial sums are accumulated per contraction chunk
    (bounding each partial's rounding to ~chunk.eps) and the chunk partials
    are combined with error-free TwoSums; the cross/tail products are ~eps
    of the result and go straight into the low word.  Gives residual-scale
    cancellation ~eps^2 where a plain float32 matmul leaves ~n.eps — the
    enabler for polishing to the float32 DATA floor instead of the float32
    MATVEC floor (measured on the quadrotor golden: 2.4e-6 vs 1.2e-4)."""
    Xh, Xl = _split12(X)
    Mh, Ml = _split12(M)
    K = M.shape[0]
    hi = None
    lo = 0.0
    for c0 in range(0, K, chunk):
        p = Xh[..., c0 : c0 + chunk] @ Mh[c0 : c0 + chunk, :]
        if hi is None:
            hi = p
        else:
            hi, e = _two_sum(hi, p)
            lo = lo + e
    lo = lo + (X @ Ml + Xl @ Mh)
    return hi, lo


def _polish_active_set(l, u, sol_y, eq_mask, dtype, delta):
    """Active rows from dual signs (OSQP polish.c) -> (active, b, w)."""
    low_active = (sol_y < 0) | (eq_mask[None, :] & (sol_y <= 0))
    upp_active = sol_y > 0
    active = low_active | upp_active
    b = jnp.where(low_active, l, jnp.where(upp_active, u, 0.0))
    w = active.astype(dtype) / delta  # (B, m) row weights
    return active, b, w


def _polish_accept(P, A, q, l, u, sol_x, sol_y, sol_z, x_pol, y_pol,
                   active, axis_rows):
    """Per-instance acceptance: keep the polished solution only if it
    reduces both residual norms (OSQP polish.c:polish())."""
    y_pol = jnp.where(active, y_pol, 0.0)
    z_pol = jnp.clip(x_pol @ A.T, l, u)

    def residuals(x, z, y):
        pri = _pmax_rows(_inf_norm(x @ A.T - z), axis_rows)
        dua = _inf_norm(x @ P + q + _psum_rows(y @ A, axis_rows))
        return pri, dua

    pri0, dua0 = residuals(sol_x, sol_z, sol_y)
    pri1, dua1 = residuals(x_pol, z_pol, y_pol)
    better = (pri1 <= pri0) & (dua1 <= dua0)
    bsel = better[:, None]
    return (
        jnp.where(bsel, x_pol, sol_x),
        jnp.where(bsel, y_pol, sol_y),
        jnp.where(bsel, z_pol, sol_z),
        jnp.where(better, pri1, pri0),
        jnp.where(better, dua1, dua0),
    )


def _polish_shared(P, A, q, l, u, sol_x, sol_y, sol_z, params: LParameters,
                   eq_mask, prepared: PreparedQP):
    """Active-set polish with ONE shared factorization + exact per-instance
    Woodbury corrections — the batch-first polish.

    The per-instance active-set system is
    ``K_i = Mp + delta^-1 U_i U_i'`` where ``Mp = P + delta I +
    delta^-1 Aeq'Aeq`` is shared (equality rows are active in every
    instance) and ``U_i = A[active ineq rows of i]'`` is low-rank (few
    active inequality rows per instance, capped at ``k_max``).  The Woodbury
    identity solves ``K_i x = r`` exactly with only gathers, batched
    (k x k) Cholesky factorizations, and shared-matrix matmuls::

        K^-1 r = Mpinv r - Mpinv U (delta I + U' Mpinv U)^-1 U' Mpinv r

    with the per-instance ``U`` terms formed as dense einsums over the
    once-gathered active rows ``A_g`` (dense contractions instead of
    batched scatters and cross-row gathers).

    Outer refinement against the TRUE optimality system (as in the dense
    mode) contracts the O(delta) penalty bias each pass.  Instances with
    more than ``k_max`` active inequality rows get an inexact correction and
    are caught by the acceptance test (kept unpolished).  Cost: ~one ADMM
    block instead of B dense (n,n) factorizations.
    """
    dtype = P.dtype
    B = q.shape[0]
    m = A.shape[0]
    delta = jnp.asarray(_polish_delta_shared(dtype), dtype)
    # enough passes that the refined duals beat an already-tight raw dual
    # residual (the acceptance test is AND over both residuals)
    outer_iters = max(6, params.polish_refine_iter)
    k_max = min(params.polish_active_cap, m)
    Mpinv = prepared.Mpinv
    Mpinv_lo = prepared.Mpinv_lo

    def mp_solve(r):
        # apply the double-single inverse pair: two plain matmuls whose
        # roundings are random per call, not systematic — the refinement's
        # contraction is bias-limited, not inverse-limited
        return r @ Mpinv + r @ Mpinv_lo

    active, bnd, w = _polish_active_set(l, u, sol_y, eq_mask, dtype, delta)

    # per-instance indices of active inequality rows (top_k compaction —
    # any order works, and top_k is cheaper than a full argsort),
    # padded with inactive rows masked out of the capacitance
    extra = active & ~eq_mask[None, :]
    _, idx = jax.lax.top_k(extra.astype(dtype), k_max)  # (B, k)
    valid = jnp.take_along_axis(extra, idx, axis=-1)  # (B, k)

    # gather the active-inequality rows ONCE; all per-pass index work then
    # becomes dense einsums over A_g instead of scatters, take_along
    # gathers and (B, k, m) slices
    A_g = jnp.where(
        valid[:, :, None], jnp.take(A, idx, axis=0), 0.0
    )  # (B, k, n), masked rows zeroed

    # batched capacitance C = delta I + U' Mpinv U; invalid slots become
    # decoupled unit equations
    A_gM = jnp.einsum("bkn,nm->bkm", A_g, Mpinv)  # (B, k, n)
    Ck = jnp.einsum("bkm,bjm->bkj", A_gM, A_g)  # (B, k, k)
    eye_k = jnp.eye(k_max, dtype=dtype)
    C = Ck + delta * eye_k[None] \
        + jnp.where(valid, 0.0, 1.0)[:, :, None] * eye_k[None]
    # explicit capacitance inverse: K_solve applies it as one batched
    # matvec per call
    Cinv = batched_linalg.spd_inverse(C)

    def K_solve(r):  # (B, n) -> exact K_i^-1 r
        t = mp_solve(r)
        v = jnp.einsum("bn,bkn->bk", t, A_g)  # (B, k)
        y = jnp.einsum("bij,bj->bi", Cinv, v)
        corr = jnp.einsum("bk,bkn->bn", y, A_g)
        return t - mp_solve(corr)

    # outer refinement against the TRUE optimality system: each pass
    # contracts the O(delta) penalty bias by ~delta
    x = sol_x  # the ADMM iterate is already close
    nu = jnp.where(active, sol_y, 0.0)

    def correct(x, nu, r1, r2):
        dx = K_solve(r1 + (w * r2) @ A)
        dnu = w * (dx @ A.T - r2)
        return x + dx, nu + dnu, dx, dnu

    def plain(_, carry):
        x, nu = carry
        r1 = -q - x @ P - jnp.where(active, nu, 0.0) @ A
        r2 = jnp.where(active, bnd - x @ A.T, 0.0)
        x, nu, _, _ = correct(x, nu, r1, r2)
        return x, nu

    if dtype == jnp.float32:
        # float32 schedule: plain passes contract the O(delta) penalty bias
        # down to the float32 matvec noise floor (~n.eps); then ONE
        # compensated residual evaluation re-anchors the true residual to
        # ~eps^2 and cheap incremental passes (residual-scale updates, no
        # cancellation) continue the same ~0.7/pass contraction BELOW the
        # float32 matvec floor to the float32 DATA floor.
        x, nu = jax.lax.fori_loop(0, 3, plain, (x, nu))
        h1, l1 = _comp_mm(x, P)
        h2, l2 = _comp_mm(jnp.where(active, nu, 0.0), A)
        s, e1 = _two_sum(-q, -h1)
        s, e2 = _two_sum(s, -h2)
        r1 = s + (e1 + e2 - l1 - l2)
        h3, l3 = _comp_mm(x, A.T)
        bnd_m = jnp.where(active, bnd, 0.0)
        s3, e3 = _two_sum(bnd_m, -h3)
        r2 = jnp.where(active, s3 + (e3 - l3), 0.0)
        def incremental(_, carry):
            x, nu, r1, r2 = carry
            x, nu, dx, dnu = correct(x, nu, r1, r2)
            r1 = r1 - dx @ P - dnu @ A
            r2 = jnp.where(active, r2 - dx @ A.T, 0.0)
            return x, nu, r1, r2

        x, nu, _, _ = jax.lax.fori_loop(
            0, max(params.polish_comp_passes, 0), incremental,
            (x, nu, r1, r2)
        )
        x_pol, y_pol = x, nu
    else:
        x_pol, y_pol = jax.lax.fori_loop(0, outer_iters, plain, (x, nu))
    return _polish_accept(
        P, A, q, l, u, sol_x, sol_y, sol_z, x_pol, y_pol, active, None
    )


def _polish(P, A, q, l, u, sol_x, sol_y, sol_z, params: LParameters, eq_mask,
            axis_rows=None):
    """Active-set polish (OSQP polish.c, penalty/Schur-complement form) with
    per-instance dense factorizations.

    Identify lower/upper-active rows from the dual signs, then solve the
    stabilized equality-constrained QP::

        (P + delta I + A_act' (1/delta) A_act) x = -q + A_act' b / delta

    which is the Schur complement of the regularized KKT system.  Unlike
    OSQP's reduced factorization (which changes dimension per active set),
    this keeps a fixed (n,n) shape so it batches: active sets enter only as a
    per-instance 0/1 row weight.  A few iterative-refinement steps recover the
    accuracy lost to the penalty term.
    """
    dtype = P.dtype
    n = P.shape[1]
    f32 = dtype == jnp.float32
    delta = jnp.asarray(_polish_delta(dtype), dtype)
    refine_iters = max(params.polish_refine_iter, 15) if f32 else params.polish_refine_iter

    active, b, w = _polish_active_set(l, u, sol_y, eq_mask, dtype, delta)

    eye = jnp.eye(n, dtype=dtype)

    def solve_one(qi, wi, bi, acti):
        # regularized reduced operator; refinement targets the original
        # (unregularized) KKT system so the delta bias is iterated away
        # (OSQP polish.c: iterative_refinement against the KKT matrix)
        M = P + delta * eye + _psum_rows((A.T * wi[None, :]) @ A, axis_rows)
        cho = jax.scipy.linalg.cho_factor(M)

        x = jax.scipy.linalg.cho_solve(
            cho, -qi + _psum_rows((wi * bi) @ A, axis_rows)
        )
        nu = wi * (x @ A.T - bi)

        def refine(_, carry):
            x, nu = carry
            r1 = -qi - x @ P - _psum_rows(
                jnp.where(acti, nu, 0.0) @ A, axis_rows
            )
            r2 = jnp.where(acti, bi - x @ A.T, 0.0)
            dx = jax.scipy.linalg.cho_solve(
                cho, r1 + _psum_rows((wi * r2) @ A, axis_rows)
            )
            dnu = wi * (dx @ A.T - r2)
            return x + dx, nu + dnu

        x, nu = jax.lax.fori_loop(0, refine_iters, refine, (x, nu), unroll=True)
        return x, nu

    x_pol, y_pol = jax.vmap(solve_one)(q, w, b, active)
    return _polish_accept(
        P, A, q, l, u, sol_x, sol_y, sol_z, x_pol, y_pol, active, axis_rows
    )


def admm_solve(
    P: jax.Array,
    A: jax.Array,
    q: jax.Array,
    l: jax.Array,
    u: jax.Array,
    params: LParameters = LParameters(),
    warm_x: Optional[jax.Array] = None,
    warm_y: Optional[jax.Array] = None,
    eq_mask: Optional[jax.Array] = None,
    iter_budget: Optional[jax.Array] = None,
    prepared: Optional[PreparedQP] = None,
    axis_rows: Optional[str] = None,
    axis_batch: Optional[str] = None,
    have_warm: Optional[jax.Array] = None,
) -> QPSolution:
    """Solve a batch of QPs sharing (P, A) structure.

    ``axis_rows``/``axis_batch`` name mesh axes when called inside
    ``shard_map``: with ``axis_rows`` the constraint rows of A/l/u (and z/y)
    are the local shard of a row-sharded problem (the tensor-parallel axis;
    cross-space products psum, row norms pmax — full feature parity with the
    single-chip path including Ruiz, certificates, adaptive rho and polish);
    with ``axis_batch`` the batch is a shard of a fleet and the batch-global
    statistics (adaptive-rho estimate, loop exit) reduce over the fleet.

    Args:
      P: (n, n) quadratic cost (full symmetric, not upper-tri).
      A: (m, n) constraint matrix.
      q, l, u: (B, n) / (B, m) (or unbatched (n,) / (m,)) per-instance data.
      params: OSQP-style settings (static; selects the compiled program).
      warm_x, warm_y: optional warm-start primal/dual, shaped like q / l.
      eq_mask: optional (m,) bool marking structural equality rows (l == u);
        inferred (conservatively over the batch) when omitted.
      iter_budget: optional *traced* iteration cap implementing the
        ``time_limit`` contract; unconverged instances stopped by it report
        ``OSQP_TIME_LIMIT_REACHED``.  ``None`` means unlimited.
      have_warm: optional traced bool (scalar or (B,)): False selects the
        cold-start path (KKT seed under ``params.cold_start == "kkt"``)
        even when warm arrays are supplied — for callers that collapse
        "no warm state yet" into zero-filled warm arrays.

    Returns a :class:`QPSolution` with a leading batch axis (squeezed back if
    the inputs were unbatched).

    All matmuls run at ``highest`` precision (IEEE float32 on a GPU, no
    TF32): reduced-precision passes are catastrophic for an iterative
    solver converging to 1e-4 residuals (the factorization alone loses all
    significant digits).
    """
    with jax.default_matmul_precision("highest"):
        return _admm_solve_hp(
            P, A, q, l, u, params, warm_x, warm_y, eq_mask, iter_budget,
            prepared, axis_rows, axis_batch, have_warm,
        )


def _admm_solve_hp(
    P, A, q, l, u, params, warm_x, warm_y, eq_mask, iter_budget=None,
    prepared=None, axis_rows=None, axis_batch=None, have_warm=None,
) -> QPSolution:
    unbatched = q.ndim == 1
    if unbatched:
        q, l, u = q[None], l[None], u[None]
        warm_x = None if warm_x is None else warm_x[None]
        warm_y = None if warm_y is None else warm_y[None]

    dtype = P.dtype
    B, n = q.shape
    m = A.shape[0]
    # batched q with shared (m,) bounds: materialize the batch axis so every
    # downstream row operation (including the straggler-compaction gathers)
    # sees (B, m) arrays
    if l.ndim == 1:
        l = jnp.broadcast_to(l, (B, m))
    if u.ndim == 1:
        u = jnp.broadcast_to(u, (B, m))

    # rho_vec is shared across the batch (one shared KKT factorization), so
    # per-instance structure must reduce conservatively over the batch: a row
    # gets the fast equality rho only when it is an equality in EVERY
    # instance, and the loose rho only when it is loose in EVERY instance.
    # Mixed rows fall back to the ordinary rho — correct for all instances,
    # merely less tuned (per-instance bounds via set_instance_bounds).
    if prepared is None:
        if eq_mask is None:
            eq_mask = jnp.all((l == u) & jnp.isfinite(l), axis=0)
        loose_mask = jnp.all((l <= -INF_BOUND) & (u >= INF_BOUND), axis=0)
        q_ref = jnp.max(jnp.abs(q), axis=0)
        if axis_batch:
            q_ref = jax.lax.pmax(q_ref, axis_batch)
        prepared = prepare_qp(P, A, q_ref, eq_mask, loose_mask, params,
                              axis_rows)

    Ps, As = prepared.Ps, prepared.As
    d, e, c = prepared.d, prepared.e, prepared.c
    eq_mask, loose_mask = prepared.eq_mask, prepared.loose_mask
    qs = c * (q * d[None, :])
    # scale bounds, keeping infinities infinite
    ls = jnp.where(l <= -INF_BOUND, l, l * e[None, :])
    us = jnp.where(u >= INF_BOUND, u, u * e[None, :])

    # cold-solve rho escalation (params.cold_rho): a cold batch starts at
    # the stiffer cold rho — its shared KKT factor is built only on the
    # cold branch of a scalar cond, so warm solves pay nothing.  rho and
    # the factor are batch-shared, so the escalation applies only when NO
    # lane is warm (the closed-loop shape: step 0 all-cold, every later
    # step warm; a MIXED per-lane have_warm batch keeps the warm rho —
    # escalating it would tax every warm lane for the few cold ones).
    rho0 = params.rho
    M0_run, Minv0_run = prepared.M0, prepared.Minv0
    if params.cold_rho > 0:
        if have_warm is not None:
            any_warm = jnp.any(jnp.asarray(have_warm))
        elif warm_x is not None and params.enable_warm_start:
            any_warm = jnp.asarray(True)
        else:
            any_warm = jnp.asarray(False)
        sigma_v, rho_lo, rho_hi = _rho_bounds(dtype, params)
        rho_cold = jnp.clip(
            jnp.asarray(params.cold_rho, dtype), rho_lo, rho_hi
        )
        rho0 = jnp.where(any_warm, jnp.asarray(params.rho, dtype), rho_cold)
        M0_run, Minv0_run = jax.lax.cond(
            any_warm,
            lambda: (prepared.M0, prepared.Minv0),
            lambda: _build_kkt_inverse(
                Ps, As, _rho_vec_of(rho_cold, eq_mask, loose_mask),
                jnp.asarray(sigma_v, dtype), axis_rows,
            ),
        )

    y_seed = jnp.zeros((B, m), dtype)
    if params.cold_start in ("kkt", "kkt_duals"):
        # seed the cold start at the minimizer of the rho-weighted
        # equality-anchored quadratic model: one ADMM x-update evaluated at
        # z = clip(0, l, u) (which IS the equality RHS on equality rows),
        # y = 0 — a single matmul against the KKT inverse THE COLD SOLVE
        # WILL RUN WITH (Minv0_run: the cold-rho factor under cold_rho,
        # else the prepared warm-rho factor), so the seeded pair is
        # consistent with the solve's own initial rho.
        # Measured on the quadrotor closed loop (round 4): the PRIMAL-only
        # seed increased cold iterations (209.8 vs 195.1 mean) — a good
        # primal with zero duals starts the ADMM off the central path —
        # which is why "zeros" stayed the default.
        rho_vec0 = _rho_vec_of(
            jnp.clip(jnp.asarray(rho0, dtype),
                     *_rho_bounds(dtype, params)[1:]),
            eq_mask, loose_mask,
        )
        z_t = jnp.clip(0.0, ls, us)
        x_seed = ((rho_vec0 * z_t) @ As - qs) @ Minv0_run
        if params.cold_start == "kkt_duals":
            # round-5 attempt 2 (the round-4 rejection's own diagnosis):
            # seed the DUALS too, from the seeded primal's constraint
            # activity — y0 = rho (A x_seed - clip(A x_seed, l, u)) is the
            # dual step ADMM itself would take from (x_seed, y=0), so the
            # pair starts consistent with the central path instead of
            # bolting a good primal onto zero multipliers.
            Ax = x_seed @ As.T
            y_seed = rho_vec0 * (Ax - jnp.clip(Ax, ls, us))
    else:
        x_seed = jnp.zeros((B, n), dtype)

    if warm_x is not None and params.enable_warm_start:
        if have_warm is None:
            x0 = warm_x / d[None, :]
            y0 = (jnp.zeros((B, m), dtype) if warm_y is None
                  else warm_y / e[None, :] * c)
        else:
            # traced warm/cold selection: callers that collapse "no warm
            # state yet" into zero arrays pass the flag so the cold branch
            # still gets the KKT seed
            hw = jnp.asarray(have_warm)
            hw2 = hw[..., None] if hw.ndim else hw
            x0 = jnp.where(hw2, warm_x / d[None, :], x_seed)
            y0 = jnp.where(
                hw2,
                (jnp.zeros((B, m), dtype) if warm_y is None
                 else warm_y / e[None, :] * c),
                y_seed,
            )
    else:
        x0 = x_seed
        y0 = y_seed

    if iter_budget is None:
        iter_budget = jnp.asarray(NO_BUDGET, jnp.int32)

    state = _admm_loop(
        Ps, As, qs, ls, us, x0, y0,
        rho0, eq_mask, loose_mask, d, e, c,
        M0_run, Minv0_run, iter_budget,
        params, params.maximum_iteration,
        min(params.check_termination, params.maximum_iteration),
        axis_rows, axis_batch,
    )

    # -- unscale ----------------------------------------------------------
    x = state.x * d[None, :]
    y = state.y * e[None, :] / c
    z = state.z / e[None, :]
    pri_res, dua_res = state.pri_res, state.dua_res

    if params.polish:
        # the shared-factorization polish gathers cross-row Woodbury blocks,
        # which does not compose with row sharding — the dense mode (psum'd
        # per-instance factorizations) covers that case
        if params.polish_mode == "shared" and axis_rows is None:
            if prepared.Mpinv is None:
                # prepared cache built under no-polish params: build the
                # base inverse here (traced once per compiled program)
                mp_hi, mp_lo = _polish_prep(P, A, eq_mask)
                prepared = prepared._replace(Mpinv=mp_hi, Mpinv_lo=mp_lo)
            x_p, y_p, z_p, pri_p, dua_p = _polish_shared(
                P, A, q, l, u, x, y, z, params, eq_mask, prepared
            )
        else:
            x_p, y_p, z_p, pri_p, dua_p = _polish(
                P, A, q, l, u, x, y, z, params, eq_mask, axis_rows
            )
        ok = (state.status == OSQP_SOLVED) | (state.status == OSQP_SOLVED_INACCURATE)
        sel = ok[:, None]
        x = jnp.where(sel, x_p, x)
        y = jnp.where(sel, y_p, y)
        z = jnp.where(sel, z_p, z)
        pri_res = jnp.where(ok, pri_p, pri_res)
        dua_res = jnp.where(ok, dua_p, dua_res)

    obj = 0.5 * jnp.einsum("bi,ij,bj->b", x, P, x) + jnp.sum(q * x, axis=-1)

    sol = QPSolution(
        x=x,
        y=y,
        z=z,
        status=state.status,
        iters=state.iters,
        obj_val=obj,
        pri_res=pri_res,
        dua_res=dua_res,
    )
    if unbatched:
        sol = jax.tree.map(lambda a: a[0], sol)
    return sol
