"""Batched SQP solver for the nonlinear MPC problem.

The batched replacement for NLopt's LD_SLSQP driving the reference's NLMPC
(reference: include/mpc/NLMPC/NLOptimizer.hpp:64, :519).  Same solver family —
sequential quadratic programming with an l1-merit line search — re-built
around what the hardware and autodiff make cheap:

* gradients and constraint Jacobians are exact autodiff (the reference uses
  finite differences, Constraints.hpp:844-905);
* curvature is the exact Lagrangian Hessian convexified by eigenvalue
  clipping (``hessian_reg="eigh"`` — fewest SQP iterations) or shifted by a
  Gershgorin bound (``"gershgorin"``, the default); damped-BFGS
  (``"bfgs"``, SLSQP's own family) and factorization-free shifts
  (``"gershgorin"``/``"power"``) are selectable;
* the inner QP reuses the batched ADMM kernel (`ops/admm.py`), sharing one QP
  engine between LMPC and NLMPC, warm-started across SQP iterations;
* the line search is a lazy backtracking loop trying [unit step,
  second-order-correction candidate, halvings] and stopping at the first
  Armijo pass — ~1 merit evaluation per iteration near convergence;
* a batch of instances is solved by ``vmap`` of this function.

Status codes mirror nlopt's enum values so ``Result.solver_status`` matches
the reference's (reference: include/mpc/NLMPC/NLOptimizer.hpp:729-750).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..types import LParameters, NLParameters
from . import admm, pdip, qp_inner_pallas, trajectory_kkt

# -- nlopt result values (nlopt.hpp) ----------------------------------------
NLOPT_FAILURE = -1
NLOPT_ROUNDOFF_LIMITED = -4
NLOPT_SUCCESS = 1
NLOPT_STOPVAL_REACHED = 2
NLOPT_FTOL_REACHED = 3
NLOPT_XTOL_REACHED = 4
NLOPT_MAXEVAL_REACHED = 5
NLOPT_MAXTIME_REACHED = 6

_LS_STEPS = 12  # step ladder 2^0 .. 2^-11 (+1 SOC candidate)
_INTERNAL_ACC = 1e-7  # optimality tolerance when no user tol is set
_MAX_LS_FAILS = 4
_MAX_STALL = 6
_ARMIJO_C1 = 1e-4
# second-order correction: a dense Cholesky solve of Je Je' up to this many
# equality rows, matrix-free CG beyond.  On an H100 the dense solve was the
# faster at 20 rows (0.38 vs 0.48 ms, B=4096) and CG from 60 rows up (0.45
# vs 0.51 ms at 60, 1.24 vs 1.34 ms at 240, B=256), PERF.md
_SOC_DENSE_MAX_ROWS = 52


class Carry(NamedTuple):
    """SQP loop state — module-scope so resumable chunks (begin / chunk /
    finish across separate traces) share one pytree type."""

    z: jax.Array
    lam_e: jax.Array
    lam_i: jax.Array
    f: jax.Array
    mu_e: jax.Array
    mu_i: jax.Array
    it: jax.Array
    status: jax.Array
    ls_fails: jax.Array
    viol: jax.Array
    qp_x: jax.Array  # inner-QP warm start: previous direction
    qp_y: jax.Array  # inner-QP warm start: previous duals
    f_best: jax.Array  # stagnation tracking: best objective seen
    viol_best: jax.Array  # stagnation tracking: best violation seen
    stall: jax.Array  # iterations without meaningful progress
    # quasi-Newton state ("bfgs" mode; inert under exact-Hessian modes)
    Bmat: jax.Array  # (nz, nz) PSD curvature model
    z_prev: jax.Array  # iterate the stored derivatives belong to
    g_prev: jax.Array  # objective gradient at z_prev
    Je_prev: jax.Array  # equality Jacobian at z_prev
    Ji_prev: jax.Array  # inequality Jacobian at z_prev
    have_prev: jax.Array  # bool: the *_prev derivatives are valid
    have_scaled: jax.Array  # bool: Shanno-Phua sizing already applied


class SQPSolution(NamedTuple):
    z: jax.Array  # (nz,) final decision vector
    obj: jax.Array  # scalar objective value
    status: jax.Array  # int32 nlopt-style code
    iters: jax.Array  # int32 SQP iterations
    kkt_res: jax.Array  # final constraint violation (inf-norm)


def _gershgorin_convexify(H, nz: int, dtype):
    """PSD shift by a Gershgorin bound: tau >= -lambda_min guarantees
    positive semidefiniteness without an eigendecomposition; more
    conservative than eigenvalue clipping when H is indefinite."""
    diag = jnp.diagonal(H)
    radius = jnp.sum(jnp.abs(H), axis=1) - jnp.abs(diag)
    gersh_lo = jnp.min(diag - radius)
    scale = jnp.max(diag + radius)
    tau = jnp.maximum(-gersh_lo, 0.0) + jnp.maximum(1e-6 * scale, 1e-8)
    return H + tau * jnp.eye(nz, dtype=dtype)


def _qp_params(f32: bool = False) -> LParameters:
    """Inner-QP settings: tight tolerances, polish for exact active sets.
    float32 runs get reachable tolerances (1e-9 is below the f32 noise
    floor and would force every subproblem to max-iter).  The polish is the
    per-instance dense one: every subproblem has its own P and A, so the
    shared-factorization polish would share nothing, and its float64 base
    inverse is built on the host (4096 Van der Pol subproblems on an H100:
    35 ms dense against 236 ms shared, same solved share)."""
    if f32:
        return LParameters(
            maximum_iteration=500,
            enable_warm_start=True,
            eps_abs=5e-6,
            eps_rel=5e-6,
            eps_prim_inf=1e-5,
            eps_dual_inf=1e-5,
            # the polish snaps the returned direction onto the active set
            # — without it the 5e-6-tolerance f32 directions leave the
            # outer iterate ~1e-5 infeasible at termination on
            # long-horizon problems (the oversize-fused fallback cases)
            polish=True,
            polish_mode="dense",
            adaptive_rho=True,
            check_termination=25,
            scaling_iters=10,
            rho=0.1,
        )
    return LParameters(
        maximum_iteration=1000,
        enable_warm_start=True,
        eps_abs=1e-9,
        eps_rel=1e-9,
        eps_prim_inf=1e-6,
        eps_dual_inf=1e-6,
        polish=True,
        polish_mode="dense",
        adaptive_rho=True,
        check_termination=25,
        scaling_iters=10,  # subproblem Hessians can be badly scaled
        rho=0.1,
    )


_BANDED_CURVATURE = ("gauss_newton", "gershgorin", "power")


def inner_engine(
    params: NLParameters, dtype, nz: int, me: int, mi: int,
    traj_plan: Optional[trajectory_kkt.TrajPlan] = None,
    backend: Optional[str] = None,
) -> str:
    """The inner-QP engine a solve runs: "fused", "riccati", "pdip" or
    "admm".  The one place that decides it (ops/sqp.py and rollout.py both
    ask here).

    * "fused" (the default request) runs the fused kernel
      (ops/qp_inner_pallas.py) where it exists: float32 on a GPU, at widths
      the kernel takes.  Otherwise it becomes the banded interior point
      ("riccati") when the controller verified the banded structure, the
      inner ADMM for float32 problems too wide for the kernel, and the dense
      interior point ("pdip") for float64 or where the kernel does not
      compile (the CPU).
    * "riccati" needs a verified plan whose shapes match and a curvature
      mode that keeps the band (eigh fills in V W V'; bfgs is dense by
      construction); without one it degrades to "pdip".
    * "pdip" and "admm" are taken as asked.
    """
    from ..utils.logger import Logger

    backend = backend or jax.default_backend()
    f32 = dtype == jnp.float32
    m_qp = me + mi + nz
    request = params.inner_qp
    plan_ok = (
        traj_plan is not None
        and params.hessian_reg in _BANDED_CURVATURE
        and me == traj_plan.ph * traj_plan.nx
        and mi == traj_plan.mi
        and nz == traj_plan.nz
    )
    if request == "fused":
        fits = qp_inner_pallas.supported(nz, m_qp)
        if f32 and fits and backend == "gpu":
            return "fused"
        engine = (
            "riccati" if plan_ok else "admm" if f32 and not fits else "pdip"
        )
        Logger.instance().info(
            f'inner_qp="fused" runs the "{engine}" engine here (float32 '
            f"{f32}, widths ({nz}, {m_qp}) fit the kernel {fits}, "
            f"backend {backend})"
        )
        return engine
    if request == "riccati":
        return "riccati" if plan_ok else "pdip"
    return request


def sqp_solve(
    f_fn: Callable,  # f_fn(z) -> scalar objective
    ceq_fn: Callable,  # ceq_fn(z) -> (me,) equality residuals (== 0)
    cin_fn: Optional[Callable],  # cin_fn(z) -> (mi,) inequalities (<= 0)
    z0: jax.Array,
    lb: jax.Array,
    ub: jax.Array,
    params: NLParameters,
    iter_budget: Optional[jax.Array] = None,
    carry_in=None,
    it_hi: Optional[jax.Array] = None,
    return_carry: bool = False,
    traj_plan: Optional[trajectory_kkt.TrajPlan] = None,
):
    """Solve  min f(z)  s.t.  ceq(z)=0, cin(z)<=0, lb<=z<=ub  from z0.

    All callables must be JAX-traceable; x0/refs enter through their
    closures.  ``vmap`` over instances batches everything, including the
    inner QP and the Hessian eigendecompositions.

    ``iter_budget`` is a *traced* SQP-iteration cap implementing the
    ``time_limit`` contract (reference: NLMPC sets nlopt maxtime,
    NLMPC.hpp via Types.hpp:108-110); instances stopped by it report
    ``NLOPT_MAXTIME_REACHED`` (NLOptimizer.hpp:744-746).

    Resumable execution (used by the controller-level straggler
    compaction): ``carry_in`` continues a previous partial run instead of
    initializing from ``z0`` (``z0`` still supplies shapes/closure probes);
    ``it_hi`` pauses the loop once ``carry.it`` reaches it (a *traced*
    bound — the iterate is NOT finalized, statuses stay 0 for unconverged
    instances); ``return_carry=True`` returns the raw loop carry for a
    later resume instead of an :class:`SQPSolution`.  Chunking the loop
    this way partitions the exact same per-instance iteration sequence.

    Runs at ``highest`` matmul precision (IEEE float32 on a GPU, no TF32):
    reduced-precision matmul passes cannot drive an optimizer to 1e-7
    stationarity.
    """
    with jax.default_matmul_precision("highest"):
        return _sqp_solve_hp(
            f_fn, ceq_fn, cin_fn, z0, lb, ub, params, iter_budget,
            carry_in=carry_in, it_hi=it_hi, return_carry=return_carry,
            traj_plan=traj_plan,
        )


def _sqp_solve_hp(
    f_fn, ceq_fn, cin_fn, z0, lb, ub, params, iter_budget=None,
    carry_in=None, it_hi=None, return_carry=False, traj_plan=None,
):
    nz = z0.shape[0]
    dtype = z0.dtype
    me = ceq_fn(z0).shape[0]
    mi = cin_fn(z0).shape[0] if cin_fn is not None else 0
    m_qp = me + mi + nz

    grad_f = jax.value_and_grad(f_fn)
    jac_eq = jax.jacfwd(ceq_fn)
    jac_in = jax.jacfwd(cin_fn) if cin_fn is not None else None

    use_bfgs = params.hessian_reg == "bfgs"
    use_gn = params.hessian_reg == "gauss_newton"
    if use_bfgs or use_gn:
        hess_L = None
    else:
        def lagrangian(z, lam_e, lam_i):
            L = f_fn(z) + jnp.dot(lam_e, ceq_fn(z))
            if cin_fn is not None:
                L = L + jnp.dot(lam_i, cin_fn(z))
            return L

        hess_L = jax.hessian(lagrangian)

    f32 = dtype == jnp.float32
    engine = inner_engine(params, dtype, nz, me, mi, traj_plan)
    use_traj = engine == "riccati"
    use_pdip = engine == "pdip"
    use_fused = engine == "fused"
    qp_par = _qp_params(f32)
    if use_fused:
        # the whole inner-QP batch in one fused kernel per SQP iteration
        fused_solve = qp_inner_pallas.make_inner_qp_solver(
            n_eq=me,
            rho=qp_par.rho,
            sigma=1e-5,
            alpha=qp_par.alpha,
            eps_abs=max(qp_par.eps_abs, 5e-6),
            eps_rel=max(qp_par.eps_rel, 5e-6),
            # warm-started SQP subproblems converge in a few check blocks
            max_iter=min(qp_par.maximum_iteration, 300),
            check_every=qp_par.check_termination,
        )
    acc = 1e-5 if f32 else _INTERNAL_ACC
    eq_mask = jnp.arange(m_qp) < me
    big = jnp.asarray(1e20, dtype)
    finite_lb = jnp.maximum(lb, -big)
    finite_ub = jnp.minimum(ub, big)

    def constraint_viol(ce, ci):
        return jnp.max(
            jnp.concatenate(
                [jnp.abs(ce), jnp.maximum(ci, 0.0), jnp.zeros((1,), dtype)]
            )
        )

    def merit_terms(z):
        f = f_fn(z)
        ce = ceq_fn(z)
        ci = cin_fn(z) if cin_fn is not None else jnp.zeros((0,), dtype)
        return f, ce, ci

    if carry_in is not None:
        init = Carry(*carry_in)  # resume a previous partial run
    else:
        init = None
    f0, ce0, ci0 = merit_terms(z0) if init is None else (None, None, None)
    init = init if init is not None else Carry(
        z=z0,
        lam_e=jnp.zeros((me,), dtype),
        lam_i=jnp.zeros((mi,), dtype),
        f=f0,
        mu_e=jnp.full((me,), 1.0, dtype),
        mu_i=jnp.full((mi,), 1.0, dtype),
        it=jnp.asarray(0, jnp.int32),
        status=jnp.asarray(0, jnp.int32),
        ls_fails=jnp.asarray(0, jnp.int32),
        viol=constraint_viol(ce0, ci0),
        qp_x=jnp.zeros((nz,), dtype),
        qp_y=jnp.zeros((m_qp,), dtype),
        f_best=f0,
        viol_best=constraint_viol(ce0, ci0),
        stall=jnp.asarray(0, jnp.int32),
        Bmat=jnp.eye(nz, dtype=dtype),
        z_prev=z0,
        g_prev=jnp.zeros((nz,), dtype),
        Je_prev=jnp.zeros((me, nz), dtype),
        Ji_prev=jnp.zeros((mi, nz), dtype),
        have_prev=jnp.asarray(False),
        have_scaled=jnp.asarray(False),
    )

    gn_blocks = None
    if use_gn:
        # Gauss-Newton curvature: the OBJECTIVE Hessian only, constraint
        # curvature dropped — the classic real-time-iteration model for MPC,
        # where the tracking cost is quadratic in the trajectory and the
        # model nonlinearity lives entirely in the defect constraints
        # (reference formulation: include/mpc/NLMPC/Objective.hpp:91-101 +
        # Constraints.hpp:490-628).  For quadratic costs this matrix is
        # CONSTANT, so it is evaluated once per solve at the entry iterate
        # and reused by every SQP iteration: per-iteration cost drops from
        # the dense O(nz^2)-autodiff Lagrangian Hessian + O(nz^3) eigh to
        # Jacobians + the QP alone — the scaling mode for large problems
        # (e.g. networked oscillators, nz=301).  For non-quadratic costs it
        # is a fixed Gauss-Newton-style model anchored at the entry point;
        # the l1-merit line search keeps the outer loop globalized either
        # way.  Anchored at ``z0`` (not the resume carry) so chunked
        # execution (begin/chunk/finish share one z0) reuses the identical
        # curvature and preserves the per-instance iteration sequence.
        Hf = jax.hessian(f_fn)(z0)
        B_gn = _gershgorin_convexify(0.5 * (Hf + Hf.T), nz, dtype)
        # banded engine: the stage-block extraction of the CONSTANT
        # curvature matrix hoists out of the SQP loop entirely (done here,
        # once per solve; ipm_solve would otherwise re-gather it every
        # iteration — XLA does not hoist across its while loop)
        gn_blocks = (
            trajectory_kkt._h_blocks(traj_plan, B_gn) if use_traj else None
        )

    def body(s: Carry) -> Carry:
        f, g = grad_f(s.z)
        ce = ceq_fn(s.z)
        Je = jac_eq(s.z)
        if cin_fn is not None:
            ci = cin_fn(s.z)
            Ji = jac_in(s.z)
        else:
            ci = jnp.zeros((0,), dtype)
            Ji = jnp.zeros((0, nz), dtype)

        if use_bfgs:
            # -- damped BFGS curvature model (Powell's rule) ----------------
            # the reference's SLSQP is itself a damped-BFGS SQP (NLopt
            # LD_SLSQP; NLOptimizer.hpp:64) — this is the algorithm-parity
            # mode AND the fast mode: no Lagrangian Hessian, no eigh.
            # y uses multipliers fixed at the *current* estimate:
            # y = grad_z L(z, lam) - grad_z L(z_prev, lam), both sides
            # contracted with the same lam
            gL = g + s.lam_e @ Je + (s.lam_i @ Ji if mi else 0.0)
            gL_old = (
                s.g_prev
                + s.lam_e @ s.Je_prev
                + (s.lam_i @ s.Ji_prev if mi else 0.0)
            )
            sv = s.z - s.z_prev
            y = gL - gL_old
            # Shanno-Phua sizing on the first curvature pair: replace the
            # unit initialization with gamma*I, gamma = y'y/s'y, so the
            # model starts at the right scale (classic quasi-Newton warm-up;
            # cuts several early iterations)
            sy_raw = jnp.dot(sv, y)
            gamma = jnp.clip(
                jnp.dot(y, y) / jnp.where(sy_raw <= 0.0, 1.0, sy_raw),
                1e-3,
                1e6,
            )
            first_pair = ~s.have_scaled & (sy_raw > 0.0)
            Bbase = jnp.where(
                first_pair, gamma * jnp.eye(nz, dtype=dtype), s.Bmat
            )
            Bs = Bbase @ sv
            sBs = jnp.dot(sv, Bs)
            sy = sy_raw
            theta = jnp.where(
                sy >= 0.2 * sBs,
                1.0,
                0.8 * sBs / jnp.where(sBs - sy == 0.0, 1.0, sBs - sy),
            )
            yd = theta * y + (1.0 - theta) * Bs
            syd = jnp.dot(sv, yd)
            ok_upd = (
                s.have_prev
                & (sBs > 1e-12)
                & (syd > 1e-12)
                & (jnp.max(jnp.abs(sv)) > 0.0)
            )
            B_upd = (
                Bbase
                - jnp.outer(Bs, Bs) / jnp.where(sBs == 0.0, 1.0, sBs)
                + jnp.outer(yd, yd) / jnp.where(syd == 0.0, 1.0, syd)
            )
            B = jnp.where(ok_upd, B_upd, s.Bmat)
        elif use_gn:
            B = B_gn  # constant objective-curvature model (see above)
        else:
            # -- convexified exact Hessian ----------------------------------
            H = hess_L(s.z, s.lam_e, s.lam_i)
            H = 0.5 * (H + H.T)
            if params.hessian_reg == "gershgorin":
                B = _gershgorin_convexify(H, nz, dtype)
            elif params.hessian_reg == "power":
                # shift by a *tight* estimate of -lambda_min obtained with
                # two short power iterations (pure batched matvecs, no
                # factorization, no eigh).  Near a solution H
                # is PSD, the shift collapses to the floor and the steps
                # match the exact-Newton ones.
                eye = jnp.eye(nz, dtype=dtype)
                v0 = jnp.ones((nz,), dtype) + jnp.arange(nz, dtype=dtype) / nz

                def pow_iter(M, v, steps=12):
                    def one(_, v):
                        w = M @ v
                        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)
                    v = jax.lax.fori_loop(0, steps, one, v)
                    return jnp.dot(v, M @ v), v

                lam_hi, _ = pow_iter(H, v0)
                lam_hi = jnp.abs(lam_hi) * 1.01 + 1e-8
                # lambda_min(H) = lam_hi - lambda_max(lam_hi*I - H)
                lam_sh, _ = pow_iter(lam_hi * eye - H, v0)
                lam_min = lam_hi - lam_sh
                scale = jnp.maximum(lam_hi, 1e-8)
                tau = jnp.maximum(-lam_min, 0.0) * 1.2 + jnp.maximum(
                    1e-6 * scale, 1e-8
                )
                B = H + tau * eye
            else:
                # clip eigenvalues to a 1e-6-relative floor: the tightest
                # convex model of H (costs an eigh per iteration)
                w, V = jnp.linalg.eigh(H)
                tau = jnp.maximum(1e-8, 1e-6 * jnp.max(jnp.abs(w)))
                B = (V * jnp.maximum(w, tau)[None, :]) @ V.T

        # -- QP subproblem:  min 1/2 d'Bd + g'd
        #    s.t. Je d = -ce ; Ji d <= -ci ; lb-z <= d <= ub-z ---------------
        if use_traj:
            # banded-KKT interior point: the same elastic-relaxed Mehrotra
            # IPM as the pdip engine (verified identical to machine
            # precision, tests/test_trajectory_kkt.py), with every Newton
            # system solved by the stage recursion instead of dense
            # inverses.  Box bounds stay implicit (diagonal barrier
            # weights), so no (2nz, nz) identity rows are materialized.
            ci_pos = jnp.maximum(ci, 0.0)
            dual_scale = (
                jnp.max(jnp.concatenate([
                    jnp.abs(s.lam_e), jnp.abs(s.lam_i),
                    s.mu_e, s.mu_i, jnp.ones((1,), dtype),
                ]))
            )
            rho_q = (1e4 if f32 else 1e8) * dual_scale * (
                1.0 + jnp.sum(jnp.abs(ce)) + jnp.sum(ci_pos)
            )
            # IPM cap policy.  Default: a flat 45 (on the nz=301
            # oscillator bench a flat 30 lost success: truncated directions
            # fail the line search).  Per-lane escalation (inner_iters <
            # inner_iters_recovery: a lane whose previous direction failed
            # the line search gets the deep cap, folded into the done mask
            # so the compiled loop keeps a static trip bound) measured
            # slower: under vmap the lockstep batch pays the max lane's cap
            # every step, and failing lanes are per-step common.  The knobs
            # remain for problem families with genuinely rare deep lanes;
            # the two-phase path is the rollout-level compacted rescue
            # (NLParameters.rescue_iters).  Not measured on the H100.
            it_base = params.inner_iters or 45
            # clamp: a recovery cap below the base would DE-escalate the
            # struggling lanes (the measured flat-30 failure mode)
            it_deep = max(params.inner_iters_recovery or it_base, it_base)
            ipm_cap = jnp.where(
                s.ls_fails > 0, it_deep, it_base
            ).astype(jnp.int32)
            ip = trajectory_kkt.ipm_solve(
                traj_plan, B, g, Je, ce, Ji, ci,
                lb - s.z, ub - s.z, rho_q,
                n_iters=max(it_base, it_deep),
                lane_cap=ipm_cap,
                eps=1e-7 if f32 else 1e-10,
                h_blocks=gn_blocks if use_gn else None,
                # NO dual warm start: carrying the previous subproblem's
                # clamped duals was measured SLOWER end-to-end (224 -> 151
                # closed-loop solves/s on the nz=301 oscillator bench) —
                # the non-central start degrades the Mehrotra steps and
                # the resulting directions cost extra SQP iterations
                # (5.3 -> 6.7 mean).  ipm_solve's warm_y hook remains for
                # problem families where it pays.
                warm_y=None,
            )
            ip_ok = (
                jnp.all(jnp.isfinite(ip.d))
                & jnp.all(jnp.isfinite(ip.nu))
                & jnp.all(jnp.isfinite(ip.lam))
            )
            d = jnp.where(ip_ok, ip.d, 0.0)
            lam_e = jnp.where(ip_ok, ip.nu, s.lam_e)
            lam_i = jnp.where(ip_ok, ip.lam, s.lam_i)
            qp_x_new = d
            qp_y_new = s.qp_y
        elif use_pdip:
            # interior-point engine: box bounds folded into inequality rows
            # (+-identity), infinite bounds masked out of the barrier.
            #
            # Elastic relaxation (the analog of SLSQP's augmented problem
            # for inconsistent linearizations, Kraft's slsqp.f "relaxed
            # problem with bound on x(n1)"): one extra FREE variable xi
            # retreats every constraint toward its value at d=0, so the
            # subproblem is ALWAYS feasible (d=0, xi=1 satisfies it) — an
            # interior-point method fails outright on an inconsistent QP
            # that ADMM merely solves approximately.  Unlike Kraft's
            # bounded-xi/linear-penalty form (which plants a degenerate
            # complementarity pair at xi=0 that stalls an IPM), xi here is
            # unconstrained with a large QUADRATIC penalty: at the optimum
            # xi = (nu'ce + lam'ci+)/rho_q, so the equality bias
            # xi*|ce| ~ (dual/rho_q)*|ce|^2 vanishes QUADRATICALLY in the
            # constraint violation — the same order as the linearization
            # error, preserving the SQP's Newton-rate constraint
            # convergence while costing no extra rows.
            ci_pos = jnp.maximum(ci, 0.0)
            dual_scale = (
                jnp.max(jnp.concatenate([
                    jnp.abs(s.lam_e), jnp.abs(s.lam_i),
                    s.mu_e, s.mu_i, jnp.ones((1,), dtype),
                ]))
            )
            rho_q = (1e4 if f32 else 1e8) * dual_scale * (
                1.0 + jnp.sum(jnp.abs(ce)) + jnp.sum(ci_pos)
            )
            zero_col = jnp.zeros((nz, 1), dtype)
            B_aug = (
                jnp.zeros((nz + 1, nz + 1), dtype)
                .at[:nz, :nz].set(B)
                .at[nz, nz].set(rho_q)
            )
            g_aug = jnp.concatenate([g, jnp.zeros((1,), dtype)])
            Je_aug = jnp.concatenate([Je, -ce[:, None]], axis=1)
            Ji_all = jnp.concatenate(
                [
                    jnp.concatenate([Ji, -ci_pos[:, None]], axis=1),
                    jnp.concatenate([jnp.eye(nz, dtype=dtype), zero_col], axis=1),
                    jnp.concatenate([-jnp.eye(nz, dtype=dtype), zero_col], axis=1),
                ],
                axis=0,
            )
            bi_all = jnp.concatenate([-ci, finite_ub - s.z, s.z - finite_lb])
            mask_all = jnp.concatenate(
                [jnp.ones((mi,), bool), jnp.isfinite(ub), jnp.isfinite(lb)]
            )
            ip = pdip.pdip_solve(
                B_aug, g_aug, Je_aug, -ce, Ji_all, bi_all, mask_all,
                n_iters=30, eps=1e-7 if f32 else 1e-10,
            )
            # defensive: a degenerate subproblem must not poison the outer
            # iteration — a zero direction is simply rejected by the line
            # search and the multiplier estimates keep their last values
            ip_ok = (
                jnp.all(jnp.isfinite(ip.d))
                & jnp.all(jnp.isfinite(ip.nu))
                & jnp.all(jnp.isfinite(ip.lam))
            )
            d = jnp.where(ip_ok, ip.d[:nz], 0.0)
            lam_e = jnp.where(ip_ok, ip.nu, s.lam_e)
            lam_i = jnp.where(ip_ok, ip.lam[:mi], s.lam_i)
            qp_x_new = d
            qp_y_new = s.qp_y
        elif use_fused:
            # fused Pallas ADMM: the whole batch of inner QPs solves in one
            # kernel launch (ops/qp_inner_pallas.py) — Ruiz in XLA, KKT
            # inverse, iteration loop and adaptive rho in the kernel
            A_qp = jnp.concatenate([Je, Ji, jnp.eye(nz, dtype=dtype)], axis=0)
            l_qp = jnp.concatenate(
                [-ce, jnp.full((mi,), -jnp.inf, dtype), finite_lb - s.z]
            )
            u_qp = jnp.concatenate([-ce, -ci, finite_ub - s.z])
            x_f, y_f, _zf, _qi, _qd, _qp, _qdu = fused_solve(
                B, A_qp, g, l_qp, u_qp, s.qp_x, s.qp_y
            )
            qp_ok = jnp.all(jnp.isfinite(x_f)) & jnp.all(jnp.isfinite(y_f))
            d = jnp.where(qp_ok, x_f, 0.0)
            lam_e = jnp.where(qp_ok, y_f[:me], s.lam_e)
            lam_i = jnp.where(qp_ok, y_f[me : me + mi], s.lam_i)
            qp_x_new = d
            qp_y_new = jnp.where(qp_ok, y_f, s.qp_y)
        else:
            A_qp = jnp.concatenate([Je, Ji, jnp.eye(nz, dtype=dtype)], axis=0)
            l_qp = jnp.concatenate(
                [-ce, jnp.full((mi,), -jnp.inf, dtype), finite_lb - s.z]
            )
            u_qp = jnp.concatenate([-ce, -ci, finite_ub - s.z])
            # warm-start each subproblem from the previous SQP iteration's
            # direction/duals — across iterations the QP changes slowly, so
            # the inner ADMM typically converges in a fraction of the cold
            # iterations
            sol = admm.admm_solve(
                B, A_qp, g, l_qp, u_qp, params=qp_par, eq_mask=eq_mask,
                warm_x=s.qp_x, warm_y=s.qp_y,
            )
            d = sol.x
            lam_e = sol.y[:me]
            lam_i = sol.y[me : me + mi]
            qp_x_new = sol.x
            qp_y_new = sol.y

        # -- penalty update (SLSQP rule: mu = max(|lam|, (mu+|lam|)/2));
        # after a stalled line search, drop the accumulated history and
        # restart from the current multipliers (stale-large penalties are a
        # classic cause of persistent step rejection near active sets) ------
        stalled = s.ls_fails > 0
        mu_e = jnp.where(
            stalled,
            jnp.abs(lam_e) + 1.0,
            jnp.maximum(jnp.abs(lam_e), 0.5 * (s.mu_e + jnp.abs(lam_e))),
        )
        mu_i = jnp.where(
            stalled,
            jnp.abs(lam_i) + 1.0,
            jnp.maximum(jnp.abs(lam_i), 0.5 * (s.mu_i + jnp.abs(lam_i))),
        )

        # -- line search over the step ladder + one SOC candidate ------------
        def phi(fv, cev, civ):
            return (
                fv
                + jnp.sum(mu_e * jnp.abs(cev))
                + jnp.sum(mu_i * jnp.maximum(civ, 0.0))
            )

        viol0 = jnp.sum(mu_e * jnp.abs(ce)) + jnp.sum(mu_i * jnp.maximum(ci, 0.0))
        phi0 = f + viol0
        D = jnp.dot(g, d) - viol0

        # second-order correction: after a unit step, remove the remaining
        # (curvature-induced) equality residual with a least-norm correction.
        # Computed ONCE per iteration, outside the line-search loop: under
        # vmap a lax.cond inside the loop body lowers to a select that runs
        # the correction (constraint evaluation + batched solve) on EVERY
        # trial — measured 4x slower than the unconditional hoisted form.
        ce_full = ceq_fn(s.z + d)
        if me <= _SOC_DENSE_MAX_ROWS:
            JJt = Je @ Je.T + 1e-10 * jnp.eye(me, dtype=dtype)
            soc_corr = jax.scipy.linalg.cho_solve(
                jax.scipy.linalg.cho_factor(JJt, lower=True), ce_full
            )
        else:
            # many equality rows (e.g. networked oscillators: me = ph*nx =
            # 240): matrix-free CG on Je Je' — two (me, nz) matvecs per
            # iteration, never forms or factors the dense me^2 system.  The
            # SOC is a trial candidate, not the step itself, so a
            # fixed-iteration approximate solve is sufficient; a poor
            # candidate just loses the line search.
            def _cg_mv(v):
                return Je @ (v @ Je) + 1e-10 * v

            def _cg_body(_, c):
                x, r, p, rs = c
                Ap = _cg_mv(p)
                alpha = rs / jnp.maximum(jnp.dot(p, Ap), 1e-30)
                x = x + alpha * p
                r = r - alpha * Ap
                rs_new = jnp.dot(r, r)
                p = r + (rs_new / jnp.maximum(rs, 1e-30)) * p
                return (x, r, p, rs_new)

            x_cg = jnp.zeros((me,), dtype)
            r0 = ce_full
            # 16 iterations (was 40): the SOC is a line-search trial
            # candidate, not the step — a ~1e-2-relative least-norm
            # correction already removes the curvature-induced residual
            # well enough to pass Armijo, and the 40-iteration chain was
            # pure sequential latency per SQP iteration (each CG step is
            # two (me, nz) matvecs that cannot overlap)
            x_cg, _, _, _ = jax.lax.fori_loop(
                0, 16, _cg_body, (x_cg, r0, r0, jnp.dot(r0, r0))
            )
            soc_corr = x_cg
        d_soc = d - Je.T @ soc_corr

        # -- lazy backtracking line search ------------------------------
        # Candidates in order [alpha=1, SOC, 1/2, 1/4, ..., 2^-(K-2)]; each
        # while-loop trial evaluates the merit ONCE and stops at the first
        # Armijo-passing candidate (SOC judged as a unit step).  Near
        # convergence the unit step passes immediately, so a solve costs ~1
        # merit evaluation per iteration instead of the previous fixed 13.
        # (A candidate axis via nested vmap is avoided deliberately: under a
        # fleet vmap it would triple-nest the user model.)
        class LS(NamedTuple):
            t: jax.Array
            done: jax.Array
            z_acc: jax.Array
            f_acc: jax.Array
            ce_acc: jax.Array
            ci_acc: jax.Array
            best_phi: jax.Array

        def ls_body(ls: LS) -> LS:
            alpha = 2.0 ** -jnp.maximum(ls.t - 1, 0).astype(dtype)
            cand = jnp.where(ls.t == 1, s.z + d_soc, s.z + alpha * d)
            fc, cec, cic = merit_terms(cand)
            phic = phi(fc, cec, cic)
            # the strict phi0 guard matters when D = g.d - mu.viol0 > 0 (an
            # inexact QP direction at an infeasible iterate): the Armijo
            # threshold then sits ABOVE phi0 and would accept a
            # merit-increasing step
            passed = (phic <= phi0 + _ARMIJO_C1 * alpha * D) & (phic < phi0)
            take = passed | (phic < ls.best_phi)
            return LS(
                t=ls.t + 1,
                done=passed,
                z_acc=jnp.where(take, cand, ls.z_acc),
                f_acc=jnp.where(take, fc, ls.f_acc),
                ce_acc=jnp.where(take, cec, ls.ce_acc),
                ci_acc=jnp.where(take, cic, ls.ci_acc),
                best_phi=jnp.minimum(phic, ls.best_phi),
            )

        ls0 = LS(
            t=jnp.asarray(0, jnp.int32),
            done=jnp.asarray(False),
            z_acc=s.z,
            f_acc=f,
            ce_acc=ce,
            ci_acc=ci,
            # start at phi0 so the accumulator only ever holds candidates
            # that strictly improve on the current iterate
            best_phi=phi0,
        )
        ls = jax.lax.while_loop(
            lambda ls: ~ls.done & (ls.t < _LS_STEPS + 1), ls_body, ls0
        )
        decreased = ls.done | (ls.best_phi < phi0)
        z_new = jnp.where(decreased, ls.z_acc, s.z)
        f_new = jnp.where(decreased, ls.f_acc, f)
        ls_fails = jnp.where(decreased, 0, s.ls_fails + 1)
        viol_new = jnp.where(
            decreased, constraint_viol(ls.ce_acc, ls.ci_acc), s.viol
        )
        step_norm = jnp.max(jnp.abs(z_new - s.z))

        # -- convergence tests ------------------------------------------------
        scale = 1.0 + jnp.max(jnp.abs(s.z))
        kkt_ok = (jnp.max(jnp.abs(d)) <= acc * scale) & (
            s.viol <= jnp.sqrt(acc)
        )
        df = jnp.abs(f_new - f)
        ftol_ok = jnp.asarray(False)
        if params.absolute_ftol > 0:
            ftol_ok = ftol_ok | (df <= params.absolute_ftol)
        if params.relative_ftol > 0:
            ftol_ok = ftol_ok | (df <= params.relative_ftol * jnp.abs(f_new))
        xtol_ok = jnp.asarray(False)
        if params.absolute_xtol > 0:
            xtol_ok = xtol_ok | (step_norm <= params.absolute_xtol)
        if params.relative_xtol > 0:
            xtol_ok = xtol_ok | (
                step_norm <= params.relative_xtol * jnp.max(jnp.abs(z_new))
            )
        near_feas = viol_new <= jnp.sqrt(acc)
        # stagnation detector: at the working precision's noise floor the
        # merit can bounce by +-eps-level amounts forever (each tiny
        # decrease resets ls_fails, so the consecutive-failure exit never
        # fires); declare roundoff-limited after _MAX_STALL iterations in
        # which neither the objective nor the violation improved by more
        # than a ~30-ulp margin — the analog of SLSQP's acc-based exit
        eps_m = 1.2e-7 if f32 else 2.2e-16
        tol_f = 32.0 * eps_m * (1.0 + jnp.abs(s.f_best))
        tol_v = 32.0 * eps_m * (1.0 + jnp.abs(s.viol_best))
        improved = (f_new < s.f_best - tol_f) | (viol_new < s.viol_best - tol_v)
        stall = jnp.where(improved, 0, s.stall + 1)
        roundoff = (ls_fails >= _MAX_LS_FAILS) | (stall >= _MAX_STALL)

        status = jnp.where(
            kkt_ok,
            NLOPT_SUCCESS,
            jnp.where(
                decreased & ftol_ok & near_feas,
                NLOPT_FTOL_REACHED,
                jnp.where(
                    decreased & xtol_ok & near_feas,
                    NLOPT_XTOL_REACHED,
                    jnp.where(roundoff, NLOPT_ROUNDOFF_LIMITED, 0),
                ),
            ),
        ).astype(jnp.int32)

        # freeze terminated instances: under vmap the while_loop keeps
        # applying the body to the whole batch until EVERY instance's cond
        # is false — without this gate a converged instance would keep
        # taking (noise-level) steps and its freshly recomputed status
        # could flip back to 0, un-converging it and dragging the entire
        # batch to maximum_iteration
        act = s.status == 0
        return Carry(
            z=jnp.where(act, z_new, s.z),
            lam_e=jnp.where(act, lam_e, s.lam_e),
            lam_i=jnp.where(act, lam_i, s.lam_i),
            f=jnp.where(act, f_new, s.f),
            mu_e=jnp.where(act, mu_e, s.mu_e),
            mu_i=jnp.where(act, mu_i, s.mu_i),
            it=s.it + jnp.where(act, 1, 0),
            status=jnp.where(act, status, s.status),
            ls_fails=jnp.where(act, ls_fails, s.ls_fails),
            viol=jnp.where(act, viol_new, s.viol),
            qp_x=jnp.where(act, qp_x_new, s.qp_x),
            qp_y=jnp.where(act, qp_y_new, s.qp_y),
            f_best=jnp.where(act, jnp.minimum(s.f_best, f_new), s.f_best),
            viol_best=jnp.where(
                act, jnp.minimum(s.viol_best, viol_new), s.viol_best
            ),
            stall=jnp.where(act, stall, s.stall),
            Bmat=jnp.where(act, B, s.Bmat) if use_bfgs else s.Bmat,
            z_prev=jnp.where(act, s.z, s.z_prev),
            g_prev=jnp.where(act, g, s.g_prev),
            Je_prev=jnp.where(act, Je, s.Je_prev),
            Ji_prev=jnp.where(act, Ji, s.Ji_prev),
            have_prev=s.have_prev | act,
            have_scaled=s.have_scaled | (act & ok_upd if use_bfgs else False),
        )

    budget = jnp.asarray(
        admm.NO_BUDGET if iter_budget is None else iter_budget, jnp.int32
    )
    hi = jnp.asarray(
        params.maximum_iteration if it_hi is None else it_hi, jnp.int32
    )

    def cond(s: Carry):
        return (
            (s.status == 0)
            & (s.it < params.maximum_iteration)
            & (s.it < budget)
            & (s.it < hi)
        )

    out = jax.lax.while_loop(cond, body, init)
    if return_carry:
        return out
    # status still 0 with iterations to spare means the traced budget (the
    # time_limit contract) stopped the loop, not maximum_iteration
    status = jnp.where(
        out.status == 0,
        jnp.where(
            out.it < params.maximum_iteration,
            NLOPT_MAXTIME_REACHED,
            NLOPT_MAXEVAL_REACHED,
        ),
        out.status,
    )
    # a "roundoff" exit at an already-feasible, stationary-ish point is a
    # successful solve in practice (the step simply could not improve the
    # merit any further) — matching how SLSQP reports small final steps
    status = jnp.where(
        (status == NLOPT_ROUNDOFF_LIMITED) & (out.viol <= jnp.sqrt(acc)),
        NLOPT_XTOL_REACHED,
        status,
    )

    return SQPSolution(
        z=out.z, obj=out.f, status=status, iters=out.it, kkt_res=out.viol
    )
