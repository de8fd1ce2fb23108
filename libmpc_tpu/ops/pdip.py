"""Primal-dual interior-point QP solver for small dense subproblems.

The SQP inner QP (ops/sqp.py) is tiny — tens of variables — but must be
solved to good accuracy at every SQP iteration.  The batched ADMM kernel
(ops/admm.py) is the right engine for the large LMPC QPs (one shared
factorization, thousands of instances), but for the *vmapped* SQP
subproblems its hundreds of lockstep iterations are sequential latency.  A
Mehrotra predictor-corrector IPM converges in ~15-25 iterations regardless
of warm start or conditioning; each iteration is two small Cholesky
factorizations plus matvecs, all of which batch under ``vmap``.

Problem form (one instance; ``vmap`` supplies the batch axis)::

    minimize    1/2 d'Bd + g'd
    subject to  Je d = be          (me equality rows)
                Ji d <= bi         (mi inequality rows, possibly padded)

``mask_i`` marks real inequality rows; padded/infinite rows are frozen out
of the barrier.  Box bounds are folded into Ji as +-identity rows by the
caller.  Returns OSQP-compatible status values so the SQP driver can treat
both inner engines uniformly (reference analog: the QP layer inside NLopt's
SLSQP, include/mpc/NLMPC/NLOptimizer.hpp:64).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import batched_linalg
from .admm import OSQP_MAX_ITER_REACHED, OSQP_SOLVED


class PDIPSolution(NamedTuple):
    d: jax.Array  # (nz,) primal
    nu: jax.Array  # (me,) equality duals
    lam: jax.Array  # (mi,) inequality duals (>= 0)
    gap: jax.Array  # final complementarity measure
    res: jax.Array  # final KKT residual (inf-norm)
    status: jax.Array  # int32
    iters: jax.Array  # int32


def pdip_solve(
    B: jax.Array,  # (nz, nz) PSD cost
    g: jax.Array,  # (nz,)
    Je: jax.Array,  # (me, nz)
    be: jax.Array,  # (me,)
    Ji: jax.Array,  # (mi, nz)
    bi: jax.Array,  # (mi,)
    mask_i: jax.Array,  # (mi,) bool: real inequality rows
    n_iters: int = 30,
    eps: float = 1e-8,
    eps_res: float = None,
    tau: float = 0.995,
    barrier_cap: float = None,
) -> PDIPSolution:
    """Mehrotra predictor-corrector IPM with per-instance convergence freeze.

    All shapes static; runs as a fixed ``fori_loop`` so a ``vmap``'d batch
    stays in lockstep (converged instances freeze).  Regularized KKT solves:
    ``H = B + Ji' diag(lam/s) Ji + reg_p I`` via Cholesky, equality block via
    the Schur complement ``Je H^-1 Je' + reg_d I``.
    """
    nz = B.shape[0]
    me = Je.shape[0]
    mi = Ji.shape[0]
    dtype = B.dtype
    f32 = dtype == jnp.float32
    if eps_res is None:
        # f32: ~30x unit roundoff — loose enough to be reachable, tight
        # enough that the returned step's constraint rows are satisfied
        # well inside the controllers' 1e-5-level feasibility tolerances
        eps_res = 3e-6 if f32 else 1e-10
    reg_p = jnp.asarray(1e-7 if f32 else 1e-10, dtype)
    reg_d = jnp.asarray(1e-7 if f32 else 1e-10, dtype)
    m_real = jnp.maximum(jnp.sum(mask_i), 1).astype(dtype)
    big = jnp.asarray(1e3, dtype)

    # strictly interior start: s, lam positive on real rows; frozen rows get
    # s=1, lam=0 and never enter the barrier
    d0 = jnp.zeros((nz,), dtype)
    s0 = jnp.where(mask_i, jnp.maximum(bi - Ji @ d0, 1.0), 1.0)
    lam0 = jnp.where(mask_i, 1.0, 0.0)
    nu0 = jnp.zeros((me,), dtype)

    def kkt_res(d, nu, lam):
        r_d = B @ d + g + nu @ Je + (lam * mask_i) @ Ji
        r_e = Je @ d - be
        r_i = jnp.where(mask_i, Ji @ d - bi, 0.0)  # <= 0 wanted
        return r_d, r_e, r_i

    class St(NamedTuple):
        d: jax.Array
        nu: jax.Array
        lam: jax.Array
        s: jax.Array
        done: jax.Array
        fail: jax.Array
        gap: jax.Array
        res: jax.Array
        it: jax.Array

    def body(st: St) -> St:
        d, nu, lam, s = st.d, st.nu, st.lam, st.s
        r_d, r_e, r_i_raw = kkt_res(d, nu, lam)
        # primal residual of the slack form: Ji d + s - bi = 0
        r_i = jnp.where(mask_i, Ji @ d + s - bi, 0.0)
        mu = jnp.sum(jnp.where(mask_i, lam * s, 0.0)) / m_real

        res = jnp.maximum(
            jnp.max(jnp.abs(r_d)),
            jnp.maximum(
                jnp.max(jnp.abs(r_e)) if me else jnp.asarray(0.0, dtype),
                jnp.max(jnp.maximum(r_i_raw, 0.0)) if mi else jnp.asarray(0.0, dtype),
            ),
        )
        conv = (mu < eps) & (res < eps_res)

        # cap the barrier diagonal: near a degenerate active constraint
        # (s -> 0 with small lam) the ratio lam/s is unbounded and the KKT
        # condition number exceeds what Cholesky survives in the working
        # precision; the cap trades late-stage quadratic convergence for a
        # bounded, factorizable system (standard IPM safeguard)
        cap = jnp.asarray(
            (1e6 if f32 else 1e12) if barrier_cap is None else barrier_cap,
            dtype,
        )
        lam_s = jnp.where(
            mask_i, jnp.minimum(lam / jnp.maximum(s, 1e-30), cap), 0.0
        )
        H = B + (Ji.T * lam_s[None, :]) @ Ji + reg_p * jnp.eye(nz, dtype=dtype)
        # float32: EXPLICIT inverses, so every downstream solve (predictor,
        # corrector, Schur pieces) is one matrix product; the barrier cap
        # above bounds the conditioning so the f32 inverse stays accurate
        # enough for the predictor-corrector (which re-derives residuals
        # exactly).  float64 keeps the factor+solve path.
        if f32:
            Hinv = batched_linalg.spd_inverse(H)
            _solve = lambda r: Hinv @ r
        else:
            cho = jax.scipy.linalg.cho_factor(H)
            _solve = lambda r: jax.scipy.linalg.cho_solve(cho, r)
        # the Schur pieces depend only on the factorization, not on the
        # residuals: build them ONCE per iteration — the predictor and
        # corrector solves share them (the (nz, me) solve pair is the
        # dominant per-iteration cost at large me)
        if me:
            HiJt = _solve(Je.T)  # (nz, me)
            S = Je @ HiJt + reg_d * jnp.eye(me, dtype=dtype)
            if f32:
                Sinv = batched_linalg.spd_inverse(0.5 * (S + S.T))
                _solveS = lambda r: Sinv @ r
            else:
                choS = jax.scipy.linalg.cho_factor(S)
                _solveS = lambda r: jax.scipy.linalg.cho_solve(choS, r)

        def kkt_solve(rd, re, rcomp):
            """Solve the reduced Newton system for given residuals.

            rcomp is the complementarity target residual: lam*s - target,
            eliminated as  ds = -(rcomp + s*dlam)/lam  ->
            dlam = (lam*(-r_i) - rcomp + lam*Ji dd) / s  (standard).
            """
            # eliminate (dlam, ds): substituting ds = -r_i - Ji dd and the
            # complementarity row into (1) gives
            #   (B + Ji' D Ji) dd + Je' dnu = -rd - Ji'[(lam r_i - rcomp)/s]
            rhs_d = -rd - ((lam * r_i - rcomp) / jnp.maximum(s, 1e-30) * mask_i) @ Ji
            if me:
                Hir = _solve(rhs_d)
                dnu = _solveS(Je @ Hir + re)
                dd = Hir - HiJt @ dnu
            else:
                dnu = jnp.zeros((0,), dtype)
                dd = _solve(rhs_d)
            dlam = jnp.where(
                mask_i,
                (lam * (Ji @ dd + r_i) - rcomp) / jnp.maximum(s, 1e-30),
                0.0,
            )
            ds = jnp.where(
                mask_i,
                -(rcomp + s * dlam) / jnp.maximum(lam, 1e-30),
                0.0,
            )
            return dd, dnu, dlam, ds

        def max_step(v, dv):
            """Largest alpha in (0,1] keeping v + alpha dv >= (1-tau) v."""
            ratio = jnp.where((dv < 0) & mask_i, -v / jnp.minimum(dv, -1e-30), big)
            return jnp.minimum(1.0, tau * jnp.min(ratio))

        # -- affine (predictor) step ------------------------------------
        rcomp_aff = jnp.where(mask_i, lam * s, 0.0)
        dd_a, dnu_a, dlam_a, ds_a = kkt_solve(r_d, r_e, rcomp_aff)
        a_lam = max_step(lam, dlam_a)
        a_s = max_step(s, ds_a)
        a_aff = jnp.minimum(a_lam, a_s)
        mu_aff = jnp.sum(
            jnp.where(mask_i, (lam + a_aff * dlam_a) * (s + a_aff * ds_a), 0.0)
        ) / m_real
        sigma = jnp.clip((mu_aff / jnp.maximum(mu, 1e-30)) ** 3, 0.0, 1.0)

        # -- corrector step (same factorization) ------------------------
        rcomp = jnp.where(mask_i, lam * s + dlam_a * ds_a - sigma * mu, 0.0)
        dd, dnu, dlam, ds = kkt_solve(r_d, r_e, rcomp)
        alpha = jnp.minimum(max_step(lam, dlam), max_step(s, ds))

        # freeze an instance whose Newton step degenerated to non-finite
        # values (extreme KKT conditioning): keep the last finite iterate
        # rather than poisoning the batch with NaNs
        step_ok = (
            jnp.all(jnp.isfinite(dd))
            & jnp.all(jnp.isfinite(dnu))
            & jnp.all(jnp.isfinite(dlam))
            & jnp.all(jnp.isfinite(ds))
            & jnp.isfinite(alpha)
        )
        fail = st.fail | (~st.done & ~conv & ~step_ok)
        done = st.done | conv | ~step_ok
        upd = ~done
        return St(
            d=jnp.where(upd, d + alpha * dd, d),
            nu=jnp.where(upd, nu + alpha * dnu, nu),
            lam=jnp.where(upd, lam + alpha * dlam, lam),
            s=jnp.where(upd, s + alpha * ds, s),
            done=done,
            fail=fail,
            # record the measured optimality metrics the moment an instance
            # freezes (they are computed from the pre-step, finite iterate)
            gap=jnp.where(st.done, st.gap, mu),
            res=jnp.where(st.done, st.res, res),
            it=st.it + jnp.where(st.done, 0, 1),
        )

    init = St(
        d=d0, nu=nu0, lam=lam0, s=s0,
        done=jnp.asarray(False),
        fail=jnp.asarray(False),
        gap=jnp.asarray(jnp.inf, dtype),
        res=jnp.asarray(jnp.inf, dtype),
        it=jnp.asarray(0, jnp.int32),
    )
    # early-exit loop: an instance stops iterating the moment it converges
    # (or degenerates); under ``vmap`` the while_loop runs until EVERY lane
    # is done, so a warm-started batch that converges in ~10 iterations no
    # longer pays for the full fixed budget (each iteration carries two
    # batched factorizations — the dominant inner-QP cost).
    st = jax.lax.while_loop(
        lambda st: ~st.done & (st.it < n_iters), body, init
    )
    # final residual refresh for instances that ran to the end
    r_d, r_e, r_i = kkt_res(st.d, st.nu, st.lam)
    mu = jnp.sum(jnp.where(mask_i, st.lam * st.s, 0.0)) / m_real
    res = jnp.maximum(
        jnp.max(jnp.abs(r_d)),
        jnp.maximum(
            jnp.max(jnp.abs(r_e)) if me else jnp.asarray(0.0, dtype),
            jnp.max(jnp.maximum(r_i, 0.0)) if mi else jnp.asarray(0.0, dtype),
        ),
    )
    gap = jnp.where(st.done, st.gap, mu)
    res = jnp.where(st.done, st.res, res)
    ok = (st.done & ~st.fail) | ((gap < 1e3 * eps) & (res < 1e2 * eps_res))
    return PDIPSolution(
        d=st.d,
        nu=st.nu,
        lam=st.lam,
        gap=gap,
        res=res,
        status=jnp.where(ok, OSQP_SOLVED, OSQP_MAX_ITER_REACHED).astype(jnp.int32),
        iters=st.it,
    )
