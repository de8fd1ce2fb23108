"""Trajectory-structured inner-QP engine: block-tridiagonal-arrowhead KKT.

The NLMPC decision vector has the reference's simultaneous trajectory layout
``z = [x_1..x_ph ; u_0..u_{ch-1} ; slack]`` (reference:
include/mpc/NLMPC/NLOptimizer.hpp:64), and its dynamics-defect Jacobian is
block-bidiagonal — defect ``k`` touches only ``(x_k, x_{k+1}, u_k)``
(reference: include/mpc/NLMPC/Constraints.hpp:610-615).  For stage-local
objectives and constraints the SQP subproblem's Newton/KKT matrix is
therefore *block-tridiagonal with a small arrowhead border* under a
stage-interleaved permutation — the discrete-time LQR/Riccati structure.

Dense algebra solves these subproblems with an ``O(nz^3)`` inverse per KKT
build and hundreds of lockstep ADMM iterations per subproblem.  This module
replaces that with:

* a **Mehrotra predictor-corrector IPM** (same algorithm as ops/pdip.py, so
  ~20 iterations replace ~500 ADMM iterations), whose Newton systems are

* solved by a **bordered block-tridiagonal LDL^T**: stage blocks
  ``s_k = [x_{k+1}; u_k; lambda_k]`` eliminate in one sweep over the
  horizon (ph quasi-definite pivot inverses of size ``2*nx+nu``, each two
  SPD inverses),
  with the held control move, the slack and the elastic variable in a
  ``(nu+2)``-wide arrowhead border — ``O(ph*(2nx+nu)^3)`` per factorization
  instead of ``O(nz^3)``.

Structure is *verified, not assumed*: :func:`make_plan` probes the user
callbacks' Jacobian/Hessian sparsity at random points and returns ``None``
(dense fallback) when any inequality row or Hessian entry couples
non-adjacent stages.  The quasi-definite pivot blocks are stable to
eliminate without pivoting (Vanderbei, "Symmetric quasi-definite matrices",
SIAM J. Optim. 5, 1995: every symmetric permutation of a quasi-definite
matrix has an LDL^T whose Schur complements inherit the per-slot signs).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import batched_linalg
from .admm import OSQP_MAX_ITER_REACHED, OSQP_SOLVED, OSQP_SOLVED_INACCURATE


@dataclasses.dataclass(frozen=True)
class TrajPlan:
    """Static description of a verified trajectory-structured NLP.

    Hashable (plain ints only) so it can ride through ``jax.jit`` as a
    static argument; all index arithmetic derives from it at trace time.
    """

    ph: int
    ch: int
    nx: int
    nu: int
    mi: int  # number of user inequality rows (ineq_fn output size)

    @property
    def nz(self) -> int:
        return self.ph * self.nx + self.ch * self.nu + 1

    @property
    def bs_p(self) -> int:  # primal slots per stage: [x_{k+1}; u_k]
        return self.nx + self.nu

    @property
    def bs(self) -> int:  # full stage block: primal + lambda_k
        return self.bs_p + self.nx

    @property
    def w(self) -> int:  # border: held move + slack + elastic xi
        return self.nu + 2


def _stage_of_slot(plan: TrajPlan, i: int) -> int:
    """Stage owning decision slot ``i``; -1 for the global border
    (held move / slack)."""
    ph, ch, nx, nu = plan.ph, plan.ch, plan.nx, plan.nu
    if i < ph * nx:
        return i // nx  # x_{k+1} lives in stage k
    j = (i - ph * nx) // nu if nu else 0
    if i >= plan.nz - 1 or j >= ch - 1:
        return -1  # slack or the held (last) move
    return j


def _supports_banded(plan: TrajPlan, rows_support) -> bool:
    """Every row's nonzero slots must span at most two ADJACENT stages
    (plus the global border)."""
    for supp in rows_support:
        stages = sorted({s for s in supp if s >= 0})
        if stages and stages[-1] - stages[0] > 1:
            return False
    return True


def make_plan(dims, fns, state_scaling, input_scaling, hessian_reg: str,
              dtype, n_probes: int = 2, p=None) -> Optional[TrajPlan]:
    """Probe the NLP's sparsity and return a :class:`TrajPlan`, or ``None``.

    Requirements for the banded engine:

    * no user equality constraints (the defect rows' one-multiplier-per-
      stage layout is what the stage blocks eliminate);
    * every user inequality row touches at most two adjacent stages;
    * the curvature matrix the SQP will build (objective Hessian for
      ``gauss_newton``, Lagrangian Hessian for ``gershgorin``/``power``)
      couples at most adjacent stages.  ``eigh``/``bfgs`` modes produce
      dense matrices by construction — not banded-eligible.

    The probe evaluates exact autodiff Jacobians/Hessians at ``n_probes``
    random points: autodiff zeros are *structural* zeros, so a nonzero
    support found at any probe point is the true support.  (A pathological
    callback whose off-band derivative vanishes at every probe point would
    slip through; the SQP's merit line search and final feasibility verdict
    still gate the result — see docs/manual.md.)
    """
    from ..nlmpc import problem as nlp

    if fns.eq_fn is None and fns.ineq_fn is not None:
        mi = None  # determined below
    elif fns.eq_fn is not None:
        return None
    else:
        mi = 0
    if hessian_reg not in ("gauss_newton", "gershgorin", "power"):
        return None
    if dims.nz < 2 * (dims.nx + dims.nu):
        return None  # tiny problems: dense is already optimal

    import numpy as np

    rng = np.random.default_rng(20240817)
    ss, us = state_scaling, input_scaling

    def f_fn(z, x0):
        return nlp.objective(dims, fns, ss, us, z, x0, p)

    def ci_fn(z, x0):
        return nlp.user_ineq(dims, fns, ss, us, z, x0, p)

    def ce_fn(z, x0):
        return nlp.state_defects(dims, fns, ss, us, z, x0, p)

    plan = TrajPlan(ph=dims.ph, ch=dims.ch, nx=dims.nx, nu=dims.nu, mi=0)
    nz = plan.nz
    try:
        for _ in range(n_probes):
            z = jnp.asarray(rng.normal(size=(nz,)) * 0.7 + 0.1, dtype)
            x0 = jnp.asarray(rng.normal(size=(dims.nx,)) * 0.3, dtype)
            supports = []
            if fns.ineq_fn is not None:
                Ji = np.asarray(jax.jacfwd(ci_fn)(z, x0))
                if Ji.ndim != 2:
                    return None
                mi = Ji.shape[0]
                for r in range(mi):
                    supports.append(
                        [_stage_of_slot(plan, int(i))
                         for i in np.nonzero(Ji[r])[0]]
                    )
            # curvature matrix of the selected mode
            if hessian_reg == "gauss_newton":
                H = np.asarray(jax.hessian(f_fn)(z, x0))
            else:
                me = dims.ph * dims.nx
                lam_e = jnp.asarray(rng.normal(size=(me,)), dtype)
                lam_i = (
                    jnp.asarray(rng.normal(size=(mi,)), dtype)
                    if fns.ineq_fn is not None else None
                )

                def lagr(zz, x0):
                    L = f_fn(zz, x0) + jnp.dot(lam_e, ce_fn(zz, x0))
                    if lam_i is not None:
                        L = L + jnp.dot(lam_i, ci_fn(zz, x0))
                    return L

                H = np.asarray(jax.hessian(lagr)(z, x0))
            for r, c in zip(*np.nonzero(H)):
                sr, sc = _stage_of_slot(plan, int(r)), _stage_of_slot(plan, int(c))
                if sr >= 0 and sc >= 0 and abs(sr - sc) > 1:
                    return None
            if not _supports_banded(plan, supports):
                return None
    except Exception:
        return None  # any probe failure -> dense fallback, never an error
    return dataclasses.replace(plan, mi=int(mi or 0))


# ---------------------------------------------------------------------------
# block extraction (per instance; shapes static from the plan)
# ---------------------------------------------------------------------------


def _h_blocks(plan: TrajPlan, H):
    """Stage blocks of a symmetric banded (nz, nz) matrix in the permuted
    primal ordering: returns (Hd (ph,bs_p,bs_p), Hl (ph-1,bs_p,bs_p),
    Hc (ph,bs_p,nu+1), Hg (nu+1,nu+1)) — border columns are
    [held move ; slack]; the elastic column is handled by the caller."""
    ph, ch, nx, nu = plan.ph, plan.ch, plan.nx, plan.nu
    uoff = ph * nx
    slack = plan.nz - 1
    kidx = jnp.arange(ph)
    has_u = (kidx < (ch - 1)).astype(H.dtype)
    gu = jnp.minimum(kidx, max(ch - 2, 0))

    Hxx = H[:uoff, :uoff].reshape(ph, nx, ph, nx)
    Hxu = H[:uoff, uoff : uoff + ch * nu].reshape(ph, nx, ch, nu)
    Huu = H[uoff : uoff + ch * nu, uoff : uoff + ch * nu].reshape(
        ch, nu, ch, nu
    )
    mu3 = has_u[:, None, None]

    # diagonal stage blocks
    Hxx_d = Hxx[kidx, :, kidx, :]  # (ph, nx, nx)
    Hxu_d = Hxu[kidx, :, gu, :] * mu3  # x_{k+1} <-> u_k
    Huu_d = Huu[gu, :, gu, :] * mu3
    Hd = jnp.concatenate(
        [
            jnp.concatenate([Hxx_d, Hxu_d], axis=2),
            jnp.concatenate([jnp.swapaxes(Hxu_d, 1, 2), Huu_d], axis=2),
        ],
        axis=1,
    )

    # sub-diagonal blocks (stage k vs stage k-1), k = 1..ph-1
    k1, k0 = kidx[1:], kidx[:-1]
    mu_k = has_u[1:, None, None]  # stage k owns a u slot
    mu_km1 = has_u[:-1, None, None]
    Hxx_l = Hxx[k1, :, k0, :]
    # x_{k+1} <-> u_{k-1}
    Hxu_l = Hxu[k1, :, jnp.minimum(k0, max(ch - 2, 0)), :] * mu_km1
    # u_k <-> x_k
    Hux_l = jnp.swapaxes(Hxu[k0, :, jnp.minimum(k1, max(ch - 2, 0)), :], 1, 2) * mu_k
    Huu_l = (
        Huu[jnp.minimum(k1, max(ch - 2, 0)), :, jnp.minimum(k0, max(ch - 2, 0)), :]
        * mu_k * mu_km1
    )
    Hl = jnp.concatenate(
        [
            jnp.concatenate([Hxx_l, Hxu_l], axis=2),
            jnp.concatenate([Hux_l, Huu_l], axis=2),
        ],
        axis=1,
    )

    # border columns: held move + slack
    held = slice(uoff + (ch - 1) * nu, uoff + ch * nu)
    Hx_g = jnp.concatenate(
        [
            H[:uoff, held].reshape(ph, nx, nu),
            H[:uoff, slack : slack + 1].reshape(ph, nx, 1),
        ],
        axis=2,
    )  # (ph, nx, nu+1)
    # H[u_k, held] lives in Huu[k, :, ch-1, :]
    Hu_g = jnp.concatenate(
        [
            Huu[gu, :, ch - 1, :] * mu3,
            (H[uoff : uoff + ch * nu, slack : slack + 1]
             .reshape(ch, nu, 1)[gu] * mu3),
        ],
        axis=2,
    )  # (ph, nu, nu+1)
    Hc = jnp.concatenate([Hx_g, Hu_g], axis=1)  # (ph, bs_p, nu+1)

    gsl = list(range(uoff + (ch - 1) * nu, uoff + ch * nu)) + [slack]
    gi = jnp.asarray(gsl)
    Hg = H[gi][:, gi]  # (nu+1, nu+1)
    return Hd, Hl, Hc, Hg


def _stage_cols(plan: TrajPlan, Z):
    """Split the columns of ``Z`` (r, nz) into per-stage primal blocks
    ``Zxu`` (ph, r, bs_p) and border columns ``Zg`` (r, nu+1) =
    [held move, slack]."""
    ph, ch, nx, nu = plan.ph, plan.ch, plan.nx, plan.nu
    uoff = ph * nx
    r = Z.shape[0]
    dtype = Z.dtype
    Zx = jnp.moveaxis(Z[:, :uoff].reshape(r, ph, nx), 1, 0)  # (ph, r, nx)
    Zu_all = jnp.moveaxis(
        Z[:, uoff : uoff + ch * nu].reshape(r, ch, nu), 1, 0
    )  # (ch, r, nu)
    if ch > 1:
        Zu = jnp.concatenate(
            [Zu_all[: ch - 1], jnp.zeros((ph - ch + 1, r, nu), dtype)], axis=0
        )
    else:
        Zu = jnp.zeros((ph, r, nu), dtype)
    Zxu = jnp.concatenate([Zx, Zu], axis=2)  # (ph, r, bs_p)
    Zg = jnp.concatenate(
        [Zu_all[ch - 1], Z[:, plan.nz - 1 : plan.nz]], axis=1
    )  # (r, nu+1)
    return Zxu, Zg


def _je_blocks(plan: TrajPlan, Je, ce):
    """Defect-Jacobian stage blocks.  Defect row block k touches
    ``x_k`` (stage k-1), ``x_{k+1}`` (stage k) and ``u_k`` (stage k for
    k < ch-1, else the held move) — reference
    include/mpc/NLMPC/Constraints.hpp:610-615.  Returns
    (Jexu_d (ph,nx,bs_p), A_sub (ph-1,nx,bs_p), Jeg (ph,nx,w))."""
    ph, ch, nx, nu = plan.ph, plan.ch, plan.nx, plan.nu
    uoff = ph * nx
    kidx = jnp.arange(ph)
    has_u = (kidx < (ch - 1)).astype(Je.dtype)
    gu = jnp.minimum(kidx, max(ch - 2, 0))

    Jer = Je.reshape(ph, nx, plan.nz)
    Jx4 = Jer[:, :, :uoff].reshape(ph, nx, ph, nx)
    Ju4 = Jer[:, :, uoff : uoff + ch * nu].reshape(ph, nx, ch, nu)

    E = Jx4[kidx, :, kidx, :]  # d c_k / d x_{k+1}
    Bu_d = Ju4[kidx, :, gu, :] * has_u[:, None, None]  # d c_k / d u_k (staged)
    Jexu_d = jnp.concatenate([E, Bu_d], axis=2)  # (ph, nx, bs_p)

    A = Jx4[kidx[1:], :, kidx[:-1], :]  # d c_k / d x_k, k >= 1
    A_sub = jnp.concatenate(
        [A, jnp.zeros((ph - 1, nx, nu), Je.dtype)], axis=2
    )  # (ph-1, nx, bs_p): defect k never touches u_{k-1}

    Bu_held = Ju4[:, :, ch - 1, :]  # d c_k / d held move (k >= ch-1)
    Je_slack = Jer[:, :, plan.nz - 1 : plan.nz]  # structurally zero
    Jeg = jnp.concatenate(
        [Bu_held, Je_slack, -ce.reshape(ph, nx)[:, :, None]], axis=2
    )  # (ph, nx, w): last column is the elastic variable
    return Jexu_d, A_sub, Jeg


# ---------------------------------------------------------------------------
# bordered block-tridiagonal quasi-definite LDL^T
# ---------------------------------------------------------------------------


def _qd_inverse(S, p: int):
    """Inverse of a symmetric quasi-definite block ``S`` whose leading ``p``
    slots are positive (primal) and trailing slots negative (dual), via two
    SPD inverses."""
    A = S[:p, :p]
    Bl = S[p:, :p]
    C = -S[p:, p:]
    Ai = batched_linalg.spd_inverse(0.5 * (A + A.T))
    W = Bl @ Ai  # (n, p)
    S2 = C + W @ Bl.T
    S2i = batched_linalg.spd_inverse(0.5 * (S2 + S2.T))
    TR = W.T @ S2i  # (p, n)
    TL = Ai - TR @ W
    top = jnp.concatenate([TL, TR], axis=1)
    bot = jnp.concatenate([TR.T, -S2i], axis=1)
    return jnp.concatenate([top, bot], axis=0)


class TrajFactors(NamedTuple):
    Sinv: jax.Array  # (ph, bs, bs) pivot-block inverses
    L: jax.Array  # (ph-1, bs, bs) sub-diagonal blocks (or (0,...) at ph=1)
    X: jax.Array  # (ph, bs, w)  T^-1 @ border
    Ghat_inv: jax.Array  # (w, w) inverse of the border Schur complement


def traj_factor(plan: TrajPlan, D, L, C, G) -> TrajFactors:
    """Factor the bordered block-tridiagonal quasi-definite KKT matrix.

    One forward elimination over the ph stages (sequential — the classic
    Riccati recursion's data dependence), then a backward sweep building
    ``X = T^-1 B_border`` and the border Schur inverse.  Unrolled Python
    loops: ph is small and static.  Batched by ``vmap``.
    """
    ph, bs, w, bs_p = plan.ph, plan.bs, plan.w, plan.bs_p
    Sinv = []
    Z = []
    Ghat = G
    for k in range(ph):
        if k == 0:
            Sk = D[0]
            Zk = C[0]
        else:
            LSprev = L[k - 1] @ Sinv[k - 1]
            Sk = D[k] - LSprev @ L[k - 1].T
            Zk = C[k] - LSprev @ Z[k - 1]
        Ski = _qd_inverse(Sk, bs_p)
        Sinv.append(Ski)
        Z.append(Zk)
        Ghat = Ghat - Zk.T @ (Ski @ Zk)
    # border block is all-primal (held move, slack, elastic): SPD Schur
    Ghat_inv = batched_linalg.spd_inverse(0.5 * (Ghat + Ghat.T))
    # X = T^-1 B_border: U_k = Sinv_k Z_k forward, then the backward sweep
    U = [Sinv[k] @ Z[k] for k in range(ph)]
    X = [None] * ph
    X[ph - 1] = U[ph - 1]
    for k in range(ph - 2, -1, -1):
        X[k] = U[k] - Sinv[k] @ (L[k].T @ X[k + 1])
    return TrajFactors(
        Sinv=jnp.stack(Sinv),
        L=L,
        X=jnp.stack(X),
        Ghat_inv=Ghat_inv,
    )


def traj_solve(plan: TrajPlan, f: TrajFactors, r_stage, r_g):
    """Sequential (per-instance) solve of the factored system.

    ``r_stage`` (ph, bs), ``r_g`` (w,) -> (x_stage (ph, bs), x_g (w,)).
    """
    ph = plan.ph
    # forward: u_k = Sinv_k (r_k - L_k u_{k-1})
    u = [None] * ph
    u[0] = f.Sinv[0] @ r_stage[0]
    for k in range(1, ph):
        u[k] = f.Sinv[k] @ (r_stage[k] - f.L[k - 1] @ u[k - 1])
    # border: g = Ghat^-1 (r_g - X^T r)   [T symmetric => (T^-1 B)^T = B^T T^-1]
    xtr = sum(f.X[k].T @ r_stage[k] for k in range(ph))
    g = f.Ghat_inv @ (r_g - xtr)
    # backward: xT_k = u_k - Sinv_k L_{k+1}^T xT_{k+1}; then subtract X g
    x = [None] * ph
    x[ph - 1] = u[ph - 1]
    for k in range(ph - 2, -1, -1):
        x[k] = u[k] - f.Sinv[k] @ (f.L[k].T @ x[k + 1])
    xs = jnp.stack([x[k] - f.X[k] @ g for k in range(ph)])
    return xs, g


# ---------------------------------------------------------------------------
# IPM driver (mirrors ops/pdip.py's Mehrotra predictor-corrector; the Newton
# systems route through the banded factorization instead of dense inverses)
# ---------------------------------------------------------------------------


class TrajIPMSolution(NamedTuple):
    d: jax.Array  # (nz,) primal step (elastic variable dropped)
    nu: jax.Array  # (me,) equality duals
    lam: jax.Array  # (mi,) user-inequality duals
    box_net: jax.Array  # (nz,) lam_hi - lam_lo (box duals, net) — the
    # warm-start payload for the next subproblem (see ``warm_y``)
    gap: jax.Array
    res: jax.Array
    status: jax.Array
    iters: jax.Array


def ipm_solve(
    plan: TrajPlan,
    B: jax.Array,  # (nz, nz) PSD curvature (banded per the plan)
    g: jax.Array,  # (nz,)
    Je: jax.Array,  # (me, nz) defect Jacobian, me == ph*nx
    ce: jax.Array,  # (me,) defect values (equality target: Je d = -ce)
    Ji: jax.Array,  # (mi, nz) user inequality Jacobian
    ci: jax.Array,  # (mi,) values (rows: Ji d <= -ci)
    lb: jax.Array,  # (nz,) box lower on d (may be -inf)
    ub: jax.Array,  # (nz,) box upper on d (may be +inf)
    rho_q: jax.Array,  # elastic quadratic penalty (see ops/sqp.py pdip branch)
    n_iters: int = 30,
    lane_cap=None,  # optional traced per-lane iteration cap <= n_iters;
    # folded into the done mask, NOT the loop bound: the compiled loop
    # keeps the static n_iters trip bound and capped lanes simply freeze
    # early like converged/stalled ones
    eps: float = 1e-8,
    eps_res: Optional[float] = None,
    tau: float = 0.995,
    h_blocks=None,
    warm_y: Optional[jax.Array] = None,
) -> TrajIPMSolution:
    """Elastic-relaxed inner QP via IPM + banded KKT (one instance; vmap
    batches).  Solves the same subproblem as the ``pdip`` engine in
    ops/sqp.py (including the elastic variable xi that keeps inconsistent
    linearizations feasible); box bounds are kept as separate barrier
    families instead of materialized +-identity rows, so their Hessian
    contribution is a diagonal add rather than a (2nz, nz) Gram product.
    """
    ph, nx, nu, mi = plan.ph, plan.nx, plan.nu, plan.mi
    nz = plan.nz
    me = ph * nx
    bs, bs_p, w = plan.bs, plan.bs_p, plan.w
    dtype = B.dtype
    f32 = dtype == jnp.float32
    if eps_res is None:
        # f32: the KKT residual's rounding floor grows like
        # sqrt(nz)*eps*scale; at nz=301 a flat 3e-6 leaves ~half the lanes
        # floor-stalled burning every remaining lockstep iteration
        # (measured round 4: res p50 of non-converged lanes = 3.2e-5).
        # The returned direction is a line-search TRIAL for the outer SQP,
        # which needs ~1e-4-relative accuracy, not 1e-6 absolute.
        eps_res = 3e-6 * max(1.0, nz / 30.0) if f32 else 1e-10
    reg_p = jnp.asarray(1e-7 if f32 else 1e-10, dtype)
    reg_d = jnp.asarray(1e-7 if f32 else 1e-10, dtype)
    cap = jnp.asarray(1e6 if f32 else 1e12, dtype)
    big = jnp.asarray(1e3, dtype)

    # treat huge sentinels (1e18+) as infinite like OSQP's OSQP_INFTY
    # cut-off: a barrier on a 1e20 "bound" destabilizes the step rule
    mask_hi = jnp.isfinite(ub) & (ub < 1e18)
    mask_lo = jnp.isfinite(lb) & (lb > -1e18)
    ubf = jnp.where(mask_hi, ub, 0.0)
    lbf = jnp.where(mask_lo, lb, 0.0)
    ci_pos = jnp.maximum(ci, 0.0)
    n_real = jnp.maximum(
        mi + jnp.sum(mask_hi) + jnp.sum(mask_lo), 1
    ).astype(dtype)

    # static per-call block extractions.  The optimization barrier keeps
    # XLA from fusing these (gather-heavy, computed once) into the IPM
    # loop body's consumers — without it the extraction rematerializes
    # inside every iteration.  ``h_blocks`` lets the caller hoist
    # the curvature-matrix extraction even further: under the constant
    # gauss_newton model the SQP driver computes it ONCE PER SOLVE
    # instead of once per SQP iteration (the gathers over the (nz, nz)
    # matrix measured ~8 ms at B=256/nz=301 — a per-iteration tax
    # otherwise, since XLA does not hoist across its while loop).
    Hd0, Hl0, Hc0, Hg0 = (
        h_blocks if h_blocks is not None else _h_blocks(plan, B)
    )
    Jexu_d, A_sub, Jeg = _je_blocks(plan, Je, ce)
    Jxu, Jg_hs = _stage_cols(plan, Ji)  # (ph, mi, bs_p), (mi, nu+1)
    Jg = jnp.concatenate([Jg_hs, -ci_pos[:, None]], axis=1)  # (mi, w)
    (Hd0, Hl0, Hc0, Hg0, Jexu_d, A_sub, Jeg, Jxu, Jg) = (
        jax.lax.optimization_barrier(
            (Hd0, Hl0, Hc0, Hg0, Jexu_d, A_sub, Jeg, Jxu, Jg)
        )
    )
    # held-move / slack / xi border: B has no elastic row; pad with zeros
    Hc_pad = jnp.concatenate(
        [Hc0, jnp.zeros((ph, bs_p, 1), dtype)], axis=2
    )  # (ph, bs_p, w)
    Hg_pad = (
        jnp.zeros((w, w), dtype).at[: nu + 1, : nu + 1].set(Hg0)
    )
    eye_p = jnp.eye(bs_p, dtype=dtype)
    eye_x = jnp.eye(nx, dtype=dtype)
    eye_w = jnp.eye(w, dtype=dtype)

    def box_weights(lam_hi, s_hi, lam_lo, s_lo):
        w_hi = jnp.where(mask_hi, jnp.minimum(lam_hi / jnp.maximum(s_hi, 1e-30), cap), 0.0)
        w_lo = jnp.where(mask_lo, jnp.minimum(lam_lo / jnp.maximum(s_lo, 1e-30), cap), 0.0)
        return w_hi + w_lo

    def assemble(W_u, wbox):
        """Build (D, L, C, G) stage blocks for the current barrier weights."""
        # user-inequality Gram blocks
        JW = Jxu * W_u[None, :, None]  # (ph, mi, bs_p)
        Dji = jnp.einsum("kri,krj->kij", JW, Jxu)
        Lji = jnp.einsum("kri,krj->kij", JW[1:], Jxu[:-1])
        Cji = jnp.einsum("kri,rj->kij", JW, Jg)
        Gji = (Jg * W_u[:, None]).T @ Jg

        # box weights onto the stage primal diagonals
        wb_x = wbox[: ph * nx].reshape(ph, nx)
        ch = plan.ch
        wb_u_all = wbox[ph * nx : ph * nx + ch * nu].reshape(ch, nu)
        if ch > 1:
            wb_u = jnp.concatenate(
                [wb_u_all[: ch - 1], jnp.zeros((ph - ch + 1, nu), dtype)],
                axis=0,
            )
        else:
            wb_u = jnp.zeros((ph, nu), dtype)
        wb_stage = jnp.concatenate([wb_x, wb_u], axis=1)  # (ph, bs_p)

        Hpp = (
            Hd0 + Dji
            + (wb_stage[:, :, None] + reg_p) * eye_p[None]
        )
        # concatenation (not .at[].set) builds: under vmap the masked
        # updates lower to full-buffer dynamic-update-slices, while the
        # concats fuse away
        D = jnp.concatenate(
            [
                jnp.concatenate([Hpp, jnp.swapaxes(Jexu_d, 1, 2)], axis=2),
                jnp.concatenate(
                    [Jexu_d,
                     jnp.broadcast_to(-reg_d * eye_x, (ph, nx, nx))],
                    axis=2,
                ),
            ],
            axis=1,
        )

        if ph > 1:
            Lb = jnp.concatenate(
                [
                    jnp.concatenate(
                        [Hl0 + Lji, jnp.zeros((ph - 1, bs_p, nx), dtype)],
                        axis=2,
                    ),
                    jnp.concatenate(
                        [A_sub, jnp.zeros((ph - 1, nx, nx), dtype)], axis=2
                    ),
                ],
                axis=1,
            )
        else:
            Lb = jnp.zeros((0, bs, bs), dtype)

        C = jnp.concatenate([Hc_pad + Cji, Jeg], axis=1)

        wb_g = jnp.concatenate(
            [
                wbox[ph * nx + (ch - 1) * nu : ph * nx + ch * nu],
                wbox[nz - 1 : nz],
                jnp.zeros((1,), dtype),
            ]
        )
        G = (
            Hg_pad + Gji + (wb_g + reg_p) * eye_w
            + rho_q * (eye_w * (jnp.arange(w) == (w - 1))[None, :])
        )
        return D, Lb, C, G

    def kkt_solve(factors, rhs_d, rhs_xi, re):
        """Permute the rhs into stages, run the banded solve, permute back.
        Solves [H Je'; Je -reg_d I] [dd; dnu] = [rhs_d_aug; -re]."""
        rd_x = rhs_d[: ph * nx].reshape(ph, nx)
        ch = plan.ch
        rd_u_all = rhs_d[ph * nx : ph * nx + ch * nu].reshape(ch, nu)
        if ch > 1:
            rd_u = jnp.concatenate(
                [rd_u_all[: ch - 1], jnp.zeros((ph - ch + 1, nu), dtype)],
                axis=0,
            )
        else:
            rd_u = jnp.zeros((ph, nu), dtype)
        r_dual = (-re).reshape(ph, nx)
        r_stage = jnp.concatenate([rd_x, rd_u, r_dual], axis=1)  # (ph, bs)
        r_g = jnp.concatenate(
            [rd_u_all[ch - 1], rhs_d[nz - 1 : nz], rhs_xi[None]]
        )
        xs, xg = traj_solve(plan, factors, r_stage, r_g)
        # the permuted pieces are contiguous in the z layout:
        # [x_1..x_ph | ub_0..ub_{ch-2} | ub_{ch-1} | slack]
        dd = jnp.concatenate(
            [xs[:, :nx].reshape(-1),
             xs[: ch - 1, nx:bs_p].reshape(-1),
             xg[:nu], xg[nu : nu + 1]]
        )
        dxi = xg[nu + 1]
        dnu = xs[:, bs_p:].reshape(-1)
        return dd, dxi, dnu

    # families: (A z) with z = [d; xi]
    def A_u(d, xi):
        return Ji @ d - ci_pos * xi

    class St(NamedTuple):
        d: jax.Array
        xi: jax.Array
        nu: jax.Array
        lam_u: jax.Array
        s_u: jax.Array
        lam_hi: jax.Array
        s_hi: jax.Array
        lam_lo: jax.Array
        s_lo: jax.Array
        done: jax.Array
        fail: jax.Array
        gap: jax.Array
        res: jax.Array
        it: jax.Array
        mu_chk: jax.Array  # stall detection: mu/res at the previous
        res_chk: jax.Array  # iteration (see `stalled` below)
        stall_ct: jax.Array
        stall_frz: jax.Array  # lane was frozen by the stall detector
        cap_frz: jax.Array  # lane was frozen by its per-lane cap

    b_u = -ci
    b_hi = ubf  # d <= ub (caller passes ub - z etc.)
    b_lo = -lbf  # -d <= -lb

    d0 = jnp.zeros((nz,), dtype)
    xi0 = jnp.asarray(0.0, dtype)
    s_u0 = jnp.maximum(b_u, 1.0)
    lam_u0 = jnp.ones((mi,), dtype)
    s_hi0 = jnp.where(mask_hi, jnp.maximum(b_hi, 1.0), 1.0)
    lam_hi0 = jnp.where(mask_hi, 1.0, 0.0)
    s_lo0 = jnp.where(mask_lo, jnp.maximum(b_lo, 1.0), 1.0)
    lam_lo0 = jnp.where(mask_lo, 1.0, 0.0)
    nu0 = jnp.zeros((me,), dtype)
    if warm_y is not None:
        # dual warm start from the previous SQP iteration's subproblem
        # (warm_y = [nu ; lam_u ; lam_hi - lam_lo]): clamp the carried
        # multipliers to a centrality band so the active-set information
        # survives (large lam on active rows) while inactive rows start
        # near the barrier floor — across SQP iterations the subproblems
        # change slowly, and the carried partition cuts the Mehrotra
        # path-following iterations roughly in half on warm steps.
        # An all-zero warm_y (the first SQP iteration) keeps the cold
        # start above.
        is_warm = jnp.any(jnp.abs(warm_y) > 0)
        beta_lo = jnp.asarray(1e-2, dtype)
        beta_hi = jnp.asarray(1e4, dtype)
        lam_u_w = jnp.clip(warm_y[me : me + mi], beta_lo, beta_hi)
        net = warm_y[me + mi :]
        lam_hi_w = jnp.where(
            mask_hi, jnp.clip(jnp.maximum(net, 0.0), beta_lo, beta_hi), 0.0
        )
        lam_lo_w = jnp.where(
            mask_lo, jnp.clip(jnp.maximum(-net, 0.0), beta_lo, beta_hi), 0.0
        )
        s_u_w = jnp.maximum(b_u, 1e-2)
        s_hi_w = jnp.where(mask_hi, jnp.maximum(b_hi, 1e-2), 1.0)
        s_lo_w = jnp.where(mask_lo, jnp.maximum(b_lo, 1e-2), 1.0)
        lam_u0 = jnp.where(is_warm, lam_u_w, lam_u0)
        lam_hi0 = jnp.where(is_warm, lam_hi_w, lam_hi0)
        lam_lo0 = jnp.where(is_warm, lam_lo_w, lam_lo0)
        s_u0 = jnp.where(is_warm, s_u_w, s_u0)
        s_hi0 = jnp.where(is_warm, s_hi_w, s_hi0)
        s_lo0 = jnp.where(is_warm, s_lo_w, s_lo0)
        nu0 = jnp.where(is_warm, warm_y[:me], nu0)

    def kkt_res(st: St):
        r_d = (
            B @ st.d + g + st.nu @ Je + st.lam_u @ Ji
            + jnp.where(mask_hi, st.lam_hi, 0.0)
            - jnp.where(mask_lo, st.lam_lo, 0.0)
        )
        r_xi = rho_q * st.xi - jnp.dot(ce, st.nu) - jnp.dot(ci_pos, st.lam_u)
        r_e = Je @ st.d - ce * st.xi + ce
        viol = jnp.maximum(
            jnp.max(jnp.maximum(A_u(st.d, st.xi) - b_u, 0.0))
            if mi else jnp.asarray(0.0, dtype),
            jnp.maximum(
                jnp.max(jnp.where(mask_hi, st.d - b_hi, 0.0)),
                jnp.max(jnp.where(mask_lo, -st.d - b_lo, 0.0)),
            ),
        )
        res = jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(r_d)), jnp.abs(r_xi)),
            jnp.maximum(jnp.max(jnp.abs(r_e)), viol),
        )
        return r_d, r_xi, r_e, res

    def body(st: St) -> St:
        r_d, r_xi, r_e, res = kkt_res(st)
        # slack-form primal residuals per family
        r_iu = A_u(st.d, st.xi) + st.s_u - b_u
        r_ihi = jnp.where(mask_hi, st.d + st.s_hi - b_hi, 0.0)
        r_ilo = jnp.where(mask_lo, -st.d + st.s_lo - b_lo, 0.0)
        mu = (
            jnp.sum(st.lam_u * st.s_u)
            + jnp.sum(jnp.where(mask_hi, st.lam_hi * st.s_hi, 0.0))
            + jnp.sum(jnp.where(mask_lo, st.lam_lo * st.s_lo, 0.0))
        ) / n_real
        conv = (mu < eps) & (res < eps_res)
        # per-lane stall freeze: a lane whose complementarity gap AND
        # KKT residual have both stopped improving (>1% for 3 consecutive
        # iterations) has hit its float noise floor — freeze it so the
        # vmapped lockstep loop can exit once every lane is done/stalled
        # instead of dragging the whole batch to the n_iters cap (the cap
        # exists for the slowly-but-genuinely-improving ~1% tail).
        # f32 only, mirroring the ADMM stall detector (ops/admm.py:581):
        # f64 has no residual floor, and a Mehrotra IPM can plateau
        # transiently mid-run — freezing those trades accuracy for
        # nothing.  In f32 the freeze applies regardless of residual
        # quality: a plateaued direction is still a usable line-search
        # TRIAL for the outer SQP (forcing noise-floor lanes onward was
        # measured to produce degenerate steps that fail the merit line
        # search) — but the lane's VERDICT is gated on residual quality
        # at exit (see the status mapping below), never plain SOLVED.
        if f32:
            improved = (mu < 0.99 * st.mu_chk) | (res < 0.99 * st.res_chk)
            stall_ct = jnp.where(improved, 0, st.stall_ct + 1)
            stalled = stall_ct >= 3
        else:
            stall_ct = st.stall_ct
            stalled = jnp.asarray(False)

        W_u = jnp.minimum(st.lam_u / jnp.maximum(st.s_u, 1e-30), cap)
        wbox = box_weights(st.lam_hi, st.s_hi, st.lam_lo, st.s_lo)
        D, Lb, C, G = assemble(W_u, wbox)
        # barrier between assembly and factorization: without it XLA's
        # fusion heuristics around the unrolled stage recursion can re-fuse
        # the assembly into every stage's consumers
        D, Lb, C, G = jax.lax.optimization_barrier((D, Lb, C, G))
        factors = traj_factor(plan, D, Lb, C, G)

        def newton(rcomp_u, rcomp_hi, rcomp_lo):
            v_u = (st.lam_u * r_iu - rcomp_u) / jnp.maximum(st.s_u, 1e-30)
            v_hi = jnp.where(
                mask_hi,
                (st.lam_hi * r_ihi - rcomp_hi) / jnp.maximum(st.s_hi, 1e-30),
                0.0,
            )
            v_lo = jnp.where(
                mask_lo,
                (st.lam_lo * r_ilo - rcomp_lo) / jnp.maximum(st.s_lo, 1e-30),
                0.0,
            )
            rhs_d = -r_d - (v_u @ Ji + v_hi - v_lo)
            rhs_xi = -r_xi + jnp.dot(ci_pos, v_u)
            dd, dxi, dnu = kkt_solve(factors, rhs_d, rhs_xi, r_e)
            Adu = Ji @ dd - ci_pos * dxi
            dlam_u = (
                st.lam_u * (Adu + r_iu) - rcomp_u
            ) / jnp.maximum(st.s_u, 1e-30)
            ds_u = -(rcomp_u + st.s_u * dlam_u) / jnp.maximum(st.lam_u, 1e-30)
            dlam_hi = jnp.where(
                mask_hi,
                (st.lam_hi * (dd + r_ihi) - rcomp_hi)
                / jnp.maximum(st.s_hi, 1e-30),
                0.0,
            )
            ds_hi = jnp.where(
                mask_hi,
                -(rcomp_hi + st.s_hi * dlam_hi)
                / jnp.maximum(st.lam_hi, 1e-30),
                0.0,
            )
            dlam_lo = jnp.where(
                mask_lo,
                (st.lam_lo * (-dd + r_ilo) - rcomp_lo)
                / jnp.maximum(st.s_lo, 1e-30),
                0.0,
            )
            ds_lo = jnp.where(
                mask_lo,
                -(rcomp_lo + st.s_lo * dlam_lo)
                / jnp.maximum(st.lam_lo, 1e-30),
                0.0,
            )
            return dd, dxi, dnu, dlam_u, ds_u, dlam_hi, ds_hi, dlam_lo, ds_lo

        def max_step(v, dv, mask):
            ratio = jnp.where(
                (dv < 0) & mask, -v / jnp.minimum(dv, -1e-30), big
            )
            r = jnp.min(ratio) if ratio.size else jnp.asarray(jnp.inf, dtype)
            return jnp.minimum(1.0, tau * r)

        ones_u = jnp.ones((mi,), bool)

        # predictor
        pa = newton(st.lam_u * st.s_u,
                    jnp.where(mask_hi, st.lam_hi * st.s_hi, 0.0),
                    jnp.where(mask_lo, st.lam_lo * st.s_lo, 0.0))
        (dd_a, dxi_a, _dnu_a, dlu_a, dsu_a, dlh_a, dsh_a, dll_a, dsl_a) = pa
        a_aff = jnp.minimum(
            jnp.minimum(
                jnp.minimum(max_step(st.lam_u, dlu_a, ones_u),
                            max_step(st.s_u, dsu_a, ones_u)),
                jnp.minimum(max_step(st.lam_hi, dlh_a, mask_hi),
                            max_step(st.s_hi, dsh_a, mask_hi)),
            ),
            jnp.minimum(max_step(st.lam_lo, dll_a, mask_lo),
                        max_step(st.s_lo, dsl_a, mask_lo)),
        )
        mu_aff = (
            jnp.sum((st.lam_u + a_aff * dlu_a) * (st.s_u + a_aff * dsu_a))
            + jnp.sum(jnp.where(
                mask_hi,
                (st.lam_hi + a_aff * dlh_a) * (st.s_hi + a_aff * dsh_a), 0.0))
            + jnp.sum(jnp.where(
                mask_lo,
                (st.lam_lo + a_aff * dll_a) * (st.s_lo + a_aff * dsl_a), 0.0))
        ) / n_real
        sigma = jnp.clip((mu_aff / jnp.maximum(mu, 1e-30)) ** 3, 0.0, 1.0)

        # corrector (same factorization)
        co = newton(
            st.lam_u * st.s_u + dlu_a * dsu_a - sigma * mu,
            jnp.where(mask_hi,
                      st.lam_hi * st.s_hi + dlh_a * dsh_a - sigma * mu, 0.0),
            jnp.where(mask_lo,
                      st.lam_lo * st.s_lo + dll_a * dsl_a - sigma * mu, 0.0),
        )
        dd, dxi, dnu, dlu, dsu, dlh, dsh, dll, dsl = co
        alpha = jnp.minimum(
            jnp.minimum(
                jnp.minimum(max_step(st.lam_u, dlu, ones_u),
                            max_step(st.s_u, dsu, ones_u)),
                jnp.minimum(max_step(st.lam_hi, dlh, mask_hi),
                            max_step(st.s_hi, dsh, mask_hi)),
            ),
            jnp.minimum(max_step(st.lam_lo, dll, mask_lo),
                        max_step(st.s_lo, dsl, mask_lo)),
        )

        step_ok = (
            jnp.all(jnp.isfinite(dd)) & jnp.isfinite(dxi)
            & jnp.all(jnp.isfinite(dnu)) & jnp.all(jnp.isfinite(dlu))
            & jnp.all(jnp.isfinite(dlh)) & jnp.all(jnp.isfinite(dll))
            & jnp.isfinite(alpha)
        )
        fail = st.fail | (~st.done & ~conv & ~step_ok)
        done_now = conv | ~step_ok | stalled
        stall_frz = st.stall_frz | (~st.done & stalled & ~conv & step_ok)
        # per-lane cap: the capped lane still APPLIES this iteration's
        # update (matching what the static loop bound would do), then
        # freezes; its verdict routes through the relaxed final check,
        # never plain SOLVED (see cap_frz below)
        if lane_cap is not None:
            cap_hit = (st.it + 1) >= lane_cap
        else:
            cap_hit = jnp.asarray(False)
        cap_frz = st.cap_frz | (~st.done & ~done_now & cap_hit)
        done = st.done | done_now | cap_hit
        upd = ~(st.done | done_now)
        return St(
            d=jnp.where(upd, st.d + alpha * dd, st.d),
            xi=jnp.where(upd, st.xi + alpha * dxi, st.xi),
            nu=jnp.where(upd, st.nu + alpha * dnu, st.nu),
            lam_u=jnp.where(upd, st.lam_u + alpha * dlu, st.lam_u),
            s_u=jnp.where(upd, st.s_u + alpha * dsu, st.s_u),
            lam_hi=jnp.where(upd, st.lam_hi + alpha * dlh, st.lam_hi),
            s_hi=jnp.where(upd, st.s_hi + alpha * dsh, st.s_hi),
            lam_lo=jnp.where(upd, st.lam_lo + alpha * dll, st.lam_lo),
            s_lo=jnp.where(upd, st.s_lo + alpha * dsl, st.s_lo),
            done=done,
            fail=fail,
            gap=jnp.where(st.done, st.gap, mu),
            res=jnp.where(st.done, st.res, res),
            it=st.it + jnp.where(st.done, 0, 1),
            mu_chk=jnp.where(st.done, st.mu_chk, mu),
            res_chk=jnp.where(st.done, st.res_chk, res),
            stall_ct=stall_ct,
            stall_frz=stall_frz,
            cap_frz=cap_frz,
        )

    init = St(
        d=d0, xi=xi0, nu=nu0,
        lam_u=lam_u0, s_u=s_u0, lam_hi=lam_hi0, s_hi=s_hi0,
        lam_lo=lam_lo0, s_lo=s_lo0,
        done=jnp.asarray(False), fail=jnp.asarray(False),
        gap=jnp.asarray(jnp.inf, dtype), res=jnp.asarray(jnp.inf, dtype),
        it=jnp.asarray(0, jnp.int32),
        mu_chk=jnp.asarray(jnp.inf, dtype),
        res_chk=jnp.asarray(jnp.inf, dtype),
        stall_ct=jnp.asarray(0, jnp.int32),
        stall_frz=jnp.asarray(False),
        cap_frz=jnp.asarray(False),
    )
    st = jax.lax.while_loop(lambda s: ~s.done & (s.it < n_iters), body, init)
    _, _, _, res_fin = kkt_res(st)
    mu_fin = (
        jnp.sum(st.lam_u * st.s_u)
        + jnp.sum(jnp.where(mask_hi, st.lam_hi * st.s_hi, 0.0))
        + jnp.sum(jnp.where(mask_lo, st.lam_lo * st.s_lo, 0.0))
    ) / n_real
    # cap-frozen lanes report their FINAL post-update residuals (exactly
    # what a static loop bound would have produced)
    fresh = ~st.done | st.cap_frz
    gap = jnp.where(fresh, mu_fin, st.gap)
    res = jnp.where(fresh, res_fin, st.res)
    # status honesty (mirrors the ADMM stall detector's verdicts,
    # ops/admm.py:590-603): a lane frozen by the stall detector or its
    # per-lane cap did NOT meet the convergence test — it never reports
    # plain SOLVED unless the relaxed final verdict independently passes.
    # Stall-frozen lanes within the 10x residual band report
    # OSQP_SOLVED_INACCURATE (the f32 noise-floor case the freeze exists
    # for); otherwise OSQP_MAX_ITER_REACHED.
    relaxed = (gap < 1e3 * eps) & (res < 1e2 * eps_res)
    ok = (st.done & ~st.fail & ~st.stall_frz & ~st.cap_frz) | relaxed
    inacc = st.stall_frz & ~relaxed & (res < 10.0 * eps_res)
    return TrajIPMSolution(
        d=st.d,
        nu=st.nu,
        lam=st.lam_u,
        box_net=jnp.where(mask_hi, st.lam_hi, 0.0)
        - jnp.where(mask_lo, st.lam_lo, 0.0),
        gap=gap,
        res=res,
        status=jnp.where(
            ok,
            OSQP_SOLVED,
            jnp.where(inacc, OSQP_SOLVED_INACCURATE, OSQP_MAX_ITER_REACHED),
        ).astype(jnp.int32),
        iters=st.it,
    )
