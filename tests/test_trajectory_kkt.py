"""Trajectory-structured (banded) inner-QP engine tests.

Three layers, all in the f64 parity configuration (conftest):

1. the bordered block-tridiagonal factor/solve against a dense solve of the
   assembled quasi-definite matrix;
2. the banded IPM against the dense ``pdip`` engine on the identical
   elastic subproblem — they must agree to machine precision, iteration
   for iteration;
3. whole-controller parity: ``inner_qp="riccati"`` vs ``"pdip"`` on Van der
   Pol and a reduced networked-oscillators NLMPC, plus the structure
   probe's accept/reject behavior.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libmpc_tpu import NLMPC, NLParameters
from libmpc_tpu.dims import NLDims
from libmpc_tpu.nlmpc import problem as nlp
from libmpc_tpu.ops import pdip, trajectory_kkt as tk
from libmpc_tpu.ops.sqp import _gershgorin_convexify


def _vdp(x, u, k):
    return jnp.stack([(1.0 - x[1] * x[1]) * x[0] - x[1] + u[0], x[0]])


def _vdp_fns(dt):
    return nlp.NLFunctions(
        state_fn=_vdp,
        objective_fn=lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2),
        ineq_fn=lambda X, Y, U, e: U[:, 0] - 0.5,
        continuous=True,
        ts=0.1,
    )


def _quasidef_banded(rng, plan):
    """A genuinely quasi-definite bordered block-tridiagonal matrix in the
    permuted stage layout (primal Gram over adjacent-stage rows + border,
    negative-definite dual diagonal, banded cross coupling)."""
    ph, bs, bs_p, w = plan.ph, plan.bs, plan.bs_p, plan.w
    n = ph * bs + w
    prim = np.concatenate(
        [np.arange(k * bs, k * bs + bs_p) for k in range(ph)]
        + [np.arange(ph * bs, n)]
    )
    dual = np.concatenate(
        [np.arange(k * bs + bs_p, (k + 1) * bs) for k in range(ph)]
    )
    M = np.zeros((n, n))
    for k in range(ph):
        for _ in range(6):
            v = np.zeros(n)
            sl = np.arange(k * bs, k * bs + bs_p)
            if k + 1 < ph:
                sl = np.concatenate(
                    [sl, np.arange((k + 1) * bs, (k + 1) * bs + bs_p)]
                )
            sl = np.concatenate([sl, np.arange(ph * bs, n)])
            v[sl] = rng.normal(size=sl.size)
            M += np.outer(v, v)
    M[prim[:, None], prim[None, :]] += 0.1 * np.eye(prim.size)
    M[dual[:, None], dual[None, :]] = -0.05 * np.eye(dual.size)
    for k in range(ph):
        rows = np.arange(k * bs + bs_p, (k + 1) * bs)
        cols = list(np.arange(k * bs, k * bs + bs_p)) + list(
            np.arange(ph * bs, n)
        )
        if k:
            cols += list(np.arange((k - 1) * bs, (k - 1) * bs + bs_p))
        cols = np.asarray(cols)
        blk = rng.normal(size=(rows.size, cols.size))
        M[rows[:, None], cols[None, :]] = blk
        M[cols[:, None], rows[None, :]] = blk.T
    return M


class TestFactorSolve:
    @pytest.mark.parametrize("ph,ch,nx,nu", [(6, 4, 3, 2), (10, 5, 2, 1),
                                             (4, 1, 2, 2), (1, 1, 2, 1)])
    def test_banded_solve_matches_dense(self, ph, ch, nx, nu):
        plan = tk.TrajPlan(ph=ph, ch=ch, nx=nx, nu=nu, mi=3)
        rng = np.random.default_rng(ph * 100 + ch)
        M = _quasidef_banded(rng, plan)
        bs, w = plan.bs, plan.w
        D = jnp.asarray(
            np.stack([M[k*bs:(k+1)*bs, k*bs:(k+1)*bs] for k in range(ph)]))
        L = jnp.asarray(
            np.stack([M[k*bs:(k+1)*bs, (k-1)*bs:k*bs] for k in range(1, ph)])
            if ph > 1 else np.zeros((0, bs, bs)))
        C = jnp.asarray(np.stack([M[k*bs:(k+1)*bs, ph*bs:] for k in range(ph)]))
        G = jnp.asarray(M[ph*bs:, ph*bs:])
        r = rng.normal(size=M.shape[0])
        x_dense = np.linalg.solve(M, r)
        f = tk.traj_factor(plan, D, L, C, G)
        xs, xg = tk.traj_solve(
            plan, f, jnp.asarray(r[: ph * bs].reshape(ph, bs)),
            jnp.asarray(r[ph * bs:]))
        x = np.concatenate([np.asarray(xs).ravel(), np.asarray(xg)])
        rel = np.abs(x - x_dense).max() / np.abs(x_dense).max()
        assert rel < 1e-9, rel

    @pytest.mark.parametrize("ph,ch,nx,nu", [(6, 4, 3, 2), (20, 10, 12, 6),
                                             (5, 3, 2, 1), (10, 5, 2, 1)])
    def test_f32_factor_solve_under_vmap_matches_dense(self, ph, ch, nx, nu):
        """The production batched path: float32 factor and solve under
        ``vmap`` against a float64 dense solve of each assembled matrix."""
        plan = tk.TrajPlan(ph=ph, ch=ch, nx=nx, nu=nu, mi=3)
        bs, w = plan.bs, plan.w
        rng = np.random.default_rng(ph * 10 + nx)
        B = 3
        f32 = jnp.float32
        Ms = [_quasidef_banded(rng, plan) for _ in range(B)]
        D = jnp.asarray(np.stack(
            [[M[k*bs:(k+1)*bs, k*bs:(k+1)*bs] for k in range(ph)]
             for M in Ms]), f32)
        L = jnp.asarray(np.stack(
            [[M[k*bs:(k+1)*bs, (k-1)*bs:k*bs] for k in range(1, ph)]
             for M in Ms]), f32)
        C = jnp.asarray(np.stack(
            [[M[k*bs:(k+1)*bs, ph*bs:] for k in range(ph)] for M in Ms]),
            f32)
        G = jnp.asarray(np.stack([M[ph*bs:, ph*bs:] for M in Ms]), f32)
        r = rng.normal(size=(B, ph * bs + w))
        f = jax.vmap(lambda d, l, c, g: tk.traj_factor(plan, d, l, c, g))(
            D, L, C, G)
        xs, xg = jax.vmap(lambda f, rr: tk.traj_solve(
            plan, f, rr[: ph * bs].reshape(ph, bs), rr[ph * bs:]))(
            f, jnp.asarray(r, f32))
        assert xs.dtype == f32
        x = np.concatenate([np.asarray(xs).reshape(B, -1), np.asarray(xg)],
                           axis=1)
        for b in range(B):
            ref = np.linalg.solve(Ms[b], r[b])
            rel = np.abs(x[b] - ref).max() / np.abs(ref).max()
            assert rel < 1e-3, (b, rel)

    def test_batched_under_vmap(self):
        plan = tk.TrajPlan(ph=5, ch=3, nx=2, nu=1, mi=2)
        rng = np.random.default_rng(7)
        bs, w, ph = plan.bs, plan.w, plan.ph
        B = 4
        Ms = [_quasidef_banded(rng, plan) for _ in range(B)]
        D = jnp.asarray(np.stack(
            [[M[k*bs:(k+1)*bs, k*bs:(k+1)*bs] for k in range(ph)] for M in Ms]))
        L = jnp.asarray(np.stack(
            [[M[k*bs:(k+1)*bs, (k-1)*bs:k*bs] for k in range(1, ph)] for M in Ms]))
        C = jnp.asarray(np.stack(
            [[M[k*bs:(k+1)*bs, ph*bs:] for k in range(ph)] for M in Ms]))
        G = jnp.asarray(np.stack([M[ph*bs:, ph*bs:] for M in Ms]))
        r = rng.normal(size=(B, ph * bs + w))

        def solve_one(D, L, C, G, r):
            f = tk.traj_factor(plan, D, L, C, G)
            xs, xg = tk.traj_solve(
                plan, f, r[: ph * bs].reshape(ph, bs), r[ph * bs:])
            return jnp.concatenate([xs.reshape(-1), xg])

        xb = jax.vmap(solve_one)(D, L, C, G, jnp.asarray(r))
        for b in range(B):
            ref = np.linalg.solve(Ms[b], r[b])
            rel = np.abs(np.asarray(xb[b]) - ref).max() / np.abs(ref).max()
            assert rel < 1e-9, (b, rel)


def _vdp_subproblem(dt=jnp.float64):
    dims = NLDims(2, 1, 2, 10, 5, 11, 0)
    fns = _vdp_fns(dt)
    ss = jnp.ones((2,), dt)
    us = jnp.ones((1,), dt)
    rng = np.random.default_rng(3)
    nz = dims.nz
    x0 = jnp.asarray([0.4, -0.3], dt)
    z = jnp.asarray(rng.normal(size=nz) * 0.3, dt)
    f_fn = lambda zz: nlp.objective(dims, fns, ss, us, zz, x0, None)
    ce_fn = lambda zz: nlp.state_defects(dims, fns, ss, us, zz, x0, None)
    ci_fn = lambda zz: nlp.user_ineq(dims, fns, ss, us, zz, x0, None)
    g = jax.grad(f_fn)(z)
    ce = ce_fn(z)
    ci = ci_fn(z)
    Je = jax.jacfwd(ce_fn)(z)
    Ji = jax.jacfwd(ci_fn)(z)
    H = jax.hessian(f_fn)(z)
    B = _gershgorin_convexify(0.5 * (H + H.T), nz, dt)
    lb = jnp.full((nz,), -jnp.inf, dt).at[-1].set(0.0).at[2].set(-0.8)
    ub = jnp.full((nz,), jnp.inf, dt).at[-1].set(0.0).at[2].set(0.8)
    plan = tk.TrajPlan(ph=10, ch=5, nx=2, nu=1, mi=11)
    return plan, B, g, Je, ce, Ji, ci, lb, ub


class TestIPMAgainstDensePdip:
    def test_matches_pdip_iteration_for_iteration(self):
        plan, B, g, Je, ce, Ji, ci, lb, ub = _vdp_subproblem()
        dt = B.dtype
        nz, mi = plan.nz, plan.mi
        ci_pos = jnp.maximum(ci, 0.0)
        rho_q = jnp.asarray(
            1e8 * (1.0 + float(jnp.sum(jnp.abs(ce)) + jnp.sum(ci_pos))), dt)
        # dense reference: the exact construction of ops/sqp.py's pdip branch
        zero_col = jnp.zeros((nz, 1), dt)
        B_aug = (jnp.zeros((nz + 1, nz + 1), dt)
                 .at[:nz, :nz].set(B).at[nz, nz].set(rho_q))
        g_aug = jnp.concatenate([g, jnp.zeros((1,), dt)])
        Je_aug = jnp.concatenate([Je, -ce[:, None]], axis=1)
        big = jnp.asarray(1e20, dt)
        flb = jnp.maximum(lb, -big)
        fub = jnp.minimum(ub, big)
        Ji_all = jnp.concatenate([
            jnp.concatenate([Ji, -ci_pos[:, None]], axis=1),
            jnp.concatenate([jnp.eye(nz, dtype=dt), zero_col], axis=1),
            jnp.concatenate([-jnp.eye(nz, dtype=dt), zero_col], axis=1),
        ], axis=0)
        bi_all = jnp.concatenate([-ci, fub, -flb])
        mask_all = jnp.concatenate(
            [jnp.ones((mi,), bool), jnp.isfinite(ub), jnp.isfinite(lb)])
        for it in (1, 3, 8):
            ref = pdip.pdip_solve(B_aug, g_aug, Je_aug, -ce, Ji_all, bi_all,
                                  mask_all, n_iters=it, eps=1e-10)
            out = tk.ipm_solve(plan, B, g, Je, ce, Ji, ci, lb, ub, rho_q,
                               n_iters=it, eps=1e-10)
            assert float(jnp.max(jnp.abs(out.d - ref.d[:nz]))) < 1e-10
            assert float(jnp.max(jnp.abs(out.nu - ref.nu))) < 1e-8
            assert float(jnp.max(jnp.abs(out.lam - ref.lam[:mi]))) < 1e-8
        assert int(out.status) == pdip.OSQP_SOLVED

    def test_warm_y_hook_reaches_same_solution(self):
        """The dual warm-start hook (kept for problem families where it
        pays; the production SQP passes None after it measured slower on
        the oscillator bench) must converge to the same optimum and not
        destabilize the IPM."""
        plan, B, g, Je, ce, Ji, ci, lb, ub = _vdp_subproblem()
        rho_q = jnp.asarray(1e8, B.dtype)
        cold = tk.ipm_solve(plan, B, g, Je, ce, Ji, ci, lb, ub, rho_q,
                            n_iters=40, eps=1e-10)
        assert int(cold.status) == pdip.OSQP_SOLVED
        warm_y = jnp.concatenate([cold.nu, cold.lam, cold.box_net])
        warm = tk.ipm_solve(plan, B, g, Je, ce, Ji, ci, lb, ub, rho_q,
                            n_iters=40, eps=1e-10, warm_y=warm_y)
        assert int(warm.status) == pdip.OSQP_SOLVED
        assert float(jnp.max(jnp.abs(warm.d - cold.d))) < 1e-7
        # an all-zero warm_y must reproduce the cold start exactly
        zero = tk.ipm_solve(plan, B, g, Je, ce, Ji, ci, lb, ub, rho_q,
                            n_iters=40, eps=1e-10,
                            warm_y=jnp.zeros_like(warm_y))
        assert float(jnp.max(jnp.abs(zero.d - cold.d))) == 0.0

    def test_f32_converges(self):
        plan, B, g, Je, ce, Ji, ci, lb, ub = _vdp_subproblem()
        f32 = jnp.float32
        out = tk.ipm_solve(
            plan, B.astype(f32), g.astype(f32), Je.astype(f32),
            ce.astype(f32), Ji.astype(f32), ci.astype(f32),
            lb.astype(f32), ub.astype(f32), jnp.asarray(1e4, f32),
            n_iters=30, eps=1e-7, eps_res=3e-5,
        )
        assert int(out.status) == pdip.OSQP_SOLVED
        assert float(out.res) < 3e-5


class TestControllerParity:
    def _make(self, engine, reg="gauss_newton", dtype=jnp.float64):
        c = NLMPC(2, 1, 2, 10, 5, 11, 0, dtype=dtype)
        c.set_discretization_sampling_time(0.1)
        c.set_optimizer_parameters(NLParameters(
            maximum_iteration=60, enable_warm_start=True,
            inner_qp=engine, hessian_reg=reg))
        c.set_state_space_function(_vdp)
        c.set_objective_function(
            lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
        c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
        return c

    def test_vdp_riccati_matches_pdip(self):
        rng = np.random.default_rng(0)
        x0 = rng.uniform(-1, 1, size=(8, 2))
        u0 = np.zeros((8, 1))
        ca, cb = self._make("pdip"), self._make("riccati")
        assert cb._get_traj_plan() is not None
        ra = ca.optimize(x0, u0)
        rb = cb.optimize(x0, u0)
        assert (np.asarray(ra.status) == 0).all()
        assert (np.asarray(rb.status) == 0).all()
        assert np.abs(np.asarray(ra.cmd) - np.asarray(rb.cmd)).max() < 1e-6
        # warm re-solve parity
        ra2 = ca.optimize(x0, ra.cmd)
        rb2 = cb.optimize(x0, rb.cmd)
        assert np.abs(np.asarray(ra2.cmd) - np.asarray(rb2.cmd)).max() < 1e-6

    def test_oscillators_banded_vs_dense_f64(self):
        """Reduced networked-oscillators config (same structure as the
        reference's largest example, smaller horizon for CPU test time):
        the banded engine must reproduce the dense interior-point
        commands at f64."""
        from bench import _oscillator_dynamics

        def make(engine):
            c = NLMPC(12, 6, 12, 6, 3, 7 * 6, 0, dtype=jnp.float64)
            c.set_discretization_sampling_time(0.1)
            c.set_state_space_function(_oscillator_dynamics)
            c.set_objective_function(
                lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
            c.set_ineq_con_function(
                lambda X, Y, U, e: (U - 0.5).reshape(-1))
            c.set_optimizer_parameters(NLParameters(
                maximum_iteration=40, enable_warm_start=True,
                inner_qp=engine, hessian_reg="gauss_newton"))
            return c

        rng = np.random.default_rng(13)
        x0 = rng.uniform(-0.5, 0.5, size=(4, 12))
        u0 = np.zeros((4, 6))
        ca, cb = make("pdip"), make("riccati")
        assert cb._get_traj_plan() == tk.TrajPlan(ph=6, ch=3, nx=12, nu=6,
                                                  mi=42)
        ra = ca.optimize(x0, u0)
        rb = cb.optimize(x0, u0)
        assert (np.asarray(ra.status) == 0).all()
        assert (np.asarray(rb.status) == 0).all()
        assert np.abs(np.asarray(ra.cmd) - np.asarray(rb.cmd)).max() < 1e-6

    def test_probe_rejects_stage_coupling_objective(self):
        c = NLMPC(2, 1, 2, 10, 5, 11, 0, dtype=jnp.float64)
        c.set_discretization_sampling_time(0.1)
        c.set_optimizer_parameters(NLParameters(inner_qp="riccati",
                                                hessian_reg="gauss_newton"))
        c.set_state_space_function(_vdp)
        # (sum U)^2 couples non-adjacent blocked moves -> not banded
        c.set_objective_function(
            lambda X, Y, U, e: jnp.sum(X**2) + (jnp.sum(U))**2)
        c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
        assert c._get_traj_plan() is None
        # the riccati request degrades to the dense pdip engine and solves
        r = c.optimize(np.array([[0.3, -0.2]]), np.zeros((1, 1)))
        assert (np.asarray(r.status) == 0).all()

    def test_probe_rejects_user_equality(self):
        c = NLMPC(2, 1, 2, 10, 5, 11, 2, dtype=jnp.float64)
        c.set_discretization_sampling_time(0.1)
        c.set_optimizer_parameters(NLParameters(inner_qp="riccati",
                                                hessian_reg="gauss_newton"))
        c.set_state_space_function(_vdp)
        c.set_objective_function(
            lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
        c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
        c.set_eq_con_function(lambda X, U: X[-1] * 0.0)
        assert c._get_traj_plan() is None

    def test_probe_rejects_dense_curvature_modes(self):
        ca = self._make("riccati", reg="eigh")
        assert ca._get_traj_plan() is None
        cb = self._make("riccati", reg="bfgs")
        assert cb._get_traj_plan() is None
