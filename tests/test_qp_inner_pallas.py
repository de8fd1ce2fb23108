"""Tests for the fused batched inner-QP kernel (ops/qp_inner_pallas, Pallas
through Triton) and the ``inner_qp="fused"`` SQP mode.

Reference context: the SQP subproblems the reference hands to NLopt/SLSQP's
internal QP layer (include/mpc/NLMPC/NLOptimizer.hpp:64); here a whole batch
of them solves in one kernel launch.  CPU tests run the same kernel through
the Pallas interpreter.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libmpc_tpu import NLMPC
from libmpc_tpu.ops import admm, qp_inner_pallas as qip, sqp
from libmpc_tpu.types import LParameters, NLParameters


def _random_qps(B, n, me, mi, seed=0):
    rng = np.random.default_rng(seed)
    m = me + mi + n
    P = np.zeros((B, n, n), np.float32)
    A = np.zeros((B, m, n), np.float32)
    q = np.zeros((B, n), np.float32)
    l = np.zeros((B, m), np.float32)
    u = np.zeros((B, m), np.float32)
    for b in range(B):
        Q = rng.normal(size=(n, n))
        P[b] = Q @ Q.T / n + 0.5 * np.eye(n)
        A[b] = np.concatenate(
            [rng.normal(size=(me + mi, n)), np.eye(n)], axis=0
        )
        q[b] = rng.normal(size=n)
        be = rng.normal(size=me) * 0.1
        bi = np.abs(rng.normal(size=mi)) + 0.5
        l[b] = np.concatenate([be, -np.inf * np.ones(mi), -5 * np.ones(n)])
        u[b] = np.concatenate([be, bi, 5 * np.ones(n)])
    eq = np.zeros(m, bool)
    eq[:me] = True
    return P, A, q, l, u, eq


class TestFusedKernel:
    def test_matches_f64_admm_reference(self):
        B, n, me, mi = 5, 11, 4, 3
        P, A, q, l, u, eq = _random_qps(B, n, me, mi)
        m = A.shape[1]
        par = LParameters(maximum_iteration=4000, eps_abs=1e-10,
                          eps_rel=1e-10, polish=True, scaling_iters=10,
                          rho=0.1)
        ref = jax.vmap(
            lambda P_, A_, q_, l_, u_: admm.admm_solve(
                P_.astype(jnp.float64), A_.astype(jnp.float64),
                q_.astype(jnp.float64), l_.astype(jnp.float64),
                u_.astype(jnp.float64), params=par,
                eq_mask=jnp.asarray(eq),
            )
        )(*map(jnp.asarray, (P, A, q, l, u)))
        x, y, z, iters, done, pri, dua = qip.solve_batched(
            *map(jnp.asarray, (P, A, q, l, u)),
            jnp.zeros((B, n), jnp.float32), jnp.zeros((B, m), jnp.float32),
            n_eq=me, max_iter=1000, interpret=True)
        err = np.abs(np.asarray(x) - np.asarray(ref.x)).max()
        assert err < 5e-4, err
        assert bool(np.asarray(done).any())

    def test_partial_tile_padding(self):
        # B=3 pads to a 4-instance tile by edge replication and (7, 17)
        # pads to (8, 32): results for the real instances must match the
        # unpadded one-instance tiles and every instance must converge
        B, n, me, mi = 3, 7, 2, 1
        P, A, q, l, u, eq = _random_qps(B, n, me, mi, seed=2)
        m = A.shape[1]
        args = [jnp.asarray(v) for v in (P, A, q, l, u)]
        x0 = jnp.zeros((B, n), jnp.float32)
        y0 = jnp.zeros((B, m), jnp.float32)
        x, *_ , done, pri, dua = qip.solve_batched(
            *args, x0, y0, n_eq=me, max_iter=500, tile=4, interpret=True)
        x1, *_ = qip.solve_batched(
            *args, x0, y0, n_eq=me, max_iter=500, tile=1, interpret=True)
        assert x.shape == (B, n)
        assert np.isfinite(np.asarray(x)).all()
        assert np.asarray(done).all()
        np.testing.assert_allclose(np.asarray(x), np.asarray(x1), atol=1e-6)

    def test_custom_vmap_dispatch(self):
        # the per-instance wrapper under vmap must produce the same result
        # as the direct batched call
        B, n, me, mi = 4, 9, 3, 2
        P, A, q, l, u, eq = _random_qps(B, n, me, mi, seed=4)
        m = A.shape[1]
        solve = qip.make_inner_qp_solver(n_eq=me, max_iter=500, interpret=True)
        args = [jnp.asarray(v) for v in (P, A, q, l, u)]
        x0 = jnp.zeros((B, n), jnp.float32)
        y0 = jnp.zeros((B, m), jnp.float32)
        xv, yv_, zv, *_ = jax.vmap(solve)(*args, x0, y0)
        xb, yb, zb, *_ = qip.solve_batched(*args, x0, y0, n_eq=me,
                                           max_iter=500, interpret=True)
        np.testing.assert_allclose(np.asarray(xv), np.asarray(xb), atol=1e-6)

    def test_converges_like_plain_admm(self):
        # the kernel's adaptive rho is the plain engine's (scalar rho per
        # instance inside the float32 bounds): on cold Van der Pol SQP
        # subproblems at the float32 tolerance it converges at least as
        # often as the vmapped XLA ADMM with the same settings
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        import chip_smoke

        B = 128
        P, A, q, lo, hi, eq = chip_smoke._vdp_subproblems(B)
        n, m = q.shape[1], A.shape[1]
        kw = dict(eps_abs=5e-6, eps_rel=5e-6, max_iter=300, check_every=25)
        x0 = jnp.zeros((B, n), jnp.float32)
        y0 = jnp.zeros((B, m), jnp.float32)
        _, _, _, _, done, _, _ = qip.solve_batched(
            P, A, q, lo, hi, x0, y0, n_eq=int(eq.sum()), tile=B,
            interpret=True, **kw)
        par = LParameters(maximum_iteration=300, eps_abs=5e-6, eps_rel=5e-6,
                          sigma=1e-5, rho=0.1, check_termination=25,
                          polish=False, scaling_iters=10, stall_checks=0)
        ref = jax.jit(jax.vmap(lambda *a: admm.admm_solve(
            *a, params=par, eq_mask=eq)))(P, A, q, lo, hi)
        plain = np.mean(np.asarray(ref.status) == admm.OSQP_SOLVED)
        assert np.mean(np.asarray(done)) >= plain - 0.01, (
            np.mean(np.asarray(done)), plain)


class TestFusedSQPMode:
    def _vdp_controller(self, inner):
        def vdp(x, u, k):
            return jnp.array(
                [x[1], 0.5 * (1 - x[0] ** 2) * x[1] - x[0] + u[0]]
            )

        c = NLMPC(nx=2, nu=1, ny=2, ph=10, ch=5, ineq=11, eq=0,
                  dtype=jnp.float32)
        c.set_discretization_sampling_time(0.1)
        c.set_optimizer_parameters(
            NLParameters(maximum_iteration=60, inner_qp=inner))
        c.set_state_space_function(vdp)
        c.set_objective_function(
            lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
        c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
        return c

    def test_fused_matches_pdip_commands(self, fused_kernel_interpreted):
        rng = np.random.default_rng(1)
        x0 = rng.normal(size=(4, 2)).astype(np.float32)
        u0 = np.zeros((4, 1), np.float32)
        cmds = {}
        for inner in ("pdip", "fused"):
            c = self._vdp_controller(inner)
            d = c.dims
            assert sqp.inner_engine(
                c._params, c.dtype, d.nz, d.ph * d.nx + d.eq, d.ineq,
                c._get_traj_plan()) == inner
            res = c.optimize(x0, u0)
            assert (np.asarray(res.status) == 0).all(), inner
            cmds[inner] = np.asarray(res.cmd)
        assert np.abs(cmds["pdip"] - cmds["fused"]).max() < 5e-3

    def test_fused_f64_falls_back_to_pdip(self):
        # the fused kernel is float32-only by design; an f64 problem asking
        # for it must still solve correctly (pdip path)
        def vdp(x, u, k):
            return jnp.array(
                [x[1], 0.5 * (1 - x[0] ** 2) * x[1] - x[0] + u[0]]
            )

        c = NLMPC(nx=2, nu=1, ny=2, ph=6, ch=3, ineq=7, eq=0,
                  dtype=jnp.float64)
        c.set_discretization_sampling_time(0.1)
        c.set_optimizer_parameters(
            NLParameters(maximum_iteration=60, inner_qp="fused"))
        c.set_state_space_function(vdp)
        c.set_objective_function(
            lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
        c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
        res = c.optimize(np.array([0.0, 1.0]), np.zeros(1))
        assert int(np.asarray(res.status)) == 0
