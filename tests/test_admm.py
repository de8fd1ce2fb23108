"""ADMM QP solver unit tests.

The reference leans on OSQP as a black box; here the solver is ours, so it
gets direct coverage: KKT optimality on random strictly-convex QPs, equality
handling, warm starts, infeasibility certificates and the polish step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libmpc_tpu.ops import admm
from libmpc_tpu.types import LParameters

TIGHT = LParameters(maximum_iteration=4000, eps_abs=1e-8, eps_rel=1e-8)


def random_qp(rng, n, m, batch=None):
    L = rng.normal(size=(n, n))
    P = L @ L.T + 0.1 * np.eye(n)
    A = rng.normal(size=(m, n))
    shape = (batch, ) if batch else ()
    q = rng.normal(size=shape + (n,))
    # box centered on an achievable point A x_hat so the QP is feasible even
    # when m > n
    x_hat = rng.normal(size=shape + (n,))
    zc = x_hat @ A.T
    width = rng.uniform(0.1, 1.0, size=shape + (m,))
    return P, A, q, zc - width, zc + width


def kkt_error(P, A, q, l, u, x, y):
    """Max violation of stationarity, feasibility and complementarity."""
    stat = np.abs(x @ P + q + y @ A).max()
    z = x @ A.T
    pfeas = np.maximum(z - u, 0).max() + np.maximum(l - z, 0).max()
    comp = np.abs(y * np.where(y > 0, z - u, z - l)).max()
    return max(stat, pfeas, comp)


class TestUnconstrainedAndEquality:
    def test_unconstrained_matches_linear_solve(self):
        rng = np.random.default_rng(0)
        P, A, q, _, _ = random_qp(rng, 6, 4)
        l = np.full(4, -np.inf)
        u = np.full(4, np.inf)
        sol = admm.admm_solve(jnp.asarray(P), jnp.asarray(A), jnp.asarray(q),
                              jnp.asarray(l), jnp.asarray(u), TIGHT)
        x_expected = np.linalg.solve(P, -q)
        assert int(sol.status) == admm.OSQP_SOLVED
        assert np.allclose(np.asarray(sol.x), x_expected, atol=1e-6)

    def test_equality_constrained(self):
        rng = np.random.default_rng(1)
        n, m = 5, 2
        P, A, q, _, _ = random_qp(rng, n, m)
        b = rng.normal(size=m)
        sol = admm.admm_solve(jnp.asarray(P), jnp.asarray(A), jnp.asarray(q),
                              jnp.asarray(b), jnp.asarray(b), TIGHT)
        # closed form via KKT
        K = np.block([[P, A.T], [A, np.zeros((m, m))]])
        sol_exact = np.linalg.solve(K, np.concatenate([-q, b]))
        assert np.allclose(np.asarray(sol.x), sol_exact[:n], atol=1e-6)
        assert np.allclose(np.asarray(sol.x) @ A.T, b, atol=1e-7)


class TestBoxQP:
    def test_active_box(self):
        # min 1/2 x'x - 1'x s.t. -0.5 <= x <= 0.5 -> x = 0.5
        n = 3
        P = np.eye(n)
        A = np.eye(n)
        q = -np.ones(n)
        sol = admm.admm_solve(jnp.asarray(P), jnp.asarray(A), jnp.asarray(q),
                              jnp.asarray(np.full(n, -0.5)), jnp.asarray(np.full(n, 0.5)),
                              TIGHT)
        assert np.allclose(np.asarray(sol.x), 0.5, atol=1e-7)
        # dual of the active upper bound: y = -(Px + q) at solution -> 0.5
        assert np.allclose(np.asarray(sol.y), 0.5, atol=1e-6)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_random_kkt(self, seed):
        rng = np.random.default_rng(seed)
        P, A, q, l, u = random_qp(rng, 8, 12)
        sol = admm.admm_solve(jnp.asarray(P), jnp.asarray(A), jnp.asarray(q),
                              jnp.asarray(l), jnp.asarray(u), TIGHT)
        assert int(sol.status) == admm.OSQP_SOLVED
        err = kkt_error(P, A, q, l, u, np.asarray(sol.x), np.asarray(sol.y))
        assert err < 1e-5


class TestBatched:
    def test_batch_matches_loop(self):
        rng = np.random.default_rng(7)
        P, A, q, l, u = random_qp(rng, 6, 9, batch=5)
        sol = admm.admm_solve(jnp.asarray(P), jnp.asarray(A), jnp.asarray(q),
                              jnp.asarray(l), jnp.asarray(u), TIGHT)
        assert sol.x.shape == (5, 6)
        for i in range(5):
            err = kkt_error(P, A, q[i], l[i], u[i], np.asarray(sol.x[i]), np.asarray(sol.y[i]))
            assert err < 1e-5

    def test_mixed_loose_finite_rows_across_batch(self):
        """A row loose in one instance but finite in another must not be
        treated as loose for the whole batch: every instance still converges
        at full rate and to the right KKT point (per-instance-bounds path)."""
        rng = np.random.default_rng(21)
        n, m, B = 6, 9, 4
        P, A, q, l, u = random_qp(rng, n, m, batch=B)
        # instance 0: rows 0..3 loose; other instances: finite everywhere
        l = l.copy()
        u = u.copy()
        l[0, :4] = -np.inf
        u[0, :4] = np.inf
        sol = admm.admm_solve(jnp.asarray(P), jnp.asarray(A), jnp.asarray(q),
                              jnp.asarray(l), jnp.asarray(u), TIGHT)
        assert np.all(np.asarray(sol.status) == admm.OSQP_SOLVED)
        for i in range(B):
            err = kkt_error(P, A, q[i], l[i], u[i],
                            np.asarray(sol.x[i]), np.asarray(sol.y[i]))
            assert err < 1e-5, f"instance {i} kkt error {err}"
        # the mixed rows must not degrade convergence: solving instance 1..3
        # alone (no loose rows anywhere) should take a comparable iteration
        # count to solving them inside the mixed batch
        solo = admm.admm_solve(jnp.asarray(P), jnp.asarray(A),
                               jnp.asarray(q[1:]), jnp.asarray(l[1:]),
                               jnp.asarray(u[1:]), TIGHT)
        assert int(np.max(np.asarray(sol.iters)[1:])) <= 2 * int(
            np.max(np.asarray(solo.iters))
        ) + 50

    def test_heterogeneous_structure_via_vmap(self):
        rng = np.random.default_rng(11)
        n, m, B = 4, 6, 3
        Ps, As, qs, ls, us = [], [], [], [], []
        for _ in range(B):
            P, A, q, l, u = random_qp(rng, n, m)
            Ps.append(P), As.append(A), qs.append(q), ls.append(l), us.append(u)
        Ps, As, qs, ls, us = map(np.stack, (Ps, As, qs, ls, us))
        solve = jax.vmap(lambda P, A, q, l, u: admm.admm_solve(P, A, q, l, u, TIGHT))
        sol = solve(*map(jnp.asarray, (Ps, As, qs, ls, us)))
        for i in range(B):
            err = kkt_error(Ps[i], As[i], qs[i], ls[i], us[i],
                            np.asarray(sol.x[i]), np.asarray(sol.y[i]))
            assert err < 1e-5


class TestWarmStart:
    def test_warm_start_converges_fast(self):
        rng = np.random.default_rng(3)
        P, A, q, l, u = random_qp(rng, 8, 10)
        params = LParameters(maximum_iteration=4000, eps_abs=1e-9, eps_rel=1e-9,
                             enable_warm_start=True, polish=False,
                             check_termination=5)
        args = tuple(map(jnp.asarray, (P, A, q, l, u)))
        cold = admm.admm_solve(*args, params)
        warm = admm.admm_solve(*args, params, warm_x=cold.x, warm_y=cold.y)
        assert int(warm.iters) <= int(cold.iters) / 2
        assert np.allclose(np.asarray(warm.x), np.asarray(cold.x), atol=1e-6)


class TestInfeasibility:
    def test_primal_infeasible(self):
        # x <= -1 and x >= 1 simultaneously
        P = np.eye(1)
        A = np.array([[1.0], [1.0]])
        q = np.zeros(1)
        l = np.array([-np.inf, 1.0])
        u = np.array([-1.0, np.inf])
        sol = admm.admm_solve(jnp.asarray(P), jnp.asarray(A), jnp.asarray(q),
                              jnp.asarray(l), jnp.asarray(u),
                              LParameters(maximum_iteration=4000))
        assert int(sol.status) == admm.OSQP_PRIMAL_INFEASIBLE

    def test_dual_infeasible(self):
        # unbounded below: P = 0, q = -1, x >= 0 free above
        P = np.zeros((1, 1))
        A = np.eye(1)
        q = np.array([-1.0])
        l = np.array([0.0])
        u = np.array([np.inf])
        sol = admm.admm_solve(jnp.asarray(P), jnp.asarray(A), jnp.asarray(q),
                              jnp.asarray(l), jnp.asarray(u),
                              LParameters(maximum_iteration=4000))
        assert int(sol.status) == admm.OSQP_DUAL_INFEASIBLE


class TestPolish:
    def test_polish_improves_loose_solve(self):
        rng = np.random.default_rng(5)
        P, A, q, l, u = random_qp(rng, 8, 12)
        loose_nopolish = LParameters(maximum_iteration=200, eps_abs=1e-3,
                                     eps_rel=1e-3, polish=False)
        loose_polish = LParameters(maximum_iteration=200, eps_abs=1e-3,
                                   eps_rel=1e-3, polish=True)
        args = tuple(map(jnp.asarray, (P, A, q, l, u)))
        rough = admm.admm_solve(*args, loose_nopolish)
        polished = admm.admm_solve(*args, loose_polish)
        err_rough = kkt_error(P, A, q, l, u, np.asarray(rough.x), np.asarray(rough.y))
        err_pol = kkt_error(P, A, q, l, u, np.asarray(polished.x), np.asarray(polished.y))
        assert err_pol <= err_rough
        assert err_pol < 1e-6

    def test_polish_runs_from_nopolish_prepared_cache(self):
        """A PreparedQP built under polish=False params omits the shared
        polish base inverse; a later polish=True solve handed that cache
        must rebuild it on the fly instead of crashing."""
        rng = np.random.default_rng(6)
        P, A, q, l, u = random_qp(rng, 8, 12)
        args = tuple(map(jnp.asarray, (P, A, q, l, u)))
        no_pol = LParameters(maximum_iteration=200, eps_abs=1e-3,
                             eps_rel=1e-3, polish=False)
        with_pol = LParameters(maximum_iteration=200, eps_abs=1e-3,
                               eps_rel=1e-3, polish=True)
        eq_mask = jnp.asarray((l == u) & np.isfinite(l))
        loose_mask = jnp.asarray(
            (l <= -admm.INF_BOUND) & (u >= admm.INF_BOUND)
        )
        prep_no = admm.prepare_qp(args[0], args[1], jnp.abs(args[2]),
                                  eq_mask, loose_mask, no_pol)
        assert prep_no.Mpinv is None and prep_no.Mpinv_lo is None
        prep_yes = admm.prepare_qp(args[0], args[1], jnp.abs(args[2]),
                                   eq_mask, loose_mask, with_pol)
        assert prep_yes.Mpinv is not None
        polished = admm.admm_solve(*args, with_pol, prepared=prep_no)
        direct = admm.admm_solve(*args, with_pol, prepared=prep_yes)
        err = kkt_error(P, A, q, l, u,
                        np.asarray(polished.x), np.asarray(polished.y))
        assert err < 1e-6
        assert np.allclose(np.asarray(polished.x), np.asarray(direct.x),
                           atol=1e-7)

    def test_polish_comp_passes_knob(self):
        """float32 shared polish: the compensated-refinement pass budget
        trades accuracy margin for step time gracefully (CPU-f32 curve:
        0 passes ~9e-4, 4 passes ~4e-5, 8 passes ~2e-5 vs the f64 golden)."""
        import os
        import sys
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        from __graft_entry__ import _quadrotor_setup
        from libmpc_tpu.lmpc import problem as qp
        import jax

        dtype = jnp.float32
        c = _quadrotor_setup(dtype)
        golden = np.array([-0.9916, 1.74839, -0.9916, 1.74839])
        dims, prob = c.dims, c._prob
        P, A, lineq, uineq = qp.build_time_invariant(dims, prob)
        with jax.default_matmul_precision("highest"):
            q, l, u = qp.build_time_varying(
                dims, prob, lineq, uineq, jnp.zeros((12,), dtype),
                jnp.zeros((4,), dtype),
                c._y_ref, c._u_ref, c._du_ref, c._u_meas)
        errs = {}
        for passes in (0, 4, 8):
            p = LParameters(maximum_iteration=100, polish=True,
                            polish_mode="shared", rho=0.01,
                            polish_comp_passes=passes)
            sol = admm.admm_solve(P, A, q, l, u, p,
                                  eq_mask=jnp.arange(dims.m) < dims.n_eq)
            _, inputs, _ = qp.unpack_solution(dims, prob, sol.x, c._u_meas)
            errs[passes] = float(np.abs(np.asarray(inputs)[0] - golden).max())
        assert errs[4] < 1e-4
        assert errs[8] <= errs[4] <= errs[0]

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
    def test_polish_prep_pair_is_the_f64_inverse(self, dtype):
        """hi + lo carries the float64 inverse of Mp past the precision of
        one float32 word, and the vmapped call equals the per-instance
        calls."""
        rng = np.random.default_rng(7)
        B, n, m, me = 3, 6, 9, 2
        Ps, As = [], []
        for _ in range(B):
            P, A, *_ = random_qp(rng, n, m)
            Ps.append(P)
            As.append(A)
        P = jnp.asarray(np.stack(Ps), dtype)
        A = jnp.asarray(np.stack(As), dtype)
        eq = jnp.arange(m) < me
        hi, lo = jax.jit(jax.vmap(admm._polish_prep, (0, 0, None)))(P, A, eq)
        delta = admm._polish_delta_shared(dtype)
        for b in range(B):
            P64 = np.asarray(P[b], np.float64)
            A64 = np.asarray(A[b], np.float64)
            Mp = P64 + delta * np.eye(n) + A64[:me].T @ A64[:me] / delta
            pair = np.asarray(hi[b], np.float64) + np.asarray(lo[b], np.float64)
            # the residual of a float64 inverse at condition ~1/delta^2;
            # a single float32 word alone leaves ~1e-4
            assert np.abs(Mp @ pair - np.eye(n)).max() < 1e-7
            h1, l1 = admm._polish_prep(P[b], A[b], eq)
            assert np.array_equal(np.asarray(h1), np.asarray(hi[b]))
            assert np.array_equal(np.asarray(l1), np.asarray(lo[b]))

    def test_shared_polish_vmapped_in_while_loop_without_x64(self):
        """A float32 user with x64 off: the shared polish under vmap of a
        while_loop (the SQP's shape) traces, compiles and stays float32."""
        import os
        import subprocess
        import sys
        import textwrap

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        script = textwrap.dedent("""
            import numpy as np, jax, jax.numpy as jnp
            from libmpc_tpu.ops import admm
            from libmpc_tpu.types import LParameters
            assert not jax.config.read("jax_enable_x64")
            rng = np.random.default_rng(0)
            B, n, me = 4, 6, 2
            m = me + n
            Q = rng.normal(size=(B, n, n))
            P = Q @ np.swapaxes(Q, 1, 2) / n + np.eye(n)
            A = np.concatenate([rng.normal(size=(B, me, n)),
                                np.broadcast_to(np.eye(n), (B, n, n))], 1)
            q = rng.normal(size=(B, n))
            l = np.concatenate([np.zeros((B, me)), -np.ones((B, n))], 1)
            u = np.concatenate([np.zeros((B, me)), np.ones((B, n))], 1)
            P, A, q, l, u = (jnp.asarray(v, jnp.float32)
                             for v in (P, A, q, l, u))
            eq = jnp.arange(m) < me
            par = LParameters(polish=True, polish_mode="shared")

            def one(P, A, q, l, u):
                def body(c):
                    k, x = c
                    sol = admm.admm_solve(P, A, q + 0.1 * x, l, u,
                                          params=par, eq_mask=eq)
                    return k + 1, sol.x.reshape(n)
                return jax.lax.while_loop(
                    lambda c: c[0] < 2, body,
                    (0, jnp.zeros((n,), jnp.float32)))[1]

            x = jax.jit(jax.vmap(one))(P, A, q, l, u)
            assert x.dtype == jnp.float32 and x.shape == (B, n)
            assert np.isfinite(np.asarray(x)).all()
            print("OK")
        """)
        env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="0",
                   PYTHONPATH=repo)
        out = subprocess.run([sys.executable, "-c", script], cwd=repo,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip().endswith("OK")


class TestStragglerCompaction:
    def test_compaction_matches_lockstep(self):
        """Once actives fall to cap, the solver gathers them into a small
        batch and continues — bitwise-identical with fixed rho; with
        adaptive rho the masked reduction shape changes (B -> cap) so the
        shared rho may differ by an ulp and results agree to rounding."""
        rng = np.random.default_rng(0)
        B = 512
        P, A, q, l, u = random_qp(rng, 10, 17, batch=B)
        args = tuple(map(jnp.asarray, (P, A, q, l, u)))
        for exact, extra in (
            (True, dict(maximum_iteration=4000, eps_abs=1e-8, eps_rel=1e-8,
                        rho=0.1, adaptive_rho=False, scaling_iters=0,
                        polish=False)),
            (False, dict(maximum_iteration=200, rho=0.01, polish=True,
                         polish_mode="shared")),
        ):
            on = admm.admm_solve(
                *args, LParameters(compact_stragglers=True, **extra))
            off = admm.admm_solve(
                *args, LParameters(compact_stragglers=False, **extra))
            assert np.array_equal(np.asarray(on.status), np.asarray(off.status))
            if exact:
                assert np.array_equal(np.asarray(on.iters), np.asarray(off.iters))
                assert np.array_equal(np.asarray(on.x), np.asarray(off.x))
                assert np.array_equal(np.asarray(on.y), np.asarray(off.y))
            else:
                assert np.allclose(np.asarray(on.x), np.asarray(off.x),
                                   atol=1e-9)
                assert np.allclose(np.asarray(on.y), np.asarray(off.y),
                                   atol=1e-9)

    def test_compaction_with_shared_unbatched_bounds(self):
        """Batched q with shared (m,) l/u must keep working (the bounds are
        broadcast to the batch before the compaction gathers)."""
        rng = np.random.default_rng(2)
        B = 512
        P, A, q, l, u = random_qp(rng, 10, 17, batch=B)
        args = (jnp.asarray(P), jnp.asarray(A), jnp.asarray(q),
                jnp.asarray(l[0]), jnp.asarray(u[0]))
        p = LParameters(maximum_iteration=300, rho=0.05, polish=False)
        sol = admm.admm_solve(*args, p)
        ref = admm.admm_solve(jnp.asarray(P), jnp.asarray(A), jnp.asarray(q),
                              jnp.asarray(np.broadcast_to(l[0], l.shape)),
                              jnp.asarray(np.broadcast_to(u[0], u.shape)), p)
        assert np.array_equal(np.asarray(sol.x), np.asarray(ref.x))


class TestMaxIterInaccurateStatuses:
    """A max-iteration exit re-checks the final iterate with 100x-relaxed
    tolerances and reports OSQP's *_INACCURATE statuses — the one corner of
    the OSQP status surface the reference maps
    (include/mpc/LMPC/LOptimizer.hpp:398-403) that needs a deliberately
    starved solve to reach."""

    def _base(self, **kw):
        # OSQP iteration-for-iteration parity settings: zero cold start and
        # no stall detection, so the staged maximum_iteration expectations
        # below see exactly OSQP's iterate trajectory
        return LParameters(
            polish=False, check_termination=1,
            compact_stragglers=False, eps_abs=1e-12, eps_rel=1e-12,
            cold_start="zeros", stall_checks=0, **kw)

    def test_solved_inaccurate_uses_relative_criterion(self):
        """Residuals within 100x of the RELATIVE tolerance at max-iter ->
        OSQP_SOLVED_INACCURATE; outside the band -> MAX_ITER_REACHED."""
        P = jnp.array([[4.0, 1.0], [1.0, 2.0]])
        A = jnp.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
        q = jnp.array([[1.0, 1.0]])
        l = jnp.array([[1.0, 0.0, 0.0]])
        u = jnp.array([[1.0, 0.7, 0.7]])
        base = dict(polish=False, check_termination=5,
                    compact_stragglers=False, cold_start="zeros",
                    stall_checks=0)
        # converge exactly at eps=1e-10 to learn the iteration count
        ref = admm.admm_solve(P, A, q, l, u, LParameters(
            maximum_iteration=4000, eps_abs=1e-10, eps_rel=1e-10, **base))
        assert int(ref.status[0]) == admm.OSQP_SOLVED
        k = int(ref.iters[0])
        # same iterate, tolerances tightened 100x, iterations capped at k:
        # the residual now sits inside the (eps, 100*eps] band
        sol = admm.admm_solve(P, A, q, l, u, LParameters(
            maximum_iteration=k, eps_abs=1e-12, eps_rel=1e-12, **base))
        assert int(sol.status[0]) == admm.OSQP_SOLVED_INACCURATE
        # far outside the band (residual >> 100*eps): plain MAX_ITER
        sol2 = admm.admm_solve(P, A, q, l, u, LParameters(
            maximum_iteration=k, eps_abs=1e-15, eps_rel=1e-15, **base))
        assert int(sol2.status[0]) == admm.OSQP_MAX_ITER_REACHED

    def _primal_infeasible_problem(self):
        rng = np.random.default_rng(3)
        n, m = 5, 8
        A = rng.normal(size=(m, n))
        A[1] = A[0] * 1.7  # row1 is a scaled copy of row0 ...
        l = np.full((1, m), -1.0)
        u = np.full((1, m), 1.0)
        l[0, 0], u[0, 0] = 1.0, np.inf  # ... forced >= 1
        l[0, 1], u[0, 1] = -np.inf, -1.0  # ... and (scaled) <= -1
        return (jnp.eye(n), jnp.asarray(A), jnp.zeros((1, n)),
                jnp.asarray(l), jnp.asarray(u))

    def test_primal_infeasible_inaccurate_band(self):
        args = self._primal_infeasible_problem()
        p = self._base(eps_prim_inf=1e-9)
        # full run: the exact certificate fires
        import dataclasses
        full = admm.admm_solve(*args, dataclasses.replace(
            p, maximum_iteration=200))
        assert int(full.status[0]) == admm.OSQP_PRIMAL_INFEASIBLE
        # starved mid-convergence: the certificate error sits between
        # eps_prim_inf and 100*eps_prim_inf -> INACCURATE at max-iter
        # (band located by a deterministic CPU/f64 scan)
        mid = admm.admm_solve(*args, dataclasses.replace(
            p, maximum_iteration=38))
        assert int(mid.status[0]) == admm.OSQP_PRIMAL_INFEASIBLE_INACCURATE
        # far before the band: plain MAX_ITER
        early = admm.admm_solve(*args, dataclasses.replace(
            p, maximum_iteration=30))
        assert int(early.status[0]) == admm.OSQP_MAX_ITER_REACHED

    def _dual_infeasible_problem(self):
        rng = np.random.default_rng(5)
        Bm = rng.normal(size=(2, 3))
        _, _, Vt = np.linalg.svd(Bm)
        v = Vt[-1]  # objective unbounded along the nullspace of Bm
        P = jnp.asarray(Bm.T @ Bm)
        q = jnp.asarray(-v)[None, :]
        A = jnp.asarray(Bm)
        return P, A, q, jnp.full((1, 2), -1.0), jnp.full((1, 2), 1.0)

    def test_dual_infeasible_inaccurate_band(self):
        args = self._dual_infeasible_problem()
        p = self._base(eps_dual_inf=1e-9)
        import dataclasses
        full = admm.admm_solve(*args, dataclasses.replace(
            p, maximum_iteration=200))
        assert int(full.status[0]) == admm.OSQP_DUAL_INFEASIBLE
        mid = admm.admm_solve(*args, dataclasses.replace(
            p, maximum_iteration=10))
        assert int(mid.status[0]) == admm.OSQP_DUAL_INFEASIBLE_INACCURATE
        early = admm.admm_solve(*args, dataclasses.replace(
            p, maximum_iteration=4))
        assert int(early.status[0]) == admm.OSQP_MAX_ITER_REACHED

    def test_controller_maps_inaccurate_statuses(self):
        """The controller-level status map sends all three INACCURATE codes
        to SUCCESS like the reference (LOptimizer.hpp:398-403)."""
        from libmpc_tpu.lmpc.controller import _status_from_osqp
        from libmpc_tpu.types import ResultStatus

        codes = jnp.asarray([
            admm.OSQP_SOLVED_INACCURATE,
            admm.OSQP_PRIMAL_INFEASIBLE_INACCURATE,
            admm.OSQP_DUAL_INFEASIBLE_INACCURATE,
        ])
        out = np.asarray(_status_from_osqp(codes))
        assert (out == int(ResultStatus.SUCCESS)).all()


class TestRound4Knobs:
    """stall_checks / cold_start: behavior-preserving on converged solves."""

    def _problem(self, B=16, seed=0):
        P, A, q, l, u = random_qp(np.random.default_rng(seed), n=8, m=14,
                                  batch=B)
        return P, A, q, l, u

    def test_cold_start_kkt_matches_zeros_when_converged(self):
        P, A, q, l, u = self._problem()
        import dataclasses
        base = LParameters(maximum_iteration=4000, eps_abs=1e-9,
                           eps_rel=1e-9, polish=False,
                           compact_stragglers=False)
        sa = admm.admm_solve(P, A, q, l, u,
                             dataclasses.replace(base, cold_start="zeros"))
        sb = admm.admm_solve(P, A, q, l, u,
                             dataclasses.replace(base, cold_start="kkt"))
        assert (np.asarray(sa.status) == admm.OSQP_SOLVED).all()
        assert (np.asarray(sb.status) == admm.OSQP_SOLVED).all()
        # different iterates, same optimum
        assert np.abs(np.asarray(sa.x) - np.asarray(sb.x)).max() < 1e-6

    def test_cold_start_kkt_duals_matches_zeros_when_converged(self):
        """round-5 knob: the dual-seeded cold start changes the starting
        point only — converged solves land on the identical optimum."""
        P, A, q, l, u = self._problem(seed=3)
        import dataclasses
        base = LParameters(maximum_iteration=4000, eps_abs=1e-9,
                           eps_rel=1e-9, polish=False,
                           compact_stragglers=False)
        sa = admm.admm_solve(P, A, q, l, u,
                             dataclasses.replace(base, cold_start="zeros"))
        sb = admm.admm_solve(P, A, q, l, u,
                             dataclasses.replace(base, cold_start="kkt_duals"))
        assert (np.asarray(sa.status) == admm.OSQP_SOLVED).all()
        assert (np.asarray(sb.status) == admm.OSQP_SOLVED).all()
        assert np.abs(np.asarray(sa.x) - np.asarray(sb.x)).max() < 1e-6

    def test_cold_rho_same_optimum_and_warm_inert(self):
        """round-5 knob: cold_rho changes only the COLD starting rho —
        same converged optimum; a warm solve (have_warm=True) must be
        bitwise identical with the knob on or off."""
        P, A, q, l, u = self._problem(seed=5)
        import dataclasses
        base = LParameters(maximum_iteration=4000, eps_abs=1e-9,
                           eps_rel=1e-9, polish=False,
                           compact_stragglers=False, enable_warm_start=True)
        hot = dataclasses.replace(base, cold_rho=0.5)
        zx = jnp.zeros((q.shape[0], P.shape[0]))
        zy = jnp.zeros((q.shape[0], A.shape[0]))
        sa = admm.admm_solve(P, A, q, l, u, base, warm_x=zx, warm_y=zy,
                             have_warm=jnp.asarray(False))
        sb = admm.admm_solve(P, A, q, l, u, hot, warm_x=zx, warm_y=zy,
                             have_warm=jnp.asarray(False))
        assert (np.asarray(sa.status) == admm.OSQP_SOLVED).all()
        assert (np.asarray(sb.status) == admm.OSQP_SOLVED).all()
        assert np.abs(np.asarray(sa.x) - np.asarray(sb.x)).max() < 1e-6
        # warm path: knob must be invisible
        wa = admm.admm_solve(P, A, q, l, u, base, warm_x=sa.x, warm_y=sa.y,
                             have_warm=jnp.asarray(True))
        wb = admm.admm_solve(P, A, q, l, u, hot, warm_x=sa.x, warm_y=sa.y,
                             have_warm=jnp.asarray(True))
        assert np.array_equal(np.asarray(wa.x), np.asarray(wb.x))
        assert np.array_equal(np.asarray(wa.iters), np.asarray(wb.iters))

    def test_stall_checks_inert_on_f64(self):
        """f64 runs never stall-freeze (the detector is gated to f32):
        identical solver output with the knob on or off."""
        P, A, q, l, u = self._problem()
        import dataclasses
        base = LParameters(maximum_iteration=300, polish=False,
                           compact_stragglers=False,
                           check_termination=5)
        sa = admm.admm_solve(P, A, q, l, u,
                             dataclasses.replace(base, stall_checks=0))
        sb = admm.admm_solve(P, A, q, l, u,
                             dataclasses.replace(base, stall_checks=3))
        assert np.array_equal(np.asarray(sa.x), np.asarray(sb.x))
        assert np.array_equal(np.asarray(sa.iters), np.asarray(sb.iters))

    def test_stall_checks_freezes_f32_floor_stall(self):
        """A float32 solve whose tolerance sits just below the f32 residual
        floor (inside the stall detector's 10x band) must freeze with
        OSQP_SOLVED_INACCURATE well before the iteration cap instead of
        burning it."""
        P, A, q, l, u = random_qp(np.random.default_rng(0), n=8, m=14)
        f32 = jnp.float32
        args = [jnp.asarray(np.asarray(a), f32) for a in (P, A, q, l, u)]
        import dataclasses
        base = LParameters(maximum_iteration=800, polish=False,
                           compact_stragglers=False,
                           check_termination=5, adaptive_rho=False, rho=0.1)
        # learn the instance's f32 residual floor: run to the cap at an
        # unreachable tolerance and read the final residuals
        probe = admm.admm_solve(*args, dataclasses.replace(
            base, eps_abs=1e-12, eps_rel=1e-12, stall_checks=0))
        floor = float(max(np.asarray(probe.pri_res),
                          np.asarray(probe.dua_res)))
        assert int(probe.iters) == 800  # genuinely floored
        # tolerance just below the floor -> floor-stalled inside the 10x
        # band: the detector must freeze early with the INACCURATE verdict
        sol = admm.admm_solve(*args, dataclasses.replace(
            base, eps_abs=floor / 3.0, eps_rel=0.0, stall_checks=3))
        assert int(sol.status) == admm.OSQP_SOLVED_INACCURATE, sol.status
        # frozen before exhausting the cap (the instance enters the 10x
        # band late on this problem; measured freeze at ~430 of 800)
        assert int(sol.iters) < 600, sol.iters
