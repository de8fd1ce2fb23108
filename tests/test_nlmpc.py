"""NLMPC tests.

Parity models: test/NLMPC/test_common.cpp (unwrap/mapping goldens),
test/NLMPC/test_constraints.cpp (defect values + Jacobian goldens, user
constraint plumbing), test/NLMPC/test_objective.cpp (objective golden 65730),
test/NLMPC/test_nloptimizer.cpp (bound packing), examples/vanderpol_ex.cpp
(closed-loop behavior).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libmpc_tpu import NLMPC, HorizonSlice, NLParameters, ResultStatus, inf
from libmpc_tpu.dims import NLDims
from libmpc_tpu.nlmpc import problem as nlp

MAPPING_SWEEP = [(1, 1, 1, 1), (5, 1, 1, 1), (5, 3, 1, 1),
                 (5, 3, 7, 1), (5, 3, 7, 4), (5, 3, 7, 7)]


def vdp_continuous(x, u, k):
    """Van der Pol vector field (examples/vanderpol_ex.cpp:33-40)."""
    dx0 = (1.0 - x[1] * x[1]) * x[0] - x[1] + u[0]
    dx1 = x[0]
    return jnp.stack([dx0, dx1])


@pytest.mark.parametrize("nx,nu,ph,ch", MAPPING_SWEEP)
class TestUnwrap:
    def test_unwrap_golden(self, nx, nu, ph, ch):
        # (parity: test/NLMPC/test_common.cpp:46-106)
        dims = NLDims(nx, nu, 1, ph, ch, 1, 1)
        z = jnp.arange(dims.nz, dtype=jnp.float64)
        x0 = -jnp.arange(1, nx + 1, dtype=jnp.float64)
        ss = jnp.ones(nx)
        us = jnp.ones(nu)
        X, U, slack = nlp.unwrap(dims, z, x0, ss, us)
        zn = np.asarray(z)
        assert np.allclose(np.asarray(X)[0], np.asarray(x0))
        for i in range(1, ph + 1):
            assert np.allclose(np.asarray(X)[i], zn[(i - 1) * nx : i * nx])
        u_index = 0
        for i in range(ph + 1):
            if i < ch:
                u_index = ph * nx + i * nu
            assert np.allclose(np.asarray(U)[i], zn[u_index : u_index + nu])
        assert float(slack) == zn[-1]


class TestDefects:
    def test_vdp_trapezoidal_golden(self):
        # (parity: test/NLMPC/test_constraints.cpp:60-142)
        dims = NLDims(2, 1, 1, 2, 2, 0, 0)
        fns = nlp.NLFunctions(state_fn=vdp_continuous, continuous=True, ts=0.01)
        z = jnp.arange(dims.nz, dtype=jnp.float64)  # [0..6]
        x0 = jnp.zeros(2)
        ss = jnp.ones(2)
        us = jnp.ones(1)
        c = nlp.state_defects(dims, fns, ss, us, z, x0)
        expected = np.array([0.035, -1.0, -2.05, -1.99])
        assert np.allclose(np.asarray(c), expected, atol=1e-3)

        J = jax.jacfwd(lambda zz: nlp.state_defects(dims, fns, ss, us, zz, x0))(z)
        j_expected = np.array([
            [-1, -0.005, 0, 0, 0.01, 0, 0],
            [0.005, -1, 0, 0, 0, 0, 0],
            [1, -0.005, -1.04, -0.065, 0, 0.01, 0],
            [0.005, 1, 0.005, -1, 0, 0, 0],
        ])
        assert np.allclose(np.asarray(J), j_expected, atol=1e-3)

    def test_discrete_defects_linear(self):
        # discrete defect c_k = x_{k+1} - (A x_k + B u_k)
        dims = NLDims(2, 1, 2, 3, 3, 0, 0)
        A = np.array([[1.0, 0.1], [0.0, 0.9]])
        B = np.array([[0.0], [0.1]])
        fns = nlp.NLFunctions(
            state_fn=lambda x, u, k: jnp.asarray(A) @ x + jnp.asarray(B) @ u,
            continuous=False,
        )
        rng = np.random.default_rng(0)
        z = jnp.asarray(rng.normal(size=dims.nz))
        x0 = jnp.asarray(rng.normal(size=2))
        ss = jnp.ones(2)
        us = jnp.ones(1)
        c = np.asarray(nlp.state_defects(dims, fns, ss, us, z, x0))
        X, U, _ = nlp.unwrap(dims, z, x0, ss, us)
        X, U = np.asarray(X), np.asarray(U)
        for k in range(3):
            expected = X[k + 1] - (A @ X[k] + B @ U[k])
            assert np.allclose(c[2 * k : 2 * k + 2], expected)

    def test_state_scaling_in_defects(self):
        # values are divided by the state scaling (Constraints.hpp:544-545)
        dims = NLDims(2, 1, 1, 2, 2, 0, 0)
        fns = nlp.NLFunctions(state_fn=vdp_continuous, continuous=True, ts=0.01)
        z = jnp.arange(dims.nz, dtype=jnp.float64)
        x0 = jnp.zeros(2)
        scale = jnp.array([2.0, 4.0])
        c_scaled = nlp.state_defects(dims, fns, scale, jnp.ones(1), z, x0)
        # physical X halves/quarters; compare against manual recomputation
        X, U, _ = nlp.unwrap(dims, z, x0, scale, jnp.ones(1))
        h = 0.005
        c_manual = []
        for k in range(2):
            fk = np.asarray(vdp_continuous(X[k], U[k], k))
            fk1 = np.asarray(vdp_continuous(X[k + 1], U[k], k))
            c_manual.append((np.asarray(X[k]) + h * (fk + fk1) - np.asarray(X[k + 1])) / np.asarray(scale))
        assert np.allclose(np.asarray(c_scaled), np.concatenate(c_manual))


class TestObjective:
    def test_objective_golden_65730(self):
        # (parity: test/NLMPC/test_objective.cpp:56-62)
        dims = NLDims(5, 3, 1, 7, 7, 0, 0)
        fns = nlp.NLFunctions(
            state_fn=lambda x, u, k: x,
            objective_fn=lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2),
        )
        z = jnp.arange(dims.nz, dtype=jnp.float64)
        x0 = jnp.zeros(5)
        val = nlp.objective(dims, fns, jnp.ones(5), jnp.ones(3), z, x0)
        assert float(val) == 65730.0

    def test_gradient_matches_fd(self):
        dims = NLDims(3, 2, 1, 4, 2, 0, 0)
        fns = nlp.NLFunctions(
            state_fn=lambda x, u, k: x,
            objective_fn=lambda X, Y, U, e: jnp.sum(X**4) + jnp.sum(jnp.sin(U)) + e**2,
        )
        rng = np.random.default_rng(1)
        z = jnp.asarray(rng.normal(size=dims.nz))
        x0 = jnp.asarray(rng.normal(size=3))
        f = lambda zz: nlp.objective(dims, fns, jnp.ones(3), jnp.ones(2), zz, x0)
        g = np.asarray(jax.grad(f)(z))
        for i in range(dims.nz):
            eps = 1e-6
            zp = z.at[i].add(eps)
            zm = z.at[i].add(-eps)
            fd = (float(f(zp)) - float(f(zm))) / (2 * eps)
            assert abs(g[i] - fd) < 1e-4


class TestUserConstraints:
    def test_ineq_value_plumbing(self):
        # (parity: test/NLMPC/test_constraints.cpp:144-209)
        dims = NLDims(2, 1, 1, 5, 5, 1, 0)
        fns = nlp.NLFunctions(
            state_fn=vdp_continuous,
            continuous=True,
            ineq_fn=lambda X, Y, U, e: X[0, 0][None],
        )
        z = jnp.arange(dims.nz, dtype=jnp.float64)
        x0 = jnp.array([10.0, 0.0])
        v = nlp.user_ineq(dims, fns, jnp.ones(2), jnp.ones(1), z, x0)
        assert np.allclose(np.asarray(v), [10.0])

    def test_eq_value_plumbing(self):
        # (parity: test/NLMPC/test_constraints.cpp:211-274)
        dims = NLDims(2, 1, 1, 5, 5, 0, 1)
        fns = nlp.NLFunctions(
            state_fn=vdp_continuous,
            continuous=True,
            eq_fn=lambda X, U: X[0, 0][None],
        )
        z = jnp.arange(dims.nz, dtype=jnp.float64)
        x0 = jnp.array([10.0, 0.0])
        v = nlp.user_eq(dims, fns, jnp.ones(2), jnp.ones(1), z, x0)
        assert np.allclose(np.asarray(v), [10.0])

    def test_zero_count_setters_refuse(self):
        # (parity: test/NLMPC/test_constraints.cpp:25-58)
        c = NLMPC(2, 1, 2, 3, 3, 0, 0)
        assert not c.set_ineq_con_function(lambda X, Y, U, e: jnp.zeros(0))
        assert not c.set_eq_con_function(lambda X, U: jnp.zeros(0))


class TestBoundPacking:
    # (parity: test/NLMPC/test_nloptimizer.cpp)
    @pytest.mark.parametrize("nx,nu,ph,ch", MAPPING_SWEEP)
    def test_default_bounds(self, nx, nu, ph, ch):
        c = NLMPC(nx, nu, 1, ph, ch, 0, 0)
        lb, ub = c.get_lower_bound(), c.get_upper_bound()
        assert np.all(lb[: ph * nx + ch * nu] == -inf)
        assert np.all(ub[: ph * nx + ch * nu] == inf)
        # slack pinned by default hard constraints
        assert lb[-1] == 0 and ub[-1] == 0

    @pytest.mark.parametrize("nx,nu,ph,ch", MAPPING_SWEEP)
    def test_set_bounds_offsets(self, nx, nu, ph, ch):
        c = NLMPC(nx, nu, 1, ph, ch, 0, 0)
        assert c.set_state_bounds(np.full(nx, -1.0), np.full(nx, 1.0), HorizonSlice.all())
        assert c.set_input_bounds(np.full(nu, -1.0), np.full(nu, 1.0), HorizonSlice.all())
        lb, ub = c.get_lower_bound(), c.get_upper_bound()
        for i in range(ph):
            assert np.all(lb[i * nx : (i + 1) * nx] == -1.0)
            assert np.all(ub[i * nx : (i + 1) * nx] == 1.0)
        for i in range(ch):
            o = ph * nx + i * nu
            assert np.all(lb[o : o + nu] == -1.0)
            assert np.all(ub[o : o + nu] == 1.0)

    def test_output_bounds_throw(self):
        # (parity: test/NLMPC/test_nlmpc.cpp REQUIRE_THROWS on output bounds)
        c = NLMPC(2, 1, 2, 3, 3, 0, 0)
        with pytest.raises(RuntimeError):
            c.set_output_bounds(np.full(2, -1.0), np.full(2, 1.0))


def make_vdp_controller(max_iter=100):
    """Van der Pol NLMPC (examples/vanderpol_ex.cpp:9-65)."""
    ph, ch = 10, 5
    c = NLMPC(nx=2, nu=1, ny=2, ph=ph, ch=ch, ineq=ph + 1, eq=0)
    c.set_discretization_sampling_time(0.1)
    c.set_optimizer_parameters(NLParameters(maximum_iteration=max_iter))
    c.set_state_space_function(vdp_continuous)
    c.set_objective_function(
        lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2)
    )
    c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
    return c


class TestVanDerPolClosedLoop:
    def test_regulates_to_origin(self):
        # (parity: examples/vanderpol_ex.cpp:67-85 termination criterion)
        c = make_vdp_controller()
        ts = 0.1
        x = np.array([0.0, 1.0])
        cmd = np.zeros(1)
        for step in range(200):
            res = c.optimize(x, cmd)
            cmd = np.asarray(res.cmd)
            # input constraint respected at the applied command
            assert cmd[0] <= 0.5 + 1e-6, (step, cmd)
            dx = np.asarray(vdp_continuous(jnp.asarray(x), jnp.asarray(cmd), 0))
            x = x + dx * ts
            if abs(x[0]) <= 1e-2 and abs(x[1]) <= 1e-1:
                break
        else:
            pytest.fail(f"did not converge, final state {x}")
        assert step < 150

    def test_first_solve_feasible_and_successful(self):
        c = make_vdp_controller()
        res = c.optimize(np.array([0.0, 1.0]), np.zeros(1))
        assert int(res.status) in (int(ResultStatus.SUCCESS), int(ResultStatus.MAX_ITERATION))
        assert bool(res.is_feasible)
        seq = c.get_optimal_sequence()
        # defects satisfied along the horizon: trapezoidal residual small
        X = np.asarray(seq.state)
        U = np.asarray(seq.input)
        for k in range(10):
            fk = np.asarray(vdp_continuous(jnp.asarray(X[k]), jnp.asarray(U[k]), k))
            fk1 = np.asarray(vdp_continuous(jnp.asarray(X[k + 1]), jnp.asarray(U[k]), k))
            resid = X[k] + 0.05 * (fk + fk1) - X[k + 1]
            assert np.abs(resid).max() < 1e-5, (k, resid)

    def test_batched_matches_single(self):
        c = make_vdp_controller()
        x0s = np.array([[0.0, 1.0], [0.5, -0.5], [-0.3, 0.2]])
        u0s = np.zeros((3, 1))
        res = c.optimize(x0s, u0s)
        assert res.cmd.shape == (3, 1)
        for i in range(3):
            ci = make_vdp_controller()
            ri = ci.optimize(x0s[i], u0s[i])
            assert np.allclose(np.asarray(res.cmd[i]), np.asarray(ri.cmd), atol=1e-6)


class TestWarmStartShift:
    def test_shift_semantics(self):
        # states shift left one step (last held); blocked moves likewise
        # (reference: include/mpc/NLMPC/NLOptimizer.hpp:460-507)
        dims = NLDims(2, 1, 1, 3, 2, 0, 0)
        z = jnp.arange(dims.nz, dtype=jnp.float64)  # states [0..5], u [6,7], slack 8
        out = np.asarray(nlp.shift_warm_start(dims, z))
        assert np.allclose(out[:6], [2, 3, 4, 5, 4, 5])
        assert np.allclose(out[6:8], [7, 7])
        assert out[8] == 8


class TestUserEqualityEndToEnd:
    def test_terminal_equality_constraint(self):
        """User eq constraints drive the terminal state to a target through
        the SQP (eq path exercised end-to-end, not just plumbing)."""
        ph, ch = 8, 8
        target = jnp.array([0.5, -0.25])
        c = NLMPC(nx=2, nu=1, ny=2, ph=ph, ch=ch, ineq=0, eq=2)
        # simple double integrator, discrete
        A = jnp.array([[1.0, 0.1], [0.0, 1.0]])
        B = jnp.array([[0.005], [0.1]])
        c.set_state_space_function(lambda x, u, k: A @ x + B @ u)
        c.set_objective_function(lambda X, Y, U, e: jnp.sum(U**2))
        assert c.set_eq_con_function(lambda X, U: X[-1] - target)
        c.set_optimizer_parameters(NLParameters(maximum_iteration=100))
        res = c.optimize(np.zeros(2), np.zeros(1))
        seq = c.get_optimal_sequence()
        assert bool(res.is_feasible), np.asarray(res.status)
        assert np.allclose(np.asarray(seq.state)[-1], np.asarray(target), atol=1e-6)
        # dynamics hold along the horizon
        X = np.asarray(seq.state)
        U = np.asarray(seq.input)
        for k in range(ph):
            assert np.allclose(
                X[k + 1], np.asarray(A) @ X[k] + np.asarray(B) @ U[k], atol=1e-6
            )

    def test_mixed_eq_and_ineq(self):
        """Equality + inequality constraints active together."""
        ph, ch = 6, 6
        c = NLMPC(nx=2, nu=1, ny=2, ph=ph, ch=ch, ineq=ph, eq=1)
        A = jnp.array([[1.0, 0.1], [0.0, 1.0]])
        B = jnp.array([[0.005], [0.1]])
        c.set_state_space_function(lambda x, u, k: A @ x + B @ u)
        c.set_objective_function(lambda X, Y, U, e: jnp.sum(U**2))
        # terminal position target 0.3 (max reachable with u <= 2 is 0.36,
        # so the input cap is genuinely active on the way)
        assert c.set_eq_con_function(lambda X, U: X[-1, 0:1] - 0.3)
        assert c.set_ineq_con_function(lambda X, Y, U, e: U[:ph, 0] - 2.0)
        c.set_optimizer_parameters(NLParameters(maximum_iteration=100))
        res = c.optimize(np.zeros(2), np.zeros(1))
        seq = c.get_optimal_sequence()
        assert bool(res.is_feasible)
        assert abs(np.asarray(seq.state)[-1, 0] - 0.3) < 1e-6
        assert np.asarray(seq.input)[:ph].max() <= 2.0 + 1e-8


NLMPC_SWEEP = [
    # (nx, nu, ny, ph, ch, ineq, eq) mirroring test/NLMPC/test_nlmpc.cpp:11-17
    (1, 1, 1, 1, 1, 0, 0),
    (5, 1, 1, 1, 1, 0, 0),
    (5, 3, 1, 1, 1, 0, 0),
    (5, 3, 1, 7, 1, 0, 0),
    (5, 3, 1, 7, 4, 4, 2),
    (5, 3, 1, 7, 7, 10, 5),
]


@pytest.mark.parametrize("nx,nu,ny,ph,ch,ineq,eq", NLMPC_SWEEP)
class TestNLMPCInterface:
    """Setter contracts across the dimension sweep (test/NLMPC/test_nlmpc.cpp)."""

    def test_setters(self, nx, nu, ny, ph, ch, ineq, eq):
        c = NLMPC(nx, nu, ny, ph, ch, ineq, eq)
        assert c.set_discretization_sampling_time(0.1)
        assert c.set_state_space_function(lambda x, u, k: x)
        assert c.set_output_function(lambda x, u, k: jnp.zeros(ny))
        assert c.set_objective_function(lambda X, Y, U, e: jnp.sum(X**2))
        if ineq > 0:
            assert c.set_ineq_con_function(
                lambda X, Y, U, e: jnp.zeros(ineq)
            )
        else:
            assert not c.set_ineq_con_function(lambda X, Y, U, e: jnp.zeros(0))
        if eq > 0:
            assert c.set_eq_con_function(lambda X, U: jnp.zeros(eq))
        else:
            assert not c.set_eq_con_function(lambda X, U: jnp.zeros(0))
        # bounds: matrix, full-slice, sub-slice forms
        assert c.set_state_bounds(np.full((nx, ph), -1.0), np.full((nx, ph), 1.0))
        assert c.set_input_bounds(np.full((nu, ch), -1.0), np.full((nu, ch), 1.0))
        assert c.set_state_bounds(np.full(nx, -2.0), np.full(nx, 2.0), HorizonSlice.all())
        assert c.set_input_bounds(np.full(nu, -2.0), np.full(nu, 2.0), HorizonSlice.all())
        assert c.set_state_bounds(np.full(nx, -2.0), np.full(nx, 2.0), HorizonSlice(0, 1))
        assert not c.set_state_bounds(
            np.full(nx, -2.0), np.full(nx, 2.0), HorizonSlice(0, ph + 1)
        )
        with pytest.raises(RuntimeError):
            c.set_output_bounds(np.full(ny, -1.0), np.full(ny, 1.0))
        # scaling setters accepted
        c.set_input_scale(np.ones(nu))
        c.set_state_scale(np.ones(nx))


class TestPerInstanceHardBounds:
    def test_batched_input_bounds_bind_per_instance(self):
        """set_instance_bounds gives each instance its own hard input box."""
        ph, ch = 10, 5
        caps = np.array([0.01, 0.05, 0.2])
        B = len(caps)

        def build():
            c = NLMPC(2, 1, 2, ph, ch, 0, 0)
            c.set_discretization_sampling_time(0.1)
            c.set_state_space_function(vdp_continuous)
            c.set_objective_function(lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
            c.set_optimizer_parameters(NLParameters(maximum_iteration=60))
            return c

        c = build()
        umin = np.full((B, ch, 1), -5.0)
        umax = np.stack([np.full((ch, 1), cap) for cap in caps])
        assert c.set_instance_bounds(input=(umin, umax))
        x0 = np.tile(np.array([[0.0, 1.0]]), (B, 1))
        res = c.optimize(x0, np.zeros((B, 1)))
        cmds = np.asarray(res.cmd)[:, 0]
        assert np.all(cmds <= caps + 1e-7)
        # each batched instance matches a per-instance controller with the
        # same shared bounds
        for i, cap in enumerate(caps):
            ci = build()
            ci.set_input_bounds(np.full(1, -5.0), np.full(1, cap), HorizonSlice.all())
            ri = ci.optimize(x0[i], np.zeros(1))
            assert np.allclose(cmds[i], np.asarray(ri.cmd)[0], atol=1e-6), (i, cap)

    def test_clear_instance_bounds(self):
        c = NLMPC(2, 1, 2, 4, 4, 0, 0)
        c.set_state_space_function(lambda x, u, k: x)
        c.set_objective_function(lambda X, Y, U, e: jnp.sum(U**2))
        assert c.set_instance_bounds(input=(np.full((2, 4, 1), -1.0),
                                            np.full((2, 4, 1), 1.0)))
        assert c._instance_bounds is not None
        assert c.set_instance_bounds()
        assert c._instance_bounds is None


class TestHessianModes:
    """The curvature-model knob (extension beyond the reference; the reference's SLSQP
    is itself a damped-BFGS SQP, NLOptimizer.hpp:64).  Every mode must drive
    the same VdP closed loop to the same commands as the exact-Hessian
    default."""

    def _run(self, mode, steps=5):
        c = make_vdp_controller()
        c.set_optimizer_parameters(
            NLParameters(maximum_iteration=100, hessian_reg=mode)
        )
        x = np.array([0.0, 1.0])
        cmd = np.zeros(1)
        cmds = []
        for _ in range(steps):
            res = c.optimize(x, cmd)
            cmd = np.asarray(res.cmd)
            cmds.append(cmd.copy())
            dx = np.asarray(vdp_continuous(jnp.asarray(x), jnp.asarray(cmd), 0))
            x = x + dx * 0.1
        return np.array(cmds), int(res.status)

    @pytest.mark.parametrize("mode", ["gershgorin", "power", "bfgs",
                                      "gauss_newton"])
    def test_closed_loop_matches_exact_hessian(self, mode):
        ref, _ = self._run("eigh")
        got, status = self._run(mode)
        assert status in (
            int(ResultStatus.SUCCESS),
            int(ResultStatus.MAX_ITERATION),
        )
        # modes may terminate at slightly different near-optimal points
        # when the input cap activates; 2e-3 command agreement is the same
        # order as the reference's own FD-vs-exact tolerance (1e-3)
        assert np.allclose(got, ref, atol=2e-3), (mode, got - ref)


class TestLazyStatsMode:
    """set_stats_mode("lazy"): pipelined solves with deferred status
    readback must record the same counts as the default sync mode."""

    def test_counts_and_statuses_match_sync(self):
        def run(mode):
            c = make_vdp_controller()
            c.set_stats_mode(mode)
            x = np.array([0.0, 1.0])
            cmd = np.zeros(1)
            for _ in range(4):
                res = c.optimize(x, cmd)
                cmd = np.asarray(res.cmd)
            return c.get_execution_stats()

        lazy = run("lazy")
        sync = run("sync")
        assert lazy.number_of_solutions == sync.number_of_solutions == 4
        assert sum(lazy.solutions_states.values()) == 4
        assert lazy.solutions_states == sync.solutions_states

    def test_rejects_unknown_mode(self):
        c = make_vdp_controller()
        with pytest.raises(ValueError):
            c.set_stats_mode("bogus")


class TestSQPStragglerCompaction:
    """Batched solves chunk the SQP loop and gather the unconverged tail
    once most instances finish (NLParameters.compact_stragglers).
    Chunking partitions the exact per-instance iteration sequence, so with
    a per-instance inner engine the results are bitwise identical; the
    fused lane-tiled engine's results depend on tile membership (a
    pre-existing property of batch composition) and agree to solver
    tolerance."""

    def _make(self, compact, inner):
        c = NLMPC(2, 1, 2, 10, 5, 11, 0, dtype=jnp.float32)
        c.set_discretization_sampling_time(0.1)
        c.set_optimizer_parameters(NLParameters(
            maximum_iteration=15, enable_warm_start=True,
            inner_qp=inner, hessian_reg="gershgorin",
            compact_stragglers=compact))
        c.set_state_space_function(vdp_continuous)
        c.set_objective_function(
            lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
        c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
        return c

    def _cmds(self, compact, inner, B=128):
        rng = np.random.default_rng(0)
        x0 = np.asarray(rng.uniform(-1, 1, size=(B, 2)), np.float32)
        c = self._make(compact, inner)
        res = c.optimize(x0, np.zeros((B, 1), np.float32))
        res = c.optimize(x0, res.cmd)
        return np.asarray(res.cmd), np.asarray(res.status)

    def test_bitwise_with_per_instance_engine(self):
        on, s_on = self._cmds(True, "admm")
        off, s_off = self._cmds(False, "admm")
        assert np.array_equal(s_on, s_off)
        assert np.array_equal(on, off)

    def test_tolerance_with_fused_engine(self):
        on, s_on = self._cmds(True, "fused")
        off, s_off = self._cmds(False, "fused")
        assert float(np.mean(s_on == 0)) == float(np.mean(s_off == 0)) == 1.0
        assert np.allclose(on, off, atol=2e-3)


class TestFusedEngineSizeGate:
    """An inner_qp="fused" request whose subproblem is wider than the fused
    kernel takes (its matrices live in registers) must degrade gracefully to
    an XLA engine instead of failing to compile."""

    def test_supported_gate_boundaries(self):
        from libmpc_tpu.ops import qp_inner_pallas

        # the production VdP subproblem (nz=26) fits ...
        assert qp_inner_pallas.supported(26, 57)
        # ... the networked-oscillators one (nz=301) cannot
        assert not qp_inner_pallas.supported(301, 553)

    def test_oversized_fused_request_degrades_gracefully(self):
        # ph=20/ch=4 puts nz at 45, past the kernel's padded width of 32:
        # the solve must use the inner-ADMM engine (the f32 oversize
        # fallback) and still succeed
        from libmpc_tpu.ops import qp_inner_pallas

        ph, ch = 20, 4
        nz = ph * 2 + ch * 1 + 1
        assert not qp_inner_pallas.supported(nz, ph * 2 + (ph + 1) + nz)
        c = NLMPC(nx=2, nu=1, ny=2, ph=ph, ch=ch, ineq=ph + 1, eq=0,
                  dtype=jnp.float32)
        c.set_discretization_sampling_time(0.1)
        c.set_optimizer_parameters(
            NLParameters(maximum_iteration=60, inner_qp="fused")
        )
        c.set_state_space_function(vdp_continuous)
        c.set_objective_function(
            lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2)
        )
        c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
        res = c.optimize(np.array([0.0, 1.0], np.float32),
                         np.zeros(1, np.float32))
        assert int(res.status) in (
            int(ResultStatus.SUCCESS), int(ResultStatus.MAX_ITERATION)
        )
        assert bool(res.is_feasible)
        assert np.asarray(res.cmd)[0] <= 0.5 + 1e-4


class TestLargeEqualitySOC:
    """Past the dense second-order-correction size (many equality rows,
    e.g. the networked oscillators at me=240) the correction must route
    through the matrix-free CG solve and the whole SQP still run."""

    def test_large_me_solve_runs_and_converges(self):
        from libmpc_tpu.ops import sqp

        ph, ch = 80, 4
        me = ph * 2
        assert me > sqp._SOC_DENSE_MAX_ROWS
        c = NLMPC(nx=2, nu=1, ny=2, ph=ph, ch=ch, ineq=0, eq=0,
                  dtype=jnp.float32)
        c.set_discretization_sampling_time(0.05)
        c.set_optimizer_parameters(
            NLParameters(maximum_iteration=40, inner_qp="pdip",
                         hessian_reg="gauss_newton")
        )
        c.set_state_space_function(vdp_continuous)
        c.set_objective_function(
            lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2)
        )
        res = c.optimize(np.array([0.2, 0.3], np.float32),
                         np.zeros(1, np.float32))
        assert np.all(np.isfinite(np.asarray(res.cmd)))
        assert int(res.status) in (
            int(ResultStatus.SUCCESS), int(ResultStatus.MAX_ITERATION)
        )
        assert bool(res.is_feasible)
