"""Dual-precision test matrix.

The reference compiles every test twice — static template dims and dynamic
runtime dims (test/CMakeLists.txt:56-65).  Under XLA both collapse to
"shapes are static per compile", so the meaningful second mode here is
*precision*: the parity suite runs in float64 (the reference's domain), and
this file re-runs the key goldens in float32 — the production dtype on the GPU —
at the accuracy that precision supports.

The float32 accuracy bound is set by the conditioning of the rounded problem
data (kappa * eps_f32), roughly 1e-4..1e-3 for the reference examples.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from libmpc_tpu import LMPC, NLMPC, HorizonSlice, LParameters, NLParameters, inf

from test_lmpc import quadrotor_model
from test_nlmpc import vdp_continuous


class TestFloat32LMPC:
    def test_quadrotor_golden_f32(self):
        Tnx, Tnu, Tndu, Tny, Tph, Tch = 12, 4, 4, 12, 10, 10
        c = LMPC(Tnx, Tnu, Tndu, Tny, Tph, Tch, dtype=jnp.float32)
        Ad, Bd, Cd = quadrotor_model()
        c.set_state_space_model(Ad, Bd, Cd)
        c.set_objective_weights(
            np.array([0, 0, 10, 10, 10, 10, 0, 0, 0, 5, 5, 5], float),
            np.full(4, 0.1), np.zeros(4), HorizonSlice(0, Tph),
        )
        xmin = np.array([-np.pi / 6, -np.pi / 6, -inf, -inf, -inf, -1,
                         -inf, -inf, -inf, -inf, -inf, -inf])
        xmax = np.array([np.pi / 6, np.pi / 6] + [inf] * 10)
        u0 = 10.5916
        c.set_state_bounds(xmin, xmax, HorizonSlice(0, Tph))
        c.set_input_bounds(np.full(4, 9.6 - u0), np.full(4, 13.0 - u0),
                           HorizonSlice(0, Tch))
        y_ref = np.zeros(12)
        y_ref[2] = 1.0
        c.set_references(y_ref, np.zeros(4), np.zeros(4), HorizonSlice(0, Tph))
        c.set_optimizer_parameters(
            LParameters(maximum_iteration=2000, eps_abs=1e-5, eps_rel=1e-5,
                        rho=0.01, adaptive_rho=False, polish=False)
        )
        res = c.optimize(np.zeros(12, np.float32), np.zeros(4, np.float32))
        golden = np.array([-0.9916, 1.74839, -0.9916, 1.74839])
        assert res.cmd.dtype == jnp.float32
        assert np.allclose(np.asarray(res.cmd), golden, atol=5e-4), np.asarray(res.cmd)
        assert bool(res.is_feasible)


class TestFloat32NLMPC:
    def test_vdp_first_solve_f32(self):
        ph, ch = 10, 5
        c = NLMPC(2, 1, 2, ph, ch, ph + 1, 0, dtype=jnp.float32)
        c.set_discretization_sampling_time(0.1)
        c.set_optimizer_parameters(NLParameters(maximum_iteration=50))
        c.set_state_space_function(vdp_continuous)
        c.set_objective_function(lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
        c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
        res = c.optimize(np.array([0.0, 1.0], np.float32), np.zeros(1, np.float32))
        assert res.cmd.dtype == jnp.float32
        assert int(res.status) in (0, 1)  # SUCCESS / MAX_ITERATION
        # command agrees with the float64 solve to f32-appropriate tolerance
        c64 = NLMPC(2, 1, 2, ph, ch, ph + 1, 0, dtype=jnp.float64)
        c64.set_discretization_sampling_time(0.1)
        c64.set_optimizer_parameters(NLParameters(maximum_iteration=50))
        c64.set_state_space_function(vdp_continuous)
        c64.set_objective_function(lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
        c64.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
        res64 = c64.optimize(np.array([0.0, 1.0]), np.zeros(1))
        assert np.allclose(
            np.asarray(res.cmd), np.asarray(res64.cmd), atol=2e-3
        ), (np.asarray(res.cmd), np.asarray(res64.cmd))

    def test_vdp_batched_f32(self):
        ph, ch = 10, 5
        c = NLMPC(2, 1, 2, ph, ch, ph + 1, 0, dtype=jnp.float32)
        c.set_discretization_sampling_time(0.1)
        c.set_optimizer_parameters(NLParameters(maximum_iteration=40))
        c.set_state_space_function(vdp_continuous)
        c.set_objective_function(lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
        c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
        rng = np.random.default_rng(0)
        B = 16
        x0 = np.asarray(rng.uniform(-1, 1, size=(B, 2)), np.float32)
        res = c.optimize(x0, np.zeros((B, 1), np.float32))
        assert np.all(np.asarray(res.status) == 0)
        assert np.asarray(res.cmd).max() <= 0.5 + 1e-5
