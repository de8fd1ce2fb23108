"""Mesh / fleet-parallel tests on the virtual 8-device CPU mesh.

The reference has no distributed runtime (SURVEY §2.3); these tests cover the
new scenario-parallel scaling layer: sharded fleet solves must agree exactly with
unsharded batched solves, and fleet stats must aggregate across the mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libmpc_tpu import LMPC, NLMPC, HorizonSlice, LParameters, NLParameters
from libmpc_tpu.parallel import mesh as mesh_lib
from libmpc_tpu.parallel.fleet import LMPCFleet, NLMPCFleet

from test_lmpc import make_quadrotor_controller
from test_nlmpc import make_vdp_controller, vdp_continuous


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "tests expect the 8-device CPU mesh"
    return mesh_lib.make_mesh(data=8)


@pytest.fixture(scope="module")
def mesh4x2():
    return mesh_lib.make_mesh(data=4, model=2)


class TestMesh:
    def test_make_mesh_shapes(self, mesh8, mesh4x2):
        assert mesh8.shape == {"data": 8, "model": 1}
        assert mesh4x2.shape == {"data": 4, "model": 2}

    def test_too_many_devices_raises(self):
        with pytest.raises(ValueError):
            mesh_lib.make_mesh(data=16, model=2)

    def test_shard_batch_places_arrays(self, mesh8):
        x = np.zeros((16, 3))
        sharded = mesh_lib.shard_batch(mesh8, {"x": x})
        assert sharded["x"].sharding.is_equivalent_to(
            mesh_lib.batch_sharding(mesh8), 2
        )


class TestLMPCFleet:
    def test_sharded_matches_unsharded(self, mesh8):
        c = make_quadrotor_controller()
        fleet = LMPCFleet(c, mesh8)
        rng = np.random.default_rng(0)
        B = 16
        x0s = 0.05 * rng.normal(size=(B, 12))
        u0s = np.zeros((B, 4))
        res_fleet, stats = fleet.optimize(x0s, u0s)
        res_plain = c.optimize(x0s, u0s)
        assert np.allclose(
            np.asarray(res_fleet.cmd), np.asarray(res_plain.cmd), atol=1e-8
        )
        assert int(stats.n_total) == B
        assert int(stats.n_success) == B

    def test_batched_references(self, mesh8):
        c = make_quadrotor_controller()
        fleet = LMPCFleet(c, mesh8)
        B = 8
        x0s = np.zeros((B, 12))
        u0s = np.zeros((B, 4))
        # per-instance altitude references
        y_ref = np.zeros((B, 10, 12))
        y_ref[:, :, 2] = np.linspace(0.5, 1.5, B)[:, None]
        res, stats = fleet.optimize(x0s, u0s, y_ref=y_ref)
        # higher altitude reference -> more positive initial climb command
        thrust = np.asarray(res.cmd).sum(axis=1)
        assert np.all(np.diff(thrust) > 0)
        assert int(stats.n_success) == B

    def test_fleet_closed_loop(self, mesh8):
        from test_lmpc import quadrotor_model

        c = make_quadrotor_controller()
        fleet = LMPCFleet(c, mesh8)
        Ad, Bd, _ = quadrotor_model()
        rng = np.random.default_rng(1)
        B = 8
        x = 0.02 * rng.normal(size=(B, 12))
        u = np.zeros((B, 4))
        for _ in range(40):
            res, _ = fleet.optimize(x, u)
            u = np.asarray(res.cmd)
            x = x @ Ad.T + u @ Bd.T
        assert np.all(np.abs(x[:, 2] - 1.0) < 5e-2)

    def test_uneven_batch_raises(self, mesh8):
        c = make_quadrotor_controller()
        fleet = LMPCFleet(c, mesh8)
        with pytest.raises(ValueError):
            fleet.optimize(np.zeros((3, 12)), np.zeros((3, 4)))


class TestNLMPCFleet:
    def test_sharded_matches_unsharded(self, mesh8):
        # pinned to the exact-eigh curvature mode: its per-instance math is
        # stable across batch/shard shapes, so sharded and unsharded solves
        # agree to 1e-8.  The gershgorin default's row-sum reductions can
        # differ by ulps between XLA reduction strategies for different
        # local batch shapes, which the SQP stopping point amplifies (see
        # test_sharded_matches_unsharded_default_mode below).
        c = make_vdp_controller()
        c.set_optimizer_parameters(
            NLParameters(maximum_iteration=100, hessian_reg="eigh")
        )
        fleet = NLMPCFleet(c, mesh8)
        rng = np.random.default_rng(2)
        B = 8
        x0s = rng.uniform(-1, 1, size=(B, 2))
        u0s = np.zeros((B, 1))
        res_fleet, stats = fleet.optimize(x0s, u0s)
        res_plain = c.optimize(x0s, u0s)
        assert np.allclose(
            np.asarray(res_fleet.cmd), np.asarray(res_plain.cmd), atol=1e-8
        )
        assert int(stats.n_total) == B
        assert float(stats.mean_iterations) > 0

    def test_sharded_matches_unsharded_default_mode(self, mesh8):
        # the default (gershgorin) curvature agrees to optimizer-stopping
        # tolerance: both runs converge (status SUCCESS) to near-optimal
        # points whose commands match to ~1e-4, the same order as the
        # reference's own FD-vs-exact agreement
        c = make_vdp_controller()
        fleet = NLMPCFleet(c, mesh8)
        rng = np.random.default_rng(2)
        x0s = rng.uniform(-1, 1, size=(8, 2))
        u0s = np.zeros((8, 1))
        res_fleet, stats = fleet.optimize(x0s, u0s)
        res_plain = c.optimize(x0s, u0s)
        assert int(stats.n_success) == 8
        assert np.allclose(
            np.asarray(res_fleet.cmd), np.asarray(res_plain.cmd), atol=2e-4
        )

    def test_stats_str(self, mesh8):
        c = make_vdp_controller()
        fleet = NLMPCFleet(c, mesh8)
        _, stats = fleet.optimize(np.zeros((8, 2)), np.zeros((8, 1)))
        text = str(stats)
        assert "SUCCESS" in text and "instances: 8" in text

    def test_cold_restart_knob_runs_sharded(self, mesh8):
        """cold_restart_on_failure threads a per-lane warm flag through the
        shard_map step (P(axis) spec): multi-step fleet loop must compile,
        run, and keep succeeding on healthy lanes."""
        c = make_vdp_controller()
        c.set_optimizer_parameters(NLParameters(
            maximum_iteration=100, hessian_reg="eigh",
            enable_warm_start=True, cold_restart_on_failure=True,
        ))
        fleet = NLMPCFleet(c, mesh8)
        rng = np.random.default_rng(4)
        x = rng.uniform(-1, 1, size=(8, 2))
        u = np.zeros((8, 1))
        for _ in range(3):
            res, stats = fleet.optimize(x, u)
            u = np.asarray(res.cmd)
            x = x + 0.1 * rng.normal(size=x.shape) * 0.01
        assert (np.asarray(res.status) == 0).all()


class TestFleetFailureSemantics:
    """A failing fleet instance must hold its previous command, exactly like
    the single-controller path (reference: LOptimizer.hpp:349-361,
    NLOptimizer.hpp:613-624)."""

    def test_lmpc_fleet_holds_last_command(self, mesh8):
        c = make_quadrotor_controller()
        fleet = LMPCFleet(c, mesh8)
        rng = np.random.default_rng(5)
        B = 8
        x = 0.02 * rng.normal(size=(B, 12))
        u = np.zeros((B, 4))
        res, _ = fleet.optimize(x, u)
        good_cmd = np.asarray(res.cmd).copy()
        assert np.all(np.isfinite(good_cmd))
        # instance 3's state estimate fails (NaN) on the next step: the
        # solver cannot produce a valid solution for it
        x_bad = x.copy()
        x_bad[3] = np.nan
        res2, _ = fleet.optimize(x_bad, np.asarray(res.cmd))
        cmd2 = np.asarray(res2.cmd)
        # failed instance held its previous command...
        assert np.allclose(cmd2[3], good_cmd[3], atol=1e-12)
        from libmpc_tpu.types import ResultStatus
        assert int(np.asarray(res2.status)[3]) == int(ResultStatus.ERROR)
        # ...while the healthy instances keep solving normally
        ok = [i for i in range(B) if i != 3]
        assert np.all(np.isfinite(cmd2[ok]))
        assert np.all(np.asarray(res2.status)[ok] == int(ResultStatus.SUCCESS))

    def test_nlmpc_fleet_holds_last_command(self, mesh8):
        c = make_vdp_controller()
        fleet = NLMPCFleet(c, mesh8)
        rng = np.random.default_rng(6)
        B = 8
        x = rng.uniform(-0.5, 0.5, size=(B, 2))
        u = np.zeros((B, 1))
        res, _ = fleet.optimize(x, u)
        good_cmd = np.asarray(res.cmd).copy()
        assert np.all(np.isfinite(good_cmd))
        x_bad = x.copy()
        x_bad[5] = np.nan
        res2, _ = fleet.optimize(x_bad, np.asarray(res.cmd))
        cmd2 = np.asarray(res2.cmd)
        assert np.allclose(cmd2[5], good_cmd[5], atol=1e-12)
        ok = [i for i in range(B) if i != 5]
        assert np.all(np.isfinite(cmd2[ok]))


class TestFleetRuntimeParams:
    def test_nlmpc_fleet_batched_params(self, mesh8):
        """Per-instance runtime params shard over the data axis in fleets."""
        c = make_vdp_controller()

        # per-instance input cap through the runtime-params channel
        def ineq(X, Y, U, e, p):
            return U[:, 0] - p["cap"]

        assert c.set_ineq_con_function(ineq)
        # unconstrained first command is ~0.098 from this state, so the low
        # caps genuinely bind and the high ones do not
        caps = jnp.asarray(np.linspace(0.01, 0.2, 8))
        c.set_runtime_params({"cap": caps}, batched=True)

        fleet = NLMPCFleet(c, mesh8)
        res, stats = fleet.optimize(
            np.tile(np.array([[0.0, 1.0]]), (8, 1)), np.zeros((8, 1))
        )
        cmds = np.asarray(res.cmd)[:, 0]
        # every instance respects its own cap
        assert np.all(cmds <= np.asarray(caps) + 1e-6)
        # the tightest cap binds (command pinned at it), the loosest doesn't
        assert abs(cmds[0] - 0.01) < 1e-6
        assert cmds[-1] < 0.2 - 1e-3
        assert int(stats.n_total) == 8


class TestFleetStatsBuckets:
    def test_unknown_bucket_counted(self, mesh8):
        """Statuses outside the four named buckets (e.g. LMPC time-limit
        stops -> ResultStatus.UNKNOWN, reference LOptimizer.hpp:406-407)
        must land in n_unknown so the buckets always sum to n_total."""
        import jax
        from jax.sharding import PartitionSpec as P
        from libmpc_tpu.parallel import mesh as mesh_lib
        from libmpc_tpu.parallel.fleet import _local_stats
        import jax.numpy as jnp

        status = jnp.asarray([0, 0, 1, 2, 3, 4, 4, 4], jnp.int32)
        iters = jnp.full((8,), 5, jnp.int32)
        axis = mesh_lib.DATA_AXIS
        f = jax.shard_map(
            lambda s, i: _local_stats(s, i, axis),
            mesh=mesh8, in_specs=(P(axis), P(axis)), out_specs=P(),
        )
        stats = f(status, iters)
        assert int(stats.n_unknown) == 3
        total = (int(stats.n_success) + int(stats.n_max_iteration)
                 + int(stats.n_infeasible) + int(stats.n_error)
                 + int(stats.n_unknown))
        assert total == int(stats.n_total) == 8
        assert "UNKNOWN" in str(stats)


class TestFleetCompaction:
    def test_shard_level_compaction_is_invisible(self, mesh8):
        """With 256 instances per shard the in-shard straggler compaction
        engages inside shard_map; results must agree with compaction off
        to rounding (exactly, except for ulp-level adaptive-rho effects of
        the changed reduction shape)."""
        import dataclasses
        B = 2048
        rng = np.random.default_rng(1)
        x0 = 0.02 * rng.normal(size=(B, 12))
        u0 = np.zeros((B, 4))
        cmds = {}
        for compact in (True, False):
            c = make_quadrotor_controller()
            c.set_optimizer_parameters(dataclasses.replace(
                c._params, maximum_iteration=60, enable_warm_start=True,
                compact_stragglers=compact))
            fleet = LMPCFleet(c, mesh8)
            rf, stats = fleet.optimize(x0, u0)
            assert int(stats.n_success) == B
            cmds[compact] = np.asarray(rf.cmd)
        # adaptive rho's masked reduction changes shape (B -> cap) under
        # compaction, so the shared rho can move by an ulp; commands agree
        # to rounding
        assert np.allclose(cmds[True], cmds[False], atol=1e-9)
