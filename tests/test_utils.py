"""Utility-layer tests (parity model: test/test_utils.cpp, test_profiler.cpp,
test_logger.cpp)."""

import io
import math

import jax.numpy as jnp
import numpy as np
import pytest

from libmpc_tpu import discretization, discretization_with_disturbance, rk4
from libmpc_tpu.utils.logger import Logger, LogLevel, LogType
from libmpc_tpu.utils.profiler import Profiler, SolutionStats
from libmpc_tpu.types import Result, ResultStatus


class TestDiscretization:
    def test_scalar_zoh_closed_form(self):
        # dx = a x + b u  ->  Ad = e^{aT}, Bd = (e^{aT}-1) b / a
        # (parity: test/test_utils.cpp:10-62)
        a, b, ts = -0.5, 2.0, 0.1
        Ad, Bd = discretization(np.array([[a]]), np.array([[b]]), ts)
        assert np.allclose(Ad, math.exp(a * ts))
        assert np.allclose(Bd, (math.exp(a * ts) - 1.0) * b / a)

    def test_double_integrator(self):
        A = np.array([[0.0, 1.0], [0.0, 0.0]])
        B = np.array([[0.0], [1.0]])
        ts = 0.2
        Ad, Bd = discretization(A, B, ts)
        assert np.allclose(Ad, [[1.0, ts], [0.0, 1.0]])
        assert np.allclose(Bd, [[0.5 * ts**2], [ts]])

    def test_disturbance_variant(self):
        A = np.array([[0.0, 1.0], [0.0, -1.0]])
        B = np.array([[0.0], [1.0]])
        Be = np.array([[1.0], [0.0]])
        Ad, Bd, Bed = discretization_with_disturbance(A, B, Be, 0.1)
        # consistency with the 2-matrix overload on the stacked input
        Ad2, Bd2 = discretization(A, np.concatenate([B, Be], axis=1), 0.1)
        assert np.allclose(Ad, Ad2)
        assert np.allclose(np.concatenate([Bd, Bed], axis=1), Bd2)

    def test_zero_ts_identity(self):
        A = np.random.default_rng(0).normal(size=(3, 3))
        B = np.random.default_rng(1).normal(size=(3, 2))
        Ad, Bd = discretization(A, B, 0.0)
        assert np.allclose(Ad, np.eye(3))
        assert np.allclose(Bd, 0.0)


class TestRK4:
    def test_exponential_decay(self):
        f = lambda x, u: -x + u
        xf = rk4(f, jnp.array([1.0]), jnp.array([0.0]), 0.01, 100)
        assert np.allclose(xf, math.exp(-1.0), atol=1e-6)

    def test_forced_system(self):
        # dx = u: integrates exactly
        f = lambda x, u: u
        xf = rk4(f, jnp.array([0.0]), jnp.array([2.0]), 0.1, 10)
        assert np.allclose(xf, 2.0)


class TestLogger:
    def test_levels(self):
        # (parity: test/test_logger.cpp semantics)
        log = Logger.instance()
        buf = io.StringIO()
        log.set_stream(buf).set_level(LogLevel.NORMAL)
        log.detail("hidden")
        log.info("shown")
        log.error("also shown")
        out = buf.getvalue()
        assert "hidden" not in out
        assert "shown" in out and "also shown" in out

    def test_prefix(self):
        log = Logger.instance()
        buf = io.StringIO()
        log.set_stream(buf).set_level(LogLevel.DEEP).set_prefix("test")
        log.info("msg")
        assert "[MPC++ test] msg" in buf.getvalue()

    def test_none_silences(self):
        log = Logger.instance()
        buf = io.StringIO()
        log.set_stream(buf).set_level(LogLevel.NONE)
        log.error("x")
        assert buf.getvalue() == ""

    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("MPCXX_LOG_LEVEL_OVERRIDE", "ALERT")
        Logger._reset_for_tests()
        log = Logger.instance()
        # set_level must not override the env setting
        log.set_level(LogLevel.DEEP)
        assert log.level == LogLevel.ALERT


def _mk_result(status=ResultStatus.SUCCESS):
    return Result(
        cmd=jnp.zeros(2),
        cost=jnp.asarray(0.0),
        status=jnp.asarray(int(status), jnp.int32),
        solver_status=jnp.asarray(1, jnp.int32),
        is_feasible=jnp.asarray(True),
    )


class TestProfiler:
    def test_stats_math(self, monkeypatch):
        # deterministic "times" by monkeypatching the clock
        # (parity: test/test_profiler.cpp:100-125 — std of .1/.2/.3s ~ 0.0816)
        prof = Profiler()
        times = iter([0.0, 0.1, 1.0, 1.2, 2.0, 2.3])
        monkeypatch.setattr("time.perf_counter", lambda: next(times))
        for _ in range(3):
            prof.solution_start()
            prof.solution_end(_mk_result())
        s = prof.get_stats()
        assert s.number_of_solutions == 3
        assert np.isclose(s.min_solution_time, 0.1)
        assert np.isclose(s.max_solution_time, 0.3)
        assert np.isclose(s.average_solution_time, 0.2)
        assert np.isclose(s.total_solution_time, 0.6)
        assert abs(s.standard_deviation - 0.0816) < 2e-2
        assert s.solutions_states[ResultStatus.SUCCESS] == 3

    def test_reset(self):
        prof = Profiler()
        prof.solution_start()
        prof.solution_end(_mk_result())
        prof.reset()
        assert prof.get_stats().number_of_solutions == 0

    def test_str_contains_sections(self):
        prof = Profiler()
        prof.solution_start()
        prof.solution_end(_mk_result(ResultStatus.MAX_ITERATION))
        text = str(prof.get_stats())
        assert "Solution stats:" in text
        assert "MAX_ITERATION" in text
        assert "num: 1" in text


class TestProfilerLazyFlush:
    def test_pending_list_stays_bounded(self, monkeypatch):
        """Lazy-mode records pin live device scalars; an unread profiler
        must flush opportunistically instead of growing without bound."""
        from libmpc_tpu.utils import profiler as prof_mod

        monkeypatch.setattr(prof_mod, "_PENDING_FLUSH", 4)
        prof = Profiler()
        for _ in range(10):
            prof.solution_start()
            prof.solution_end(_mk_result(), lazy=True)
        assert len(prof._pending) < 4
        s = prof.get_stats()
        assert s.number_of_solutions == 10
        assert s.solutions_states[ResultStatus.SUCCESS] == 10


class TestRooflineModels:
    """FLOP/bytes models (libmpc_tpu/utils/flops.py): structural sanity —
    positive and monotone in problem size and iterations."""

    def test_flop_models_positive_and_monotone(self):
        from libmpc_tpu.utils import flops as fl

        a = fl.admm_solve_flops(216, 535, 20.0, 10)
        b = fl.admm_solve_flops(216, 535, 40.0, 10)
        assert 0 < a < b
        s1 = fl.sqp_iter_flops(20, 10, 12, 6, 126)
        s2 = fl.sqp_iter_flops(20, 10, 12, 6, 126, ipm_iters=40.0)
        assert 0 < s1 < s2

    def test_bytes_models(self):
        from libmpc_tpu.utils import flops as fl

        n, m = 216, 535
        # the refinement pass adds traffic to every iteration
        assert fl.admm_xla_iter_bytes(n, m, x_refine=False) < \
            fl.admm_xla_iter_bytes(n, m)
        # solve-level bytes grow with the iteration count
        b20 = fl.admm_solve_bytes(n, m, 20.0, 10)
        b40 = fl.admm_solve_bytes(n, m, 40.0, 10)
        assert 0 < b20 < b40
        assert fl.admm_check_bytes(n, m) > 0


class TestCompileCachePlacement:
    """utils/compile_cache.use_compile_cache: the env var's directory when
    it is set (and no other), else a fixed directory in the checkout."""

    @pytest.fixture(autouse=True)
    def _restore_config(self):
        import jax

        keep = (jax.config.jax_compilation_cache_dir,
                jax.config.jax_persistent_cache_min_compile_time_secs)
        yield
        jax.config.update("jax_compilation_cache_dir", keep[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          keep[1])

    def test_env_var_set(self, monkeypatch, tmp_path):
        import jax

        from libmpc_tpu.utils import compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        got = compile_cache.use_compile_cache(str(tmp_path / "repo"))
        assert got == str(tmp_path / "c")
        # JAX reads the variable itself: no other directory is configured
        assert jax.config.jax_compilation_cache_dir == before

    def test_env_var_unset(self, monkeypatch, tmp_path):
        import jax

        from libmpc_tpu.utils import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = compile_cache.use_compile_cache(str(tmp_path))
        assert got == str(tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
