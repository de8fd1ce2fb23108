"""Batch-wide float32 accuracy of the production LMPC path vs an f64 oracle.

The bench's accuracy gate (`bench.py::_golden_check`) covers ONE instance —
the zero-state golden from test/LMPC/test_common.cpp:230-236.  Tuning the
polish knobs (`polish_active_cap`, `polish_comp_passes`) on that number
alone could silently degrade instances with larger active sets, which the
golden never exercises.  This harness measures the error of EVERY instance
in the bench batch:

  1. ``--ref`` mode (run on CPU, float64): solves the bench's randomized
     quadrotor batch — one cold step, one warm steady-state step — with a
     tight-tolerance f64 configuration and saves both command matrices.
  2. default mode (run on the production backend, float32): re-solves the
     same batch for each candidate configuration and prints the max/mean
     absolute command error vs the saved f64 oracle.

Usage:
  LIBMPC_PLATFORM=cpu JAX_ENABLE_X64=1 python misc/batch_accuracy.py --ref
  python misc/batch_accuracy.py            # on the GPU
"""

from __future__ import annotations

import os
import sys

if os.environ.get("LIBMPC_PLATFORM"):
    import jax as _jax

    _jax.config.update("jax_platforms", os.environ["LIBMPC_PLATFORM"])

import functools

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B = int(os.environ.get("LIBMPC_ACC_BATCH", "2048"))
REF_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "results",
    f"quadrotor_cmds_f64_B{B}.npz",
)


def _two_steps(params, dtype):
    """cmd after a cold solve and after one warm steady-state re-solve."""
    from __graft_entry__ import _quadrotor_setup
    from libmpc_tpu.lmpc.controller import build_prepared, solve_body

    c = _quadrotor_setup(dtype)
    c.set_optimizer_parameters(params)
    dims, prob = c.dims, c._prob
    built = build_prepared(dims, params, prob,
                           c._y_ref, c._u_ref, c._du_ref, c._u_meas)

    @functools.partial(jax.jit, static_argnames=())
    def step(x0, u0, warm_x, warm_y, have_warm):
        result, seq, sol_x, sol_y, iters = solve_body(
            dims, params, prob, x0, u0,
            c._y_ref, c._u_ref, c._du_ref, c._u_meas,
            warm_x, warm_y, have_warm, jnp.zeros_like(u0), built=built,
        )
        return result.cmd, sol_x, sol_y

    rng = np.random.default_rng(0)  # same seed/distribution as bench.py
    # (the first B rows of its batch; bench.py runs B=16384, this harness
    # defaults to B=2048 via LIBMPC_ACC_BATCH)
    x0 = jnp.asarray(0.05 * rng.normal(size=(B, 12)), dtype)
    u = jnp.zeros((B, 4), dtype)
    wx = jnp.zeros((B, dims.nz), dtype)
    wy = jnp.zeros((B, dims.m), dtype)
    cmd_cold, wx, wy = step(x0, u, wx, wy, jnp.asarray(False))
    cmd_warm, wx, wy = step(x0, cmd_cold, wx, wy, jnp.asarray(True))
    return np.asarray(cmd_cold), np.asarray(cmd_warm)


def make_reference():
    assert jnp.zeros(()).dtype == jnp.float64, "run with JAX_ENABLE_X64=1"
    from libmpc_tpu import LParameters

    # tight f64 oracle: plenty of iterations, 1e-9 tolerances, dense
    # (per-instance, OSQP-like) polish — accuracy-reference settings, not
    # production ones
    params = LParameters(maximum_iteration=4000, enable_warm_start=True,
                         eps_abs=1e-9, eps_rel=1e-9, rho=0.1,
                         polish=True, polish_mode="dense")
    cold, warm = _two_steps(params, jnp.float64)
    os.makedirs(os.path.dirname(REF_PATH), exist_ok=True)
    np.savez(REF_PATH, cold=cold, warm=warm)
    print(f"saved f64 oracle commands for B={B} -> {REF_PATH}")


def compare():
    from libmpc_tpu import LParameters

    ref = np.load(REF_PATH)
    base = dict(maximum_iteration=100, enable_warm_start=True, polish=True,
                polish_mode="shared", rho=0.01, check_termination=10)
    candidates = {
        "cap=40 passes=8 (r2 bench)": LParameters(**base),
        "cap=24 passes=8": LParameters(**base, polish_active_cap=24),
        "cap=24 passes=4": LParameters(**base, polish_active_cap=24,
                                       polish_comp_passes=4),
        "cap=32 passes=4": LParameters(**base, polish_active_cap=32,
                                       polish_comp_passes=4),
        "cap=40 passes=4": LParameters(**base, polish_comp_passes=4),
    }
    print(f"device={jax.devices()[0]} B={B}", flush=True)
    for name, params in candidates.items():
        cold, warm = _two_steps(params, jnp.float32)
        ec = np.abs(cold - ref["cold"])
        ew = np.abs(warm - ref["warm"])
        print(f"{name:28s} cold max={ec.max():.2e} mean={ec.mean():.2e}  "
              f"warm max={ew.max():.2e} mean={ew.mean():.2e}", flush=True)


if __name__ == "__main__":
    if "--ref" in sys.argv:
        make_reference()
    else:
        compare()
