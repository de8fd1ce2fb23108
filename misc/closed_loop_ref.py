"""Float64 oracles for the plant-coupled closed-loop benchmarks.

Generates, on CPU in double precision with accuracy-reference solver
settings, the closed-loop input trajectories that ``bench.py``'s
``closed_loop_cmd_max_err_vs_f64`` / ``nlmpc_closed_loop_cmd_max_err_vs_f64``
fields compare against.  The benchmark inputs are deterministic
(``bench._closed_loop_inputs`` / ``bench._vdp_closed_loop_inputs`` with fixed
seeds), so the oracles are computed once and committed.

Usage:
  LIBMPC_PLATFORM=cpu JAX_ENABLE_X64=1 python misc/closed_loop_ref.py
"""

from __future__ import annotations

import os
import sys

if os.environ.get("LIBMPC_PLATFORM"):
    import jax as _jax

    _jax.config.update("jax_platforms", os.environ["LIBMPC_PLATFORM"])

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")

# oracle sub-batch: first B0 instances / first K0 steps of the bench inputs.
# B0=1024 gives ~15k warm instance-steps, enough to resolve a ~1%-of-steps
# straggler tail (the round-3 oracle's 64 x 15 = 960 samples could not);
# override via env for quick regenerations.
B0 = int(os.environ.get("LIBMPC_ORACLE_B", 1024))
K0 = int(os.environ.get("LIBMPC_ORACLE_K", 16))


def lmpc_oracle():
    from __graft_entry__ import _quadrotor_model, _quadrotor_setup
    from bench import _closed_loop_inputs
    from libmpc_tpu import LParameters
    from libmpc_tpu.rollout import lmpc_rollout

    dtype = jnp.float64
    c = _quadrotor_setup(dtype)
    # accuracy-reference settings: tight tolerances, dense per-instance
    # polish, plenty of iterations — NOT the production configuration
    c.set_optimizer_parameters(LParameters(
        maximum_iteration=4000, enable_warm_start=True, warm_start_shift=True,
        eps_abs=1e-9, eps_rel=1e-9, rho=0.1,
        polish=True, polish_mode="dense",
    ))
    Ad, Bd = _quadrotor_model()
    Adj, Bdj = jnp.asarray(Ad, dtype), jnp.asarray(Bd, dtype)
    x0_h, noise_h = _closed_loop_inputs(B0, K0)
    noise = jnp.asarray(noise_h, dtype)

    def plant(x, u, k):
        return x @ Adj.T + u @ Bdj.T + noise[k]

    r = lmpc_rollout(c, plant, jnp.asarray(x0_h, dtype),
                     jnp.zeros((B0, 4), dtype), K0)
    sts = np.asarray(r.statuses)
    assert (sts == 0).all(), f"oracle not fully solved: {np.bincount(sts.ravel())}"
    path = os.path.join(RESULTS, "closed_loop_ref_f64.npz")
    np.savez(path, inputs=np.asarray(r.inputs), states=np.asarray(r.states),
             iterations=np.asarray(r.iterations), B=B0, K=K0)
    print(f"saved LMPC closed-loop f64 oracle (B={B0}, K={K0}) -> {path}")


def nlmpc_oracle():
    from bench import _make_vdp, _vdp_closed_loop_inputs
    from libmpc_tpu import NLParameters
    from libmpc_tpu.rollout import nlmpc_rollout

    dtype = jnp.float64
    # accuracy-reference engine: exact-eigh curvature + interior-point QP
    params = NLParameters(maximum_iteration=100, enable_warm_start=True,
                          inner_qp="pdip", hessian_reg="eigh")
    c, vdp = _make_vdp(dtype, params)
    x0_h, noise_h = _vdp_closed_loop_inputs(B0, K0)
    noise = jnp.asarray(noise_h, dtype)
    ts = 0.1

    def plant(x, u, k):
        return x + ts * jax.vmap(vdp, in_axes=(0, 0, None))(x, u, k) + noise[k]

    r = nlmpc_rollout(c, plant, jnp.asarray(x0_h, dtype),
                      jnp.zeros((B0, 1), dtype), K0)
    sts = np.asarray(r.statuses)
    ok = (sts == 0).mean()
    assert ok == 1.0, f"oracle success fraction {ok}"
    path = os.path.join(RESULTS, "vdp_closed_loop_ref_f64.npz")
    np.savez(path, inputs=np.asarray(r.inputs), states=np.asarray(r.states),
             iterations=np.asarray(r.iterations), B=B0, K=K0)
    print(f"saved NLMPC closed-loop f64 oracle (B={B0}, K={K0}) -> {path}")


def ugv_oracle():
    """UGV closed loop (bench._make_ugv configuration) in f64 with the
    accuracy-reference pdip engine; B0 instances are the first rows of the
    bench's seed-21 start distribution (first-rows rng slices coincide
    across batch sizes)."""
    import dataclasses as dc

    from bench import _make_ugv
    from libmpc_tpu.rollout import nlmpc_rollout

    B_ugv = int(os.environ.get("LIBMPC_UGV_ORACLE_B", 256))
    K_ugv = int(os.environ.get("LIBMPC_UGV_ORACLE_K", 150))
    dtype = jnp.float64
    c, plant, params_fn, x0, obstacles, radii, yref = _make_ugv(dtype, B_ugv)
    # accuracy-reference engine: f64 interior-point inner QP (1e-10 KKT).
    # gauss_newton (not eigh) curvature: the converged iterates satisfy the
    # same first-order KKT conditions either way, and the per-iteration
    # (61,61) Lagrangian Hessian + eigh of the eigh mode made the 150-step
    # B=256 CPU rollout impractically slow (>4 CPU-hours, measured)
    c.set_optimizer_parameters(dc.replace(
        c._params, inner_qp="pdip", hessian_reg="gauss_newton",
        maximum_iteration=300))
    r = nlmpc_rollout(c, plant, x0, jnp.zeros((B_ugv, 2), dtype), K_ugv,
                      params_fn=params_fn)
    inputs, states = np.asarray(r.inputs), np.asarray(r.states)
    sts, iters = np.asarray(r.statuses), np.asarray(r.iterations)
    ok = (sts == 0).mean()
    # the nonconvex obstacle rows leave a handful of solves at
    # MAX_ITERATION even in f64; statuses are stored so the bench masks
    # those steps out of the accuracy comparison
    assert ok > 0.95, f"oracle success fraction {ok}"
    path = os.path.join(RESULTS, "ugv_closed_loop_ref_f64.npz")
    np.savez(path, inputs=inputs, states=states, iterations=iters,
             statuses=sts, B=B_ugv, K=K_ugv)
    print(f"saved UGV closed-loop f64 oracle (B={B_ugv}, K={K_ugv}, "
          f"success={ok:.4f}) -> {path}")


if __name__ == "__main__":
    assert jnp.zeros(()).dtype == jnp.float64, "run with JAX_ENABLE_X64=1"
    os.makedirs(RESULTS, exist_ok=True)
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "lmpc"):
        lmpc_oracle()
    if which in ("all", "vdp"):
        nlmpc_oracle()
    if which in ("all", "ugv"):
        ugv_oracle()
