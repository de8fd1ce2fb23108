"""Smoke run of both MPC solve paths on an NVIDIA GPU.

Drives the public package surface at production width and checks the
answers against the repo's float64 oracles:

  P0  device, versions and compile cache
  P1  quadrotor LMPC, B=16384: one cold and two warm ``LMPC.optimize`` steps
  P2  quadrotor LMPC closed loop (``lmpc_rollout``), B=16384, K=16
  P3  Van der Pol NLMPC, B=4096: ``NLMPC.optimize`` and ``nlmpc_rollout``
  P4  networked oscillators (nz=301), B=256, K=8, banded engine with rescue
  P5  UGV obstacle loop, B=256, 150 steps, one ``nlmpc_rollout``
  P6  the fused inner-QP kernel against its plain XLA reference

``--four`` runs only the sharded paths on four GPUs (fleets over a
``data=4`` mesh and the row-sharded QP over ``model=4``), each against the
same instances solved on one card.

Usage:
  python chip_smoke.py
  python chip_smoke.py --four

Each phase prints one JSON line with its values, gates and the card's name
and power limit; the first failed gate exits 1.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = (-0.9916, 1.74839, -0.9916, 1.74839)  # test/LMPC/test_common.cpp


def card_info() -> str:
    """The card's name and power limit from nvidia-smi (a child process
    that does not import JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return out.stdout.strip() or f"nvidia-smi rc {out.returncode}"


class Phase:
    """Values and gates of one phase, printed as one JSON line."""

    def __init__(self, name: str, card: str):
        self.name = name
        self.card = card
        self.values: dict = {}
        self.gates: dict = {}

    def value(self, **kw):
        self.values.update(kw)

    def gate(self, name: str, value: float, limit: float, kind: str = "<="):
        """Record a gate: ``value <= limit`` or ``value >= limit``."""
        value = float(value)
        ok = value <= limit if kind == "<=" else value >= limit
        self.gates[name] = {"value": value, kind: limit, "pass": bool(ok)}

    def finish(self) -> None:
        import jax

        stats = [d.memory_stats() for d in jax.local_devices()]
        self.values["peak_bytes_in_use"] = [
            s["peak_bytes_in_use"] if s else None for s in stats
        ]
        print(json.dumps({"phase": self.name, "values": self.values,
                          "gates": self.gates, "card": self.card}),
              flush=True)
        failed = [k for k, g in self.gates.items() if not g["pass"]]
        if failed:
            sys.exit(f"chip_smoke: {self.name} failed gates {failed}")


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def _oracle(name: str):
    import numpy as np

    return np.load(os.path.join(REPO, "misc", "results", name))


def phase_lmpc(card: str, B: int = 16384) -> None:
    """P1: batched quadrotor LMPC through ``LMPC.optimize``, production
    parameters (bench.headline_params).  The last instance starts at the
    zero state and is held to the double-precision golden; the first rows
    are the states misc/batch_accuracy.py solved in float64."""
    import jax.numpy as jnp
    import numpy as np

    import bench
    from __graft_entry__ import _quadrotor_setup

    ph = Phase("P1_lmpc_quadrotor", card)
    c = _quadrotor_setup(jnp.float32)
    c.set_optimizer_parameters(bench.headline_params())
    x0 = 0.05 * np.random.default_rng(0).normal(size=(B, 12))
    x0[-1] = 0.0
    u0 = np.zeros((B, 4))
    cold, t_cold = _timed(lambda: c.optimize(x0, u0))
    warm1, t_w1 = _timed(lambda: c.optimize(x0, cold.cmd))
    warm2, t_w2 = _timed(lambda: c.optimize(x0, warm1.cmd))
    ph.value(batch=B, cold_step_s_with_compile=t_cold, warm_step_s=[t_w1, t_w2],
             success_frac=float(np.mean(np.asarray(warm2.status) == 0)))
    golden = np.asarray(GOLDEN)
    ph.gate("golden_err_cold", np.abs(np.asarray(cold.cmd)[-1] - golden).max(),
            1e-4)
    ph.gate("golden_err_warm", np.abs(np.asarray(warm2.cmd)[-1] - golden).max(),
            1e-4)
    # oracle lanes: the rows it covers, minus the zero-state row
    ref = _oracle("quadrotor_cmds_f64_B2048.npz")
    n = min(B - 1, ref["cold"].shape[0])
    for tag, res in (("cold", cold), ("warm", warm1)):
        err = np.abs(np.asarray(res.cmd)[:n] - ref[tag][:n]).max(axis=-1)
        ph.value(**{f"oracle_{tag}_err_mean": float(err.mean()),
                    f"oracle_{tag}_lanes": n})
        # float32 ADMM + shared polish vs a 1e-9-tolerance float64 solve
        # (the CPU rehearsal's float32 maximum over these lanes: 9.0e-4)
        ph.gate(f"oracle_{tag}_err_max", err.max(), 2e-3)
    ph.finish()


def phase_lmpc_closed_loop(card: str, B: int = 16384, K: int = 16,
                           oracle_lanes: int = 1024) -> None:
    """P2: the plant-coupled LMPC closed loop on device, and the
    matched-state shadow rollout along the float64 oracle's trajectory
    (every step then solves the oracle's own problem)."""
    import jax.numpy as jnp
    import numpy as np

    import bench
    from __graft_entry__ import _quadrotor_model, _quadrotor_setup
    from libmpc_tpu.rollout import lmpc_rollout

    ph = Phase("P2_lmpc_closed_loop", card)
    dtype = jnp.float32
    Ad, Bd = (jnp.asarray(a, dtype) for a in _quadrotor_model())
    x0, noise = bench._closed_loop_inputs(B, K)
    noise = jnp.asarray(noise, dtype)

    def plant(x, u, k):
        return x @ Ad.T + u @ Bd.T + noise[k]

    c = _quadrotor_setup(dtype)
    c.set_optimizer_parameters(bench._closed_loop_params())
    u0 = jnp.zeros((B, 4), dtype)
    r, t_first = _timed(lambda: lmpc_rollout(c, plant, x0, u0, K))
    r, t_run = _timed(lambda: lmpc_rollout(c, plant, x0, u0, K))
    iters = np.asarray(r.iterations)
    ph.value(batch=B, steps=K, first_run_s_with_compile=t_first, run_s=t_run,
             solves_per_s=B * K / t_run, iters_mean_warm=float(iters[:, 1:].mean()))
    ph.gate("finite_inputs", float(np.isfinite(np.asarray(r.inputs)).all()),
            1.0, ">=")
    # OSQP_SOLVED and OSQP_SOLVED_INACCURATE both map to SUCCESS
    ph.gate("success_frac", np.mean(np.asarray(r.statuses) == 0), 0.99, ">=")

    ref = _oracle("closed_loop_ref_f64.npz")
    n = min(oracle_lanes, int(ref["B"]))
    K0 = min(K, int(ref["K"]))
    ostates = jnp.asarray(ref["states"][:n], dtype)

    def plant_shadow(x, u, k):
        return ostates[:, k + 1]

    cs = _quadrotor_setup(dtype)
    cs.set_optimizer_parameters(bench._closed_loop_params())
    rs = lmpc_rollout(cs, plant_shadow, ostates[:, 0],
                      jnp.zeros((n, 4), dtype), K0)
    errm = np.abs(np.asarray(rs.inputs) - ref["inputs"][:n, :K0]).max(axis=-1)
    ph.value(oracle_lanes=n, matched_err_warm_mean=float(errm[:, 1:].mean()),
             matched_err_warm_p99=float(np.quantile(errm[:, 1:], 0.99)),
             matched_err_cold_mean=float(errm[:, 0].mean()))
    ph.gate("matched_err_warm_max", errm[:, 1:].max(), 1e-3)
    ph.gate("matched_err_cold_max", errm[:, 0].max(), 1e-2)
    ph.finish()


def phase_vdp(card: str, B: int = 4096, K: int = 16,
              oracle_lanes: int = 1024, reps: int = 4) -> None:
    """P3: Van der Pol NLMPC through ``NLMPC.optimize`` with the default
    engine (the fused kernel on a GPU), timed warm against the XLA engines
    (plain, kernel, kernel, plain), then the closed loop and its
    matched-state comparison with the float64 oracle."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from libmpc_tpu.ops import sqp
    from libmpc_tpu.rollout import nlmpc_rollout

    ph = Phase("P3_vdp_nlmpc", card)
    dtype = jnp.float32
    params = bench.vdp_params()
    x0 = np.asarray(np.random.default_rng(0).uniform(-1, 1, size=(B, 2)),
                    np.float32)
    u0 = np.zeros((B, 1), np.float32)
    c, vdp = bench._make_vdp(dtype, params)
    d = c.dims
    engine = sqp.inner_engine(params, dtype, d.nz, d.ph * d.nx + d.eq,
                              d.ineq, c._get_traj_plan())
    res, t_cold = _timed(lambda: c.optimize(x0, u0))
    res, _ = _timed(lambda: c.optimize(x0, res.cmd))
    ph.value(batch=B, engine=engine, cold_solve_s_with_compile=t_cold)
    ph.gate("success_frac", np.mean(np.asarray(res.status) == 0), 0.99, ">=")

    # the same warm re-solve on each engine, alternating plain, default,
    # default, plain ("riccati" is what the fused request ran before the
    # kernel compiled for the GPU)
    ctrl = {engine: (c, res)}
    for alt in ("riccati", "pdip", "admm"):
        ca, _ = bench._make_vdp(dtype, dataclasses.replace(params, inner_qp=alt))
        ra = ca.optimize(x0, u0)
        ctrl[alt] = (ca, ca.optimize(x0, ra.cmd))
        jax.block_until_ready(ctrl[alt][1].cmd)
    times = {k: [] for k in ctrl}
    order = [k for alt in ctrl if alt != engine for k in (alt, engine, engine, alt)]
    for _ in range(reps):
        for k in order:
            cc, rr = ctrl[k]
            _, dt = _timed(lambda: cc.optimize(x0, rr.cmd))
            times[k].append(dt)
    ph.value(warm_solve_s_median={k: float(np.median(v)) for k, v in times.items()},
             warm_solves_per_s={k: B / float(np.median(v)) for k, v in times.items()})

    xc, noise = bench._vdp_closed_loop_inputs(B, K)
    noise = jnp.asarray(noise, dtype)

    def plant(x, u, k):
        return x + 0.1 * jax.vmap(vdp, in_axes=(0, 0, None))(x, u, k) + noise[k]

    r, t_roll = _timed(lambda: nlmpc_rollout(c, plant, jnp.asarray(xc, dtype),
                                             jnp.zeros((B, 1), dtype), K))
    ph.value(closed_loop_steps=K, closed_loop_s_with_compile=t_roll,
             closed_loop_iters_mean=float(np.asarray(r.iterations).mean()))
    ph.gate("closed_loop_success_frac", np.mean(np.asarray(r.statuses) == 0),
            0.99, ">=")

    ref = _oracle("vdp_closed_loop_ref_f64.npz")
    n = min(oracle_lanes, int(ref["B"]))
    K0 = min(K, int(ref["K"]))
    ostates = jnp.asarray(ref["states"][:n], dtype)
    cs, _ = bench._make_vdp(dtype, params)
    rs = nlmpc_rollout(cs, lambda x, u, k: ostates[:, k + 1], ostates[:, 0],
                       jnp.zeros((n, 1), dtype), K0)
    errm = np.abs(np.asarray(rs.inputs) - ref["inputs"][:n, :K0]).max(axis=-1)
    ph.value(oracle_lanes=n, matched_err_warm_mean=float(errm[:, 1:].mean()),
             matched_err_warm_max=float(errm[:, 1:].max()))
    # float32 SQP (inner tolerance 5e-6) vs float64 eigh + interior point
    ph.gate("matched_err_warm_p99", np.quantile(errm[:, 1:], 0.99), 5e-3)
    ph.finish()


def phase_oscillators(card: str, B: int = 256, K: int = 8,
                      n_ref: int = 16) -> None:
    """P4: networked oscillators (nz=301) closed loop with the banded
    engine and rescue (bench._osc_controller); the first step's float32
    commands of ``n_ref`` lanes against a float64 dense-``pdip`` solve from
    the same states."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench

    ph = Phase("P4_oscillators", card)
    t0 = time.perf_counter()
    rate, r = bench._osc_run(B, K)
    ph.value(batch=B, steps=K, solves_per_s=rate,
             total_s_with_compile=time.perf_counter() - t0,
             iters_mean=float(np.asarray(r.iterations).mean()))
    ph.gate("success_frac", np.mean(np.asarray(r.statuses) == 0), 0.99, ">=")

    n = min(n_ref, B)
    x0 = np.asarray(r.states)[:n, 0]
    with jax.enable_x64(True):
        c64, *_ = bench._osc_controller(jnp.float64)
        c64.set_optimizer_parameters(dataclasses.replace(
            c64._params, inner_qp="pdip", rescue_iters=0))
        ref = c64.optimize(x0.astype(np.float64), np.zeros((n, 6)))
        ref_cmd = np.asarray(ref.cmd)
        ref_ok = np.asarray(ref.status) == 0
    err = np.abs(np.asarray(r.inputs)[:n, 0] - ref_cmd).max(axis=-1)[ref_ok]
    ph.value(f64_ref_lanes=n, f64_ref_success=int(ref_ok.sum()),
             cmd_err_vs_f64_mean=float(err.mean()) if err.size else None)
    ph.gate("f64_ref_success_frac", ref_ok.mean(), 0.9, ">=")
    # float32 banded interior point vs float64 dense interior point
    ph.gate("cmd_err_vs_f64_max", err.max() if err.size else np.inf, 5e-3)
    ph.finish()


def phase_ugv(card: str, B: int = 256, K: int = 150) -> None:
    """P5: the UGV obstacle loop as one ``nlmpc_rollout`` of K steps."""
    import jax.numpy as jnp
    import numpy as np

    import bench
    from libmpc_tpu.rollout import nlmpc_rollout

    ph = Phase("P5_ugv", card)
    dtype = jnp.float32
    c, plant, params_fn, x0, obstacles, radii, yref = bench._make_ugv(dtype, B)
    r, t_run = _timed(lambda: nlmpc_rollout(
        c, plant, x0, jnp.zeros((B, 2), dtype), K, params_fn=params_fn))
    goal, avoid = bench.ugv_outcomes(r.states, obstacles, radii, yref)
    ref = _oracle("ugv_closed_loop_ref_f64.npz")
    ogoal, _ = bench.ugv_outcomes(ref["states"][:, : K + 1], obstacles,
                                  radii, yref)
    ph.value(batch=B, steps=K, run_s_with_compile=t_run,
             success_frac=float(np.mean(np.asarray(r.statuses) == 0)),
             goal_frac=float(goal.mean()), oracle_goal_frac=float(ogoal.mean()),
             oracle_lanes=int(ref["B"]))
    ph.gate("avoid_frac", avoid.mean(), 1.0, ">=")
    # the oracle holds 32 lanes: goal fractions agree to within 0.15
    ph.gate("goal_frac_diff_vs_oracle", abs(goal.mean() - ogoal.mean()), 0.15)
    ph.finish()


def _vdp_subproblems(B: int, seed: int = 0):
    """The first SQP subproblem of ``B`` Van der Pol NLMPC instances, built
    as ops/sqp.py builds it for the fused engine: Gershgorin-convexified
    curvature, rows [dynamics defects; input inequalities; box]."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from libmpc_tpu.nlmpc import problem as nlp
    from libmpc_tpu.ops.sqp import _gershgorin_convexify

    f32 = jnp.float32
    c, _ = bench._make_vdp(f32, bench.vdp_params())
    dims, fns = c.dims, c._fns
    ss, us = c._state_scaling, c._input_scaling
    lb, ub, _ = c._bounds_args()
    big = 1e20

    def one(x0):
        z = nlp.initial_guess(dims, x0, jnp.zeros((dims.nu,), f32),
                              jnp.zeros((), f32), f32)
        f = lambda zz: nlp.objective(dims, fns, ss, us, zz, x0)
        ce_fn = lambda zz: nlp.state_defects(dims, fns, ss, us, zz, x0)
        ci_fn = lambda zz: nlp.user_ineq(dims, fns, ss, us, zz, x0)
        H = jax.hessian(f)(z)
        P = _gershgorin_convexify(0.5 * (H + H.T), z.shape[0], f32)
        ce, ci = ce_fn(z), ci_fn(z)
        nz = z.shape[0]
        A = jnp.concatenate(
            [jax.jacfwd(ce_fn)(z), jax.jacfwd(ci_fn)(z), jnp.eye(nz, dtype=f32)])
        lo = jnp.concatenate([-ce, jnp.full(ci.shape, -jnp.inf, f32),
                              jnp.maximum(lb, -big) - z])
        hi = jnp.concatenate([-ce, -ci, jnp.minimum(ub, big) - z])
        return P, A, jax.grad(f)(z), lo, hi

    x0 = jnp.asarray(
        np.random.default_rng(seed).uniform(-1, 1, size=(B, 2)), f32)
    P, A, q, lo, hi = jax.jit(jax.vmap(one))(x0)
    eq = jnp.arange(A.shape[1]) < dims.ph * dims.nx
    return P, A, q, lo, hi, eq


def phase_kernels(card: str, B: int = 4096, reps: int = 5,
                  interpret: bool = False) -> None:
    """P6: the fused inner-QP kernel (ops/qp_inner_pallas.py) on B first
    SQP subproblems of the Van der Pol NLMPC (nz=26, m_qp=57) against the
    plain XLA reference, ADMM vmapped over the batch (ops/admm.py, same
    algorithm and settings, float32 at ``highest`` matmul precision, no
    stall freeze since the kernel has none).

    Convergence is compared at a 1000-iteration cap.  At the SQP's own cap
    of 300 about a tenth of these cold subproblems stop at the cap, and
    float32 rounding moves instances across that line both ways: two
    builds of one engine differ there by up to a percent.  At 1000 almost
    every instance converges in both.  Times are taken at the SQP's cap,
    alternating plain, kernel, kernel, plain; they are findings, not
    gates."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libmpc_tpu.ops import admm, qp_inner_pallas as qip
    from libmpc_tpu.types import LParameters

    ph = Phase("P6_kernels", card)
    P, A, q, lo, hi, eq = _vdp_subproblems(B)
    n, m = q.shape[1], A.shape[1]
    x0 = jnp.zeros((B, n), jnp.float32)
    y0 = jnp.zeros((B, m), jnp.float32)

    def engines(max_iter):
        kw = dict(sigma=1e-5, alpha=1.6, eps_abs=5e-6, eps_rel=5e-6,
                  max_iter=max_iter, check_every=25)
        par = LParameters(maximum_iteration=max_iter, eps_abs=5e-6,
                          eps_rel=5e-6, sigma=1e-5, alpha=1.6, rho=0.1,
                          check_termination=25, polish=False,
                          scaling_iters=10, stall_checks=0)

        @jax.jit
        def plain(P, A, q, lo, hi):
            with jax.default_matmul_precision("highest"):
                return jax.vmap(lambda *a: admm.admm_solve(
                    *a, params=par, eq_mask=eq))(P, A, q, lo, hi)

        return (lambda: qip.solve_batched(
                    P, A, q, lo, hi, x0, y0, n_eq=int(eq.sum()), **kw,
                    interpret=interpret),
                lambda: plain(P, A, q, lo, hi))

    kernel, plain = engines(1000)
    xk, _, _, it_k, done_k, _, _ = jax.block_until_ready(kernel())
    ref = jax.block_until_ready(plain())
    ok_ref = np.asarray(ref.status) == admm.OSQP_SOLVED
    both = np.asarray(done_k) & ok_ref
    scale = 1.0 + np.abs(np.asarray(ref.x)).max(axis=-1)
    err = (np.abs(np.asarray(xk) - np.asarray(ref.x)).max(axis=-1) / scale)[both]
    iters_k = float(np.mean(it_k))
    iters_p = float(np.mean(np.asarray(ref.iters)))
    ph.value(batch=B, widths=[n, m], max_iter=1000,
             kernel_converged=float(np.mean(done_k)),
             plain_converged=float(np.mean(ok_ref)),
             kernel_iters_mean=iters_k, plain_iters_mean=iters_p,
             x_rel_err_mean=float(err.mean()) if err.size else None)
    # the kernel converges as often as the plain engine, less half a
    # percent of the batch, and in about as many iterations (a kernel that
    # adapted rho without the float32 bounds took a third more)
    ph.gate("kernel_converged_frac_vs_plain",
            np.mean(done_k) - np.mean(ok_ref), -0.005, ">=")
    ph.gate("kernel_iters_mean_over_plain", iters_k / iters_p, 1.1)
    # where both converged, the solutions agree to the tolerance's scale
    ph.gate("x_rel_err_max_converged", err.max() if err.size else np.inf, 1e-3)

    kernel, plain = engines(300)
    jax.block_until_ready((kernel(), plain()))
    t = {"plain": [], "kernel": []}
    for _ in range(reps):
        for k in ("plain", "kernel", "kernel", "plain"):
            _, dt = _timed(kernel if k == "kernel" else plain)
            t[k].append(dt)
    ph.value(solve_s_median_at_300={k: float(np.median(v)) for k, v in t.items()},
             solve_s_all=t)
    ph.finish()


def _fleet_gates(ph, stats, B, fleet_cmd, one_cmd, tol):
    """n_total, commands against the one-card solve within ``tol``, and
    device memory used on every card (a program that leaves all the work
    on card 0 fails this)."""
    import jax
    import numpy as np

    ph.gate("n_total_matches", float(int(stats.n_total) == B), 1.0, ">=")
    err = np.abs(np.asarray(fleet_cmd) - np.asarray(one_cmd)).max()
    ph.value(cmd_err_vs_one_card=float(err))
    ph.gate("cmd_err_vs_one_card", err, tol)
    if jax.devices()[0].platform == "gpu":
        peaks = [d.memory_stats()["peak_bytes_in_use"] for d in jax.devices()]
        ph.gate("min_peak_bytes_over_devices", min(peaks), 1.0, ">=")


def phase_four_lmpc(card: str, B_per: int = 16384) -> None:
    """LMPCFleet over ``make_mesh(data=4)`` against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from __graft_entry__ import _quadrotor_setup
    from libmpc_tpu.parallel.fleet import LMPCFleet
    from libmpc_tpu.parallel.mesh import make_mesh

    ph = Phase("F1_lmpc_fleet", card)
    B = 4 * B_per
    x0 = 0.05 * np.random.default_rng(0).normal(size=(B, 12))
    u0 = np.zeros((B, 4))
    c = _quadrotor_setup(jnp.float32)
    c.set_optimizer_parameters(bench.headline_params())
    fleet = LMPCFleet(c, make_mesh(data=4))
    (res, stats), t_fleet = _timed(lambda: fleet.optimize(x0, u0))
    c1 = _quadrotor_setup(jnp.float32)
    c1.set_optimizer_parameters(bench.headline_params())
    with jax.default_device(jax.devices()[0]):
        one, t_one = _timed(lambda: c1.optimize(x0, u0))
    ph.value(batch=B, fleet_s_with_compile=t_fleet, one_card_s_with_compile=t_one)
    _fleet_gates(ph, stats, B, res.cmd, one.cmd, 1e-4)
    ph.finish()


def phase_four_vdp(card: str, B_per: int = 4096) -> None:
    """NLMPCFleet (Van der Pol) over ``make_mesh(data=4)`` against one card
    solving each card's slice at the same local batch: the same vmapped SQP
    at the same shape, so the commands agree to the last bits.  (A one-card
    solve of the whole batch is another program: on an H100 the same lanes
    solved at B=16384 and at B=4096 differ by up to 5.8e-4, while a repeated
    B=4096 solve is bitwise equal.)"""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from libmpc_tpu.parallel.fleet import NLMPCFleet
    from libmpc_tpu.parallel.mesh import make_mesh

    ph = Phase("F2_vdp_fleet", card)
    B = 4 * B_per
    x0 = np.asarray(np.random.default_rng(0).uniform(-1, 1, size=(B, 2)),
                    np.float32)
    u0 = np.zeros((B, 1), np.float32)
    c, _ = bench._make_vdp(jnp.float32, bench.vdp_params())
    fleet = NLMPCFleet(c, make_mesh(data=4))
    (res, stats), t_fleet = _timed(lambda: fleet.optimize(x0, u0))
    one = []
    with jax.default_device(jax.devices()[0]):
        t0 = time.perf_counter()
        for i in range(4):
            c1, _ = bench._make_vdp(jnp.float32, bench.vdp_params())
            sl = slice(i * B_per, (i + 1) * B_per)
            one.append(np.asarray(c1.optimize(x0[sl], u0[sl]).cmd))
        t_one = time.perf_counter() - t0
    ph.value(batch=B, fleet_s_with_compile=t_fleet,
             one_card_slices_s_with_compile=t_one)
    # float32 ulp-level at unit command scale; the expected value is 0.0
    _fleet_gates(ph, stats, B, res.cmd, np.concatenate(one), 1e-6)
    ph.finish()


def phase_four_qp_sharded(card: str, B: int = 64) -> None:
    """``solve_sharded`` with constraint rows over ``model=4`` against the
    unsharded ``admm_solve`` of the quadrotor QPs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _quadrotor_setup
    from libmpc_tpu.lmpc import problem as qp
    from libmpc_tpu.ops import admm
    from libmpc_tpu.parallel.mesh import make_mesh
    from libmpc_tpu.parallel.qp_sharded import solve_sharded
    from libmpc_tpu.types import LParameters

    ph = Phase("F3_qp_row_sharded", card)
    dtype = jnp.float32
    c = _quadrotor_setup(dtype)
    dims, prob = c.dims, c._prob
    P, A, lineq, uineq = qp.build_time_invariant(dims, prob)
    x0 = jnp.asarray(0.05 * np.random.default_rng(0).normal(size=(B, 12)), dtype)
    q, l, u = qp.build_time_varying(dims, prob, lineq, uineq, x0,
                                    jnp.zeros((B, 4), dtype), c._y_ref,
                                    c._u_ref, c._du_ref, c._u_meas)
    par = LParameters(maximum_iteration=250, rho=0.1, polish=True)
    eq = jnp.arange(dims.m) < dims.n_eq
    sh, t_sh = _timed(lambda: solve_sharded(P, A, q, l, u,
                                            make_mesh(data=1, model=4), par,
                                            eq_mask=eq))
    with jax.default_device(jax.devices()[0]):
        one, t_one = _timed(lambda: jax.jit(
            lambda *a: admm.admm_solve(*a, par, eq_mask=eq))(P, A, q, l, u))
    cmd = [np.asarray(qp.unpack_solution(dims, prob, s.x, c._u_meas)[1])[:, 0]
           for s in (sh, one)]
    err = np.abs(cmd[0] - cmd[1]).max()
    ph.value(batch=B, sharded_s_with_compile=t_sh, one_card_s_with_compile=t_one,
             cmd_err_vs_one_card=float(err))
    # float32 solves at the default tolerances: the row reductions sum in
    # another order, the iterates part at rounding level and stop at
    # different checks (CPU rehearsal: 3.3e-4)
    ph.gate("cmd_err_vs_one_card", err, 1e-3)
    if jax.devices()[0].platform == "gpu":
        peaks = [d.memory_stats()["peak_bytes_in_use"] for d in jax.devices()]
        ph.gate("min_peak_bytes_over_devices", min(peaks), 1.0, ">=")
    ph.finish()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded paths on four GPUs")
    args = parser.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "libmpc_tpu")):
        sys.exit("chip_smoke: run from a checkout of the repository "
                 "(libmpc_tpu/ not found beside this script)")
    sys.path.insert(0, REPO)
    from libmpc_tpu.utils.compile_cache import use_compile_cache

    cache_dir = use_compile_cache(REPO)
    import jax
    import jaxlib

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {devices}")
    want = 4 if args.four else 1
    if len(devices) < want:
        sys.exit(f"chip_smoke: needs {want} GPUs, JAX found {len(devices)}")
    card = card_info()
    print(f"card: {card}", flush=True)

    counts = {"hits": 0, "misses": 0}

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            counts["hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            counts["misses"] += 1

    jax.monitoring.register_event_listener(on_event)
    p0 = Phase("P0_device", card)
    p0.value(device_kind=devices[0].device_kind, device_count=len(devices),
             jax=jax.__version__, jaxlib=jaxlib.__version__,
             compile_cache_dir=cache_dir)
    p0.finish()

    t0 = time.perf_counter()
    if args.four:
        phases = (phase_four_lmpc, phase_four_vdp, phase_four_qp_sharded)
    else:
        phases = (phase_lmpc, phase_lmpc_closed_loop, phase_vdp,
                  phase_oscillators, phase_ugv, phase_kernels)
    for phase in phases:
        phase(card)
    print(json.dumps({"phase": "summary", "total_s": time.perf_counter() - t0,
                      "compile_cache": {"dir": cache_dir, **counts},
                      "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
