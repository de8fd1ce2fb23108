"""Benchmark: batched quadrotor-LMPC solves/s on one accelerator.

Measures the headline metric from BASELINE.json — batched quadrotor LMPC
(12-state/4-input, ph=ch=10, the reference's examples/quadrotor_ex.cpp
configuration) — as steady-state closed-loop control steps over a batch of
randomized initial states, plus the NLMPC, closed-loop, oscillator, UGV and
latency sections.  Target: >= 10,000 solves/s/host.

Runs on the GPU and fails when JAX finds none.  ``LIBMPC_PLATFORM=cpu``
is an explicit CPU rehearsal at smoke sizes (tests); its output says
``"platform": "cpu"``.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "solves/s", "vs_baseline": N/10000,
   "platform": ..., "device_kind": ..., "device_count": ..., ...}
"""

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.abspath(__file__))


def _device_stamp() -> dict:
    """Platform, kind and count of the devices the run used."""
    d = jax.devices()
    return {"platform": d[0].platform, "device_kind": d[0].device_kind,
            "device_count": len(d)}


def headline_params():
    """Production settings of the headline quadrotor LMPC re-solve.

    Warm-started steady-state control steps with the shared-factorization
    polish (Woodbury corrections + one compensated-residual anchor +
    incremental refinement passes) — float32 ADMM alone stalls at ~1e-3
    residuals, the polish recovers ~1e-5 command accuracy vs the f64
    golden.  maximum_iteration=100: ~1% of instances stall above the
    float32 ADMM tolerance and would otherwise drag the whole lockstep batch
    to the cap (the polish repairs their accuracy; they report
    OSQP_SOLVED_INACCURATE like the reference would).  rho=0.01 (vs the
    reference's 1e-6 default) improves the float32 iteration floor on this
    problem family.  check_termination=10 (vs OSQP's 25): with straggler
    compaction, checking residuals sooner lets the warm-started majority
    retire after one 10-iteration block.
    """
    from libmpc_tpu import LParameters

    return LParameters(maximum_iteration=100, enable_warm_start=True,
                       polish=True, polish_mode="shared", rho=0.01,
                       cold_rho=0.1, check_termination=10)


def vdp_params():
    """Production settings of the Van der Pol NLMPC sections: the fused
    inner-QP engine (one kernel launch per SQP iteration for the whole
    batch) and factorization-free Gershgorin curvature."""
    from libmpc_tpu import NLParameters

    return NLParameters(maximum_iteration=30, enable_warm_start=True,
                        inner_qp="fused", hessian_reg="gershgorin")


def main():
    rehearsal = os.environ.get("LIBMPC_PLATFORM")
    if rehearsal:
        jax.config.update("jax_platforms", rehearsal)
    from libmpc_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache(REPO)
    if not rehearsal and jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU found (devices: {jax.devices()}); "
                 "set LIBMPC_PLATFORM=cpu for a CPU rehearsal")
    from __graft_entry__ import _quadrotor_setup
    from libmpc_tpu.lmpc.controller import build_prepared, solve_body

    dtype = jnp.float32
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    c = _quadrotor_setup(dtype)
    base_params = headline_params()

    import functools

    rng = np.random.default_rng(0)
    c.set_optimizer_parameters(base_params)
    dims, prob = c.dims, c._prob
    # time-invariant setup hoisted out of the control steps (the controller
    # path caches this in _ensure_built)
    built = build_prepared(dims, base_params, prob,
                           c._y_ref, c._u_ref, c._du_ref, c._u_meas)

    @functools.partial(jax.jit, static_argnames=())
    def step(prob, x0, u0, warm_x, warm_y, have_warm, built):
        result, seq, sol_x, sol_y, iters = solve_body(
            dims, base_params, prob, x0, u0,
            c._y_ref, c._u_ref, c._du_ref, c._u_meas,
            warm_x, warm_y, have_warm, jnp.zeros_like(u0),
            built=built,
        )
        return result, sol_x, sol_y, iters

    x0 = jnp.asarray(0.05 * rng.normal(size=(B, 12)), dtype)
    u0 = jnp.zeros((B, 4), dtype)
    warm_x = jnp.zeros((B, dims.nz), dtype)
    warm_y = jnp.zeros((B, dims.m), dtype)
    # warm-up: compile + 2 steps to the warm-started steady state
    result, warm_x, warm_y, iters = step(
        prob, x0, u0, warm_x, warm_y, jnp.asarray(False), built)
    result, warm_x, warm_y, iters = step(prob, x0, result.cmd, warm_x, warm_y, jnp.asarray(True), built)
    jax.block_until_ready(warm_x)

    # timed steady-state control steps.
    # (a) per-step latency: synchronized steps (host blocks on each result —
    # what a single control loop would see)
    reps = 12
    latencies = []
    u = result.cmd
    for _ in range(reps):
        t0 = time.perf_counter()
        result, warm_x, warm_y, iters = step(
            prob, x0, u, warm_x, warm_y, jnp.asarray(True), built
        )
        jax.block_until_ready(result.cmd)
        latencies.append(time.perf_counter() - t0)
        u = result.cmd

    lat = np.array(latencies)

    # (b) throughput: pipelined steps — each step consumes the previous
    # step's device-resident outputs, the host blocks once at the end, so
    # solves overlap dispatch instead of paying a host round trip per step
    # (the steady-state serving configuration)
    t0 = time.perf_counter()
    for _ in range(reps):
        result, warm_x, warm_y, iters = step(
            prob, x0, u, warm_x, warm_y, jnp.asarray(True), built
        )
        u = result.cmd
    jax.block_until_ready(result.cmd)
    solves_per_s = B * reps / (time.perf_counter() - t0)

    # correctness gate: first command of the zero-state instance vs the
    # double-precision golden (test/LMPC/test_common.cpp:230-236)
    cg = _golden_check(c, dims, dtype)

    env_int = lambda name, dflt: int(os.environ.get(name, dflt))
    # measured ceilings: pct_matmul_peak relates sustained FLOP/s to a
    # large highest-precision f32 matmul on this device, pct_hbm_peak
    # relates modeled memory traffic to a streaming triad (utils/flops.py)
    from libmpc_tpu.utils import flops as fl
    matmul_peak = fl.measure_matmul_peak(
        size=env_int("LIBMPC_PEAK_SIZE", 4096))
    hbm_peak = fl.measure_hbm_peak(
        size_mb=env_int("LIBMPC_HBM_PROBE_MB", 256))

    closed_loop = _closed_loop_bench(
        B=env_int("LIBMPC_CL_B", 16384), K=env_int("LIBMPC_CL_K", 16),
        matmul_peak=matmul_peak, hbm_peak=hbm_peak)
    nlmpc_cl = _nlmpc_closed_loop_bench(
        B=env_int("LIBMPC_NL_CL_B", 4096), K=env_int("LIBMPC_NL_CL_K", 16),
        matmul_peak=matmul_peak)
    osc = _nlmpc_osc_bench(
        B=env_int("LIBMPC_OSC_B", 256), K=env_int("LIBMPC_OSC_K", 8),
        matmul_peak=matmul_peak)
    ugv = _ugv_bench(B=env_int("LIBMPC_UGV_B", 256),
                     K=env_int("LIBMPC_UGV_K", 150))

    nlmpc_batch = env_int("LIBMPC_NL_B", 4096)
    nlmpc_rate, nlmpc_success = _nlmpc_bench(nlmpc_batch)

    # reference-equivalent CPU anchor (misc/reference_anchor.py)
    anchor_path = os.path.join(os.path.dirname(__file__), "BASELINE_ANCHOR.json")
    vs_ref = None
    anchor = {}
    if os.path.exists(anchor_path):
        with open(anchor_path) as fh:
            anchor = json.load(fh)
        ref_rate = anchor.get("lmpc_quadrotor", {}).get("solves_per_s")
        if ref_rate:
            vs_ref = round(float(solves_per_s) / float(ref_rate), 1)

    latency = (
        {} if os.environ.get("LIBMPC_SKIP_LATENCY")
        else _latency_bench(anchor=anchor)
    )

    # useful-FLOP accounting of the headline row: ADMM iterations +
    # termination checks at the measured mean iteration count (polish and
    # assembly excluded -> the tflops figure is a lower bound on the
    # sustained rate; model documented in libmpc_tpu/utils/flops.py)
    it_mean = float(jnp.mean(iters))
    flops_per_solve = fl.admm_solve_flops(
        dims.nz, dims.m, it_mean, base_params.check_termination)
    headline_tflops = flops_per_solve * solves_per_s / 1e12
    bytes_per_solve = fl.admm_solve_bytes(
        dims.nz, dims.m, it_mean, base_params.check_termination)
    headline_gbs = bytes_per_solve * solves_per_s / 1e9

    out = {
        "metric": "quadrotor_lmpc_batched_solves_per_s",
        "value": round(float(solves_per_s), 1),
        "unit": "solves/s",
        "vs_baseline": round(float(solves_per_s) / 10000.0, 3),
        "vs_reference_cpu": vs_ref,
        "batch": B,
        "step_latency_ms_mean": round(float(lat.mean() * 1e3), 3),
        "step_latency_ms_p99": round(float(np.quantile(lat, 0.99) * 1e3), 3),
        "admm_iters_mean": round(it_mean, 1),
        "cmd_max_abs_err_vs_golden": cg,
        "tflops": round(headline_tflops, 3),
        "pct_matmul_peak": round(100.0 * headline_tflops / matmul_peak, 2),
        "matmul_peak_tflops_f32": round(matmul_peak, 2),
        "gbs": round(headline_gbs, 1),
        "pct_hbm_peak": round(100.0 * headline_gbs / hbm_peak, 2),
        "hbm_peak_gbs": round(hbm_peak, 1),
        "nlmpc_vdp_solves_per_s": nlmpc_rate,
        "nlmpc_success_frac": nlmpc_success,
        "nlmpc_batch": nlmpc_batch,
        **_device_stamp(),
    }
    out.update(closed_loop)
    out.update(nlmpc_cl)
    out.update(osc)
    out.update(ugv)
    out.update(latency)
    print(json.dumps(out))


def _closed_loop_inputs(B: int, K: int, nx: int = 12):
    """Shared deterministic inputs of the plant-coupled LMPC benchmark:
    randomized initial states and a per-step, per-instance process
    disturbance (the plant is the controller model PLUS this noise, so the
    warm start is never exact and every step is a genuine re-solve)."""
    rng = np.random.default_rng(7)
    x0 = 0.05 * rng.normal(size=(B, nx))
    noise = 0.002 * rng.normal(size=(K, B, nx))
    return x0, noise


def _closed_loop_params():
    from libmpc_tpu import LParameters

    # production closed-loop configuration: receding-horizon warm-start
    # shift (re-aligns the previous solution one stage forward each step —
    # built for exactly this workload), shared polish, early checks.
    # maximum_iteration=250 lets the COLD first step converge; warm steps
    # retire at their own (much earlier) checks.  cold_rho=0.1: the
    # warm-regime rho (0.01) starves the cold first solve.
    return LParameters(
        maximum_iteration=250, enable_warm_start=True, warm_start_shift=True,
        polish=True, polish_mode="shared", rho=0.01, cold_rho=0.1,
        check_termination=10,
    )


def _closed_loop_bench(B: int = 16384, K: int = 16, matmul_peak=None,
                       hbm_peak=None):
    """Plant-coupled receding-horizon LMPC: the ENTIRE closed loop — solver
    and disturbed plant — runs on device as one lax.scan
    (libmpc_tpu/rollout.py), mirroring the reference's application pattern
    (examples/vanderpol_ex.cpp:76-85) at fleet scale.  Unlike the headline
    re-solve metric, every step solves a genuinely new problem: the state
    moved and the plant injected noise.

    Accuracy is reported at two levels:

    * ``closed_loop_cmd_err_matched_*`` — the SOLVER's per-step accuracy:
      a shadow rollout along the f64 oracle's own state trajectory, so
      every step solves the identical problem the oracle solved.  This is
      the gate that certifies f32 solve quality (p99 ~ 3e-6).
    * ``closed_loop_cmd_*_err_vs_f64`` — free-trajectory divergence: the
      f32 and f64 closed LOOPS drift apart because a ~1e-4-level cold-step
      difference compounds through the marginally-damped plant; both
      trajectories are valid closed-loop runs of the same controller (the
      matched-state error proves the per-solve agreement), so this figure
      measures plant sensitivity, not solver error.
    """
    from __graft_entry__ import _quadrotor_model, _quadrotor_setup
    from libmpc_tpu.rollout import lmpc_rollout
    from libmpc_tpu.utils import flops as fl

    dtype = jnp.float32
    c = _quadrotor_setup(dtype)
    c.set_optimizer_parameters(_closed_loop_params())
    Ad, Bd = _quadrotor_model()
    Adj, Bdj = jnp.asarray(Ad, dtype), jnp.asarray(Bd, dtype)
    x0_h, noise_h = _closed_loop_inputs(B, K)
    noise = jnp.asarray(noise_h, dtype)

    def plant(x, u, k):
        return x @ Adj.T + u @ Bdj.T + noise[k]

    x0 = jnp.asarray(x0_h, dtype)
    u0 = jnp.zeros((B, 4), dtype)
    r = lmpc_rollout(c, plant, x0, u0, K)  # compile + first run
    jax.block_until_ready(r.inputs)
    t0 = time.perf_counter()
    r = lmpc_rollout(c, plant, x0, u0, K)
    jax.block_until_ready(r.inputs)
    rate = B * K / (time.perf_counter() - t0)
    iters = np.asarray(r.iterations)  # (B, K)
    params = c._params
    cap = params.maximum_iteration
    tfl = (fl.admm_solve_flops(c.dims.nz, c.dims.m, float(iters.mean()),
                               params.check_termination) * rate / 1e12)
    out = {
        "closed_loop_solves_per_s": round(float(rate), 1),
        "closed_loop_batch": B,
        "closed_loop_steps": K,
        "closed_loop_iters_mean": round(float(iters.mean()), 1),
        # steps >= 1 run in the warm-started receding-horizon regime the
        # loop settles into; step 0 is the one cold solve of the rollout
        "closed_loop_iters_mean_warm": round(float(iters[:, 1:].mean()), 1),
        "closed_loop_iters_p99_warm": round(
            float(np.quantile(iters[:, 1:], 0.99)), 1),
        # fraction of warm instance-steps that ran to the iteration cap
        # (the straggler tail; stall detection freezes floor-stalled
        # instances with their SOLVED_INACCURATE verdict early)
        "closed_loop_cap_frac_warm": round(
            float(np.mean(iters[:, 1:] >= cap)), 5),
        "closed_loop_success_frac": round(
            float(np.mean(np.asarray(r.statuses) == 0)), 4),
        "closed_loop_tflops": round(tfl, 3),
    }
    if matmul_peak:
        out["closed_loop_pct_matmul_peak"] = round(100.0 * tfl / matmul_peak, 2)
    if hbm_peak:
        gbs = (fl.admm_solve_bytes(c.dims.nz, c.dims.m, float(iters.mean()),
                                   params.check_termination)
               * rate / 1e9)
        out["closed_loop_gbs"] = round(gbs, 1)
        out["closed_loop_pct_hbm_peak"] = round(100.0 * gbs / hbm_peak, 2)

    # f64-oracle comparisons (misc/closed_loop_ref.py, B=1024 committed)
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "misc", "results", "closed_loop_ref_f64.npz")
    # oracle comparisons run at the oracle's own (B=1024, K=16); skip them
    # for smoke runs shrunk below that scale
    if os.path.exists(ref_path) and B >= 1024:
        ref = np.load(ref_path)
        B0, K0 = int(ref["B"]), int(ref["K"])
        # regenerate the oracle's inputs EXACTLY (the RNG stream depends on
        # the requested sizes, so slicing the big batch would differ)
        x0_r, noise_r = _closed_loop_inputs(B0, K0)
        noise0 = jnp.asarray(noise_r, dtype)

        def plant0(x, u, k):
            return x @ Adj.T + u @ Bdj.T + noise0[k]

        c0 = _quadrotor_setup(dtype)
        c0.set_optimizer_parameters(_closed_loop_params())
        r0 = lmpc_rollout(c0, plant0, jnp.asarray(x0_r, dtype),
                          jnp.zeros((B0, 4), dtype), K0)
        err = np.abs(np.asarray(r0.inputs) - ref["inputs"])
        out["closed_loop_cmd_max_err_vs_f64"] = round(float(err.max()), 8)
        out["closed_loop_cmd_mean_err_vs_f64"] = round(float(err.mean()), 8)
        out["closed_loop_cmd_p99_err_vs_f64"] = round(
            float(np.quantile(err, 0.99)), 8)

        # matched-state shadow rollout: teleport the plant onto the
        # oracle's trajectory so every step solves the oracle's problem
        ostates = jnp.asarray(ref["states"], dtype)

        def plant_shadow(x, u, k):
            return ostates[:, k + 1]

        cs = _quadrotor_setup(dtype)
        cs.set_optimizer_parameters(_closed_loop_params())
        rs = lmpc_rollout(cs, plant_shadow, ostates[:, 0],
                          jnp.zeros((B0, 4), dtype), K0)
        errm = np.abs(np.asarray(rs.inputs) - ref["inputs"]).max(axis=-1)
        out["closed_loop_cmd_err_matched_mean"] = round(
            float(errm[:, 1:].mean()), 9)
        out["closed_loop_cmd_err_matched_p99"] = round(
            float(np.quantile(errm[:, 1:], 0.99)), 9)
        out["closed_loop_cmd_err_matched_max"] = round(
            float(errm[:, 1:].max()), 8)
        out["closed_loop_cmd_err_matched_cold_mean"] = round(
            float(errm[:, 0].mean()), 8)
    return out


def _vdp_closed_loop_inputs(B: int, K: int):
    rng = np.random.default_rng(11)
    x0 = rng.uniform(-1.0, 1.0, size=(B, 2))
    noise = 0.01 * rng.normal(size=(K, B, 2))
    return x0, noise


def _make_vdp(dtype, params):
    from libmpc_tpu import NLMPC

    def vdp(x, u, k):
        return jnp.stack([(1.0 - x[1] * x[1]) * x[0] - x[1] + u[0], x[0]])

    c = NLMPC(2, 1, 2, 10, 5, 11, 0, dtype=dtype)
    c.set_discretization_sampling_time(0.1)
    c.set_optimizer_parameters(params)
    c.set_state_space_function(vdp)
    c.set_objective_function(lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
    c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
    return c, vdp


def _nlmpc_closed_loop_bench(B: int = 4096, K: int = 16, matmul_peak=None):
    """Plant-coupled receding-horizon NLMPC (Van der Pol): full closed loop
    on device via nlmpc_rollout — the warm-start shift + carried slack live
    in the scan carry, like the reference carries opt_vector across steps
    (NLOptimizer.hpp:426-510)."""
    from libmpc_tpu.rollout import nlmpc_rollout

    dtype = jnp.float32
    params = vdp_params()
    c, vdp = _make_vdp(dtype, params)
    x0_h, noise_h = _vdp_closed_loop_inputs(B, K)
    noise = jnp.asarray(noise_h, dtype)
    ts = 0.1

    def plant(x, u, k):
        return x + ts * jax.vmap(vdp, in_axes=(0, 0, None))(x, u, k) + noise[k]

    x0 = jnp.asarray(x0_h, dtype)
    u0 = jnp.zeros((B, 1), dtype)
    r = nlmpc_rollout(c, plant, x0, u0, K)
    jax.block_until_ready(r.inputs)
    t0 = time.perf_counter()
    r = nlmpc_rollout(c, plant, x0, u0, K)
    jax.block_until_ready(r.inputs)
    rate = B * K / (time.perf_counter() - t0)
    iters = np.asarray(r.iterations)
    out = {
        "nlmpc_closed_loop_solves_per_s": round(float(rate), 1),
        "nlmpc_closed_loop_batch": B,
        "nlmpc_closed_loop_steps": K,
        "nlmpc_closed_loop_iters_mean": round(float(iters.mean()), 2),
        "nlmpc_closed_loop_iters_p99": round(
            float(np.quantile(iters.reshape(-1), 0.99)), 1),
        "nlmpc_closed_loop_success_frac": round(
            float(np.mean(np.asarray(r.statuses) == 0)), 4),
    }
    if matmul_peak:
        # fused-engine FLOP model (libmpc_tpu/utils/flops.py); this row
        # has no memory-traffic model (the kernel keeps each instance's
        # matrices in registers)
        from libmpc_tpu.utils import flops as fl
        nz, me, mi = 26, 20, 11
        tfl = (fl.fused_sqp_iter_flops(nz, me, mi)
               * float(iters.mean()) * rate / 1e12)
        out["nlmpc_closed_loop_tflops_est"] = round(tfl, 4)
        out["nlmpc_closed_loop_pct_matmul_peak"] = round(
            100.0 * tfl / matmul_peak, 2)
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "misc", "results", "vdp_closed_loop_ref_f64.npz")
    # skip the oracle-sized comparison for sub-oracle smoke runs
    if os.path.exists(ref_path) and B >= 1024:
        ref = np.load(ref_path)
        B0, K0 = int(ref["B"]), int(ref["K"])
        # regenerate the oracle's inputs EXACTLY (the RNG stream depends on
        # the requested sizes, so slicing the big batch would differ)
        x0_r, noise_r = _vdp_closed_loop_inputs(B0, K0)
        noise0 = jnp.asarray(noise_r, dtype)

        def plant0(x, u, k):
            return (x + ts * jax.vmap(vdp, in_axes=(0, 0, None))(x, u, k)
                    + noise0[k])

        c0, _ = _make_vdp(dtype, params)
        r0 = nlmpc_rollout(c0, plant0, jnp.asarray(x0_r, dtype),
                           jnp.zeros((B0, 1), dtype), K0)
        err = np.abs(np.asarray(r0.inputs) - ref["inputs"])
        # the max is dominated by the single COLD step-0 solve (both
        # engines report SUCCESS at slightly different near-optimal
        # points); the warm receding-horizon steps track the oracle an
        # order of magnitude tighter — hence both aggregates
        out["nlmpc_closed_loop_cmd_max_err_vs_f64"] = round(
            float(err.max()), 8)
        out["nlmpc_closed_loop_cmd_mean_err_vs_f64"] = round(
            float(err.mean()), 8)
        out["nlmpc_closed_loop_cmd_p99_err_vs_f64"] = round(
            float(np.quantile(err, 0.99)), 8)

        # matched-state shadow rollout (the LMPC section's methodology):
        # teleport the plant onto the oracle's trajectory so each step
        # solves the oracle's exact problem — isolates per-solve f32
        # accuracy from free-trajectory divergence
        ostates = jnp.asarray(ref["states"], dtype)

        def plant_shadow(x, u, k):
            return ostates[:, k + 1]

        cs, _ = _make_vdp(dtype, params)
        rs = nlmpc_rollout(cs, plant_shadow, ostates[:, 0],
                           jnp.zeros((B0, 1), dtype), K0)
        errm = np.abs(np.asarray(rs.inputs) - ref["inputs"]).max(axis=-1)
        out["nlmpc_closed_loop_cmd_err_matched_mean"] = round(
            float(errm[:, 1:].mean()), 9)
        out["nlmpc_closed_loop_cmd_err_matched_p99"] = round(
            float(np.quantile(errm[:, 1:], 0.99)), 9)
        out["nlmpc_closed_loop_cmd_err_matched_max"] = round(
            float(errm[:, 1:].max()), 8)
    return out


_OSC_N, _OSC_MU, _OSC_K = 6, 1.0, 0.1


def _oscillator_dynamics(x, u, step):
    """6 diffusively-coupled Van der Pol oscillators — the reference's
    largest example (examples/networked_oscillators_ex.cpp:29-49):
    12 states / 6 inputs, nz = 301 at ph=20/ch=10.  (Constants close over
    the function: extra parameters would make callback canonicalization
    treat it as runtime-parameter-taking.)"""
    pos = x[0::2]
    vel = x[1::2]
    coupling = _OSC_K * (jnp.sum(pos) - _OSC_N * pos)
    dvel = _OSC_MU * (1.0 - pos**2) * vel - pos + u + coupling
    dx = jnp.zeros_like(x)
    dx = dx.at[0::2].set(vel)
    dx = dx.at[1::2].set(dvel)
    return dx


def _osc_controller(dtype):
    from libmpc_tpu import NLMPC, NLParameters

    ph, ch, nx, nu = 20, 10, 12, 6
    c = NLMPC(nx, nu, nx, ph, ch, (ph + 1) * nu, 0, dtype=dtype)
    c.set_discretization_sampling_time(0.1)
    c.set_state_space_function(_oscillator_dynamics)
    c.set_objective_function(lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
    c.set_ineq_con_function(lambda X, Y, U, e: (U - 0.5).reshape(-1))
    # two-phase configuration: flat IPM cap 30 for the whole batch, then
    # the compacted rescue phase re-solves only the failed lanes at cap 45
    # (rollout.py, NLParameters.rescue_iters).
    c.set_optimizer_parameters(NLParameters(
        maximum_iteration=30, enable_warm_start=True,
        hessian_reg="gauss_newton", inner_qp="fused",  # gated -> riccati
        inner_iters=30, inner_iters_recovery=30, rescue_iters=45,
    ))
    return c, 20, 10, 12, 6


def _osc_run(B, K, dtype=jnp.float32):
    from libmpc_tpu.rollout import nlmpc_rollout

    c, ph, ch, nx, nu = _osc_controller(dtype)
    rng = np.random.default_rng(13)
    x0 = jnp.asarray(rng.uniform(-0.5, 0.5, size=(B, nx)), dtype)
    noise = jnp.asarray(0.01 * rng.normal(size=(K, B, nx)), dtype)
    ts = 0.1

    def plant(x, u, k):
        step = jax.vmap(_oscillator_dynamics, in_axes=(0, 0, None))(x, u, k)
        return x + ts * step + noise[k]

    u0 = jnp.zeros((B, nu), dtype)
    r = nlmpc_rollout(c, plant, x0, u0, K)
    jax.block_until_ready(r.inputs)
    t0 = time.perf_counter()
    r = nlmpc_rollout(c, plant, x0, u0, K)
    jax.block_until_ready(r.inputs)
    rate = B * K / (time.perf_counter() - t0)
    return rate, r


def _nlmpc_osc_bench(B: int = 256, K: int = 8, matmul_peak=None):
    """Networked-oscillators NLMPC at real size (nz=301): full closed loop
    on device.  The fused inner-QP engine is size-gated out at this nz;
    the solve runs gauss_newton curvature (constant objective Hessian, no
    per-iteration nz^3 eigh) + the banded-KKT interior-point engine
    (ops/trajectory_kkt.py) with the two-phase cap policy (flat 30 +
    compacted rescue at 45 — see _osc_controller)."""
    ph, ch, nx, nu = 20, 10, 12, 6
    rate, r = _osc_run(B, K)
    iters = np.asarray(r.iterations)
    from libmpc_tpu.utils import flops as fl
    tfl = (fl.sqp_iter_flops(ph, ch, nx, nu, (ph + 1) * nu)
           * float(iters.mean()) * rate / 1e12)
    out = {
        "nlmpc_osc_solves_per_s": round(float(rate), 1),
        "nlmpc_osc_batch": B,
        "nlmpc_osc_steps": K,
        "nlmpc_osc_nz": ph * nx + nu * ch + 1,
        "nlmpc_osc_iters_mean": round(float(iters.mean()), 2),
        "nlmpc_osc_success_frac": round(
            float(np.mean(np.asarray(r.statuses) == 0)), 4),
        # banded-IPM FLOP model at the documented ~20 inner iterations
        # (libmpc_tpu/utils/flops.py::sqp_iter_flops)
        "nlmpc_osc_tflops_est": round(tfl, 4),
    }
    if matmul_peak:
        out["nlmpc_osc_pct_matmul_peak"] = round(100.0 * tfl / matmul_peak, 2)
    # B-scaling curve: does batch buy throughput on this engine
    if not os.environ.get("LIBMPC_SKIP_OSC_SCALING") and B == 256:
        for Bs in (512, 1024):
            rs, rr = _osc_run(Bs, max(K // 2, 2))
            out[f"nlmpc_osc_solves_per_s_b{Bs}"] = round(float(rs), 1)
            out[f"nlmpc_osc_success_frac_b{Bs}"] = round(
                float(np.mean(np.asarray(rr.statuses) == 0)), 4)
    return out


def _make_ugv(dtype, B):
    """The reference's UGV configuration (examples/ugv_ex.cpp:47-136) as a
    batched controller + on-device plant/params closures.  Shared between
    the hardware bench and the f64 oracle generator
    (misc/closed_loop_ref.py) so both solve the identical problem."""
    from libmpc_tpu import NLMPC, NLParameters, discretization

    n_obs = 2
    ph = ch = 10
    Ts = 0.1
    A = np.zeros((4, 4))
    A[0:2, 2:4] = np.eye(2)
    Bm = np.zeros((4, 2))
    Bm[2:4, 0:2] = np.eye(2)
    Ad, Bd = map(np.asarray, discretization(A, Bm, Ts))
    Adj, Bdj = jnp.asarray(Ad, dtype), jnp.asarray(Bd, dtype)
    obstacles = jnp.asarray([[2.0, 1.0], [1.0, 1.0]], dtype)
    radii = jnp.asarray([0.3, 0.3], dtype)
    yref = jnp.asarray([2.0, 2.0], dtype)
    speed = 1.0

    c = NLMPC(4, 2, 4, ph, ch, (ph + 1) * n_obs, 0, dtype=dtype)
    c.set_state_space_function(lambda x, u, k: Adj @ x + Bdj @ u)
    c.set_output_function(lambda x, u, k: x)

    def objective(X, Y, U, e, p):
        v_err = X[:, 2:4] - p["v_pref"][None, :]
        return 1e3 * jnp.sum(v_err**2) + 1e-2 * jnp.sum(U**2) + 1e-5 * e * e

    def ineq(X, Y, U, e):
        pos = X[:, 0:2]
        d = jnp.sqrt(jnp.sum(
            (pos[:, None, :] - obstacles[None, :, :]) ** 2, axis=-1))
        return (radii[None, :] - d).reshape(-1)

    c.set_objective_function(objective)
    c.set_ineq_con_function(ineq)
    c.set_runtime_params({"v_pref": jnp.zeros((B, 2), dtype)}, batched=True)
    # configuration chosen on obstacle avoidance: "eigh" curvature + the
    # warm-started inner-ADMM engine (every obstacle incursion seen with
    # looser curvature models was a failure-hold: a run of roundoff-limited
    # infeasible exits with the held command driving in);
    # cold_restart_on_failure re-enters failed lanes from the cold initial
    # guess next step; relative_ftol at an f32-reachable level, the analog
    # of SLSQP's acc-based stop.
    c.set_optimizer_parameters(NLParameters(
        maximum_iteration=200, hard_constraints=False,
        enable_warm_start=True, inner_qp="admm",
        hessian_reg="eigh", relative_ftol=1e-6,
        cold_restart_on_failure=True))

    def params_fn(x, k):
        # renormalized velocity reference toward the goal, per instance
        # (the reference's host loop, ugv_ex.cpp:143-151, on device)
        v = yref[None, :] - x[:, 0:2]
        nrm = jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        return {"v_pref": speed * v / nrm}

    def plant(x, u, k):
        return x @ Adj.T + u @ Bdj.T

    # perturbed starts around the origin (the reference starts at 0);
    # first-rows slices of the rng stream coincide across batch sizes
    rng = np.random.default_rng(21)
    x0 = jnp.asarray(
        np.concatenate([0.2 * rng.normal(size=(B, 2)),
                        np.zeros((B, 2))], axis=1), dtype)
    return c, plant, params_fn, x0, obstacles, radii, yref


def ugv_outcomes(states, obstacles, radii, yref):
    """Per-instance (reached goal, avoided obstacles) of UGV trajectories
    ``states`` (B, K+1, 4): the goal within 0.05 at the last step, and no
    approach closer than r - 1e-2 to an obstacle centre (the
    soft-constrained optimum grazes the boundary; the cpp example checks
    goal attainment only, ugv_ex.cpp:166)."""
    pos = np.asarray(states)[:, :, 0:2]
    goal = np.linalg.norm(pos[:, -1] - np.asarray(yref), axis=-1) < 0.05
    dmin = np.linalg.norm(
        pos[:, :, None, :] - np.asarray(obstacles)[None, None], axis=-1
    ).min(axis=(1, 2))
    return goal, dmin >= float(np.asarray(radii)[0]) - 1e-2


def _ugv_bench(B: int = 1024, K: int = 150):
    """UGV obstacle avoidance: the reference's third example (examples/ugv_ex.cpp:98-166) as a
    plant-coupled batched closed loop — 2 circular obstacles, nonconvex
    ``r - ||p - p_obs|| <= 0`` rows, soft constraints, and the per-step
    renormalized velocity reference flowing through the runtime-parameter
    channel, recomputed ON DEVICE from the current state each step
    (rollout ``params_fn``).  Success = goal reached without entering an
    obstacle."""
    from libmpc_tpu.rollout import nlmpc_rollout

    dtype = jnp.float32
    c, plant, params_fn, x0, obstacles, radii, yref = _make_ugv(dtype, B)
    u0 = jnp.zeros((B, 2), dtype)

    r = nlmpc_rollout(c, plant, x0, u0, K, params_fn=params_fn)
    jax.block_until_ready(r.inputs)  # compile + first run
    t0 = time.perf_counter()
    r = nlmpc_rollout(c, plant, x0, u0, K, params_fn=params_fn)
    jax.block_until_ready(r.inputs)
    rate = B * K / (time.perf_counter() - t0)
    goal, avoid = ugv_outcomes(np.asarray(r.states), obstacles, radii, yref)
    out = {
        "ugv_solves_per_s": round(float(rate), 1),
        "ugv_batch": B,
        "ugv_steps": K,
        "ugv_goal_frac": round(float(np.mean(goal)), 4),
        "ugv_avoid_frac": round(float(np.mean(avoid)), 4),
        "ugv_success_frac": round(float(np.mean(np.asarray(r.statuses) == 0)), 4),
        "ugv_iters_mean": round(float(np.asarray(r.iterations).mean()), 2),
    }
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "misc", "results", "ugv_closed_loop_ref_f64.npz")
    # the comparison runs at the oracle's own (B, K); skip it for smoke
    # runs shrunk below that scale (the comparison would dwarf them)
    if os.path.exists(ref_path) and K >= 150:
        # MATCHED-STATE comparison (shadow rollout along the oracle's own
        # trajectory): on this NONCONVEX problem free f32/f64 loops can
        # legitimately pick different obstacle sides and diverge O(1)+ —
        # a free-trajectory command diff measures local-solution selection,
        # not precision.  Teleporting the plant onto the oracle states
        # makes every step solve the oracle's exact problem (the same
        # diagnosis methodology as the LMPC section).
        ref = np.load(ref_path)
        B0, K0 = int(ref["B"]), int(ref["K"])
        ostates = jnp.asarray(ref["states"], dtype)

        def plant_shadow(x, u, k):
            return ostates[:, k + 1]

        c0, _plant0, pf0, x00, *_ = _make_ugv(dtype, B0)
        r0 = nlmpc_rollout(c0, plant_shadow, ostates[:, 0],
                           jnp.zeros((B0, 2), dtype), K0, params_fn=pf0)
        inputs0 = np.asarray(r0.inputs)
        err = np.abs(inputs0 - ref["inputs"]).max(axis=-1)
        mask = (
            (np.asarray(ref["statuses"]) == 0)
            if "statuses" in ref.files else np.ones_like(err, bool)
        )
        err = err[mask]
        # the obstacle NLP is multimodal: from the same state a solve
        # can legitimately converge to the left- or right-passage
        # optimum, and once a loop's warm start locks into a basin every
        # later solve stays there — so the f32 production path
        # (gershgorin curvature) and the f64 oracle (gauss_newton + pdip)
        # agree on only a fraction of steps, with O(10)+ command
        # differences on the rest that measure SOLUTION SELECTION, not
        # precision.  ugv_cmd_match_frac counts same-basin steps
        # (agreement within 1e-2); the behavioral goal/avoid fields are
        # the accuracy statement for this problem family
        # (docs/performance.md).
        out["ugv_cmd_err_matched_p50"] = round(
            float(np.quantile(err, 0.50)), 8)
        out["ugv_cmd_match_frac"] = round(float(np.mean(err < 1e-2)), 4)
        out["ugv_cmd_err_matched_mean"] = round(float(err.mean()), 8)
        # behavioral agreement: the oracle's own goal/avoidance rates
        ogoal, oavoid = ugv_outcomes(ref["states"], obstacles, radii, yref)
        out["ugv_goal_frac_f64"] = round(float(np.mean(ogoal)), 4)
        out["ugv_avoid_frac_f64"] = round(float(np.mean(oavoid)), 4)
    return out


def _latency_bench(batches=(1, 16, 64, 256), anchor=None):
    """Real-time latency table: synchronized single-solve latency — what
    one control loop sees per step — at small batch sizes, warm and cold,
    for quadrotor LMPC and Van der Pol NLMPC.  The reference is a single-instance real-time
    controller (its benchmark story is per-process timing,
    misc/benchmark.py of the reference); these are the numbers a user
    replacing it with this framework at batch ~1 actually gets, honest
    losses included.  ``latency_*_crossover_batch`` is the smallest
    measured batch where the device clears B solves faster than the CPU
    anchor clears them sequentially (B * anchor_ms).
    """
    import functools

    from __graft_entry__ import _quadrotor_setup
    from libmpc_tpu.lmpc.controller import build_prepared, solve_body

    dtype = jnp.float32
    out = {}
    anchor = anchor or {}
    lmpc_anchor_ms = anchor.get("lmpc_quadrotor", {}).get("per_solve_ms")
    nlmpc_anchor_ms = anchor.get("nlmpc_vanderpol", {}).get("per_solve_ms_mean")

    # -- quadrotor LMPC ----------------------------------------------------
    c = _quadrotor_setup(dtype)
    params = _closed_loop_params()
    c.set_optimizer_parameters(params)
    dims, prob = c.dims, c._prob
    built = build_prepared(dims, params, prob,
                           c._y_ref, c._u_ref, c._du_ref, c._u_meas)

    @functools.partial(jax.jit, static_argnames=())
    def step(prob, x0, u0, warm_x, warm_y, have_warm, built):
        result, seq, sol_x, sol_y, iters = solve_body(
            dims, params, prob, x0, u0,
            c._y_ref, c._u_ref, c._du_ref, c._u_meas,
            warm_x, warm_y, have_warm, jnp.zeros_like(u0),
            built=built,
        )
        return result, sol_x, sol_y

    rng = np.random.default_rng(3)
    lmpc_warm = {}
    for B in batches:
        x0h = 0.05 * rng.normal(size=(B, 12))
        x0 = jnp.asarray(x0h, dtype)
        u0 = jnp.zeros((B, 4), dtype)
        wx0 = jnp.zeros((B, dims.nz), dtype)
        wy0 = jnp.zeros((B, dims.m), dtype)
        # compile + reach the warm steady state
        res, wx, wy = step(prob, x0, u0, wx0, wy0, jnp.asarray(False), built)
        res, wx, wy = step(prob, x0, res.cmd, wx, wy, jnp.asarray(True), built)
        jax.block_until_ready(res.cmd)
        # warm: synchronized steady-state re-solves
        lat = []
        u = res.cmd
        for r in range(20):
            t0 = time.perf_counter()
            res, wx, wy = step(prob, x0, u, wx, wy, jnp.asarray(True), built)
            jax.block_until_ready(res.cmd)
            lat.append(time.perf_counter() - t0)
            u = res.cmd
        warm_ms = float(np.median(lat) * 1e3)
        # cold: no warm state at all (the first solve of a deployment)
        lat_c = []
        for r in range(8):
            t0 = time.perf_counter()
            res_c, _, _ = step(prob, x0, u0, wx0, wy0,
                               jnp.asarray(False), built)
            jax.block_until_ready(res_c.cmd)
            lat_c.append(time.perf_counter() - t0)
        out[f"latency_lmpc_b{B}_warm_ms"] = round(warm_ms, 3)
        out[f"latency_lmpc_b{B}_cold_ms"] = round(
            float(np.median(lat_c) * 1e3), 3)
        lmpc_warm[B] = warm_ms
    if lmpc_anchor_ms:
        cross = [B for B in batches if lmpc_warm[B] < B * lmpc_anchor_ms]
        out["latency_lmpc_anchor_ms"] = round(float(lmpc_anchor_ms), 3)
        out["latency_lmpc_crossover_batch"] = min(cross) if cross else -1

    # -- Van der Pol NLMPC -------------------------------------------------
    nl_params = vdp_params()
    nl_warm = {}
    for B in batches:
        c_nl, _ = _make_vdp(dtype, nl_params)
        c_nl.set_stats_mode("lazy")  # timing is explicit below
        x0h = np.asarray(rng.uniform(-1, 1, size=(B, 2)), np.float32)
        u0h = np.zeros((B, 1), np.float32)
        res = c_nl.optimize(x0h, u0h)
        res = c_nl.optimize(x0h, res.cmd)
        jax.block_until_ready(res.cmd)
        lat = []
        for r in range(20):
            t0 = time.perf_counter()
            res = c_nl.optimize(x0h, res.cmd)
            jax.block_until_ready(res.cmd)
            lat.append(time.perf_counter() - t0)
        warm_ms = float(np.median(lat) * 1e3)
        lat_c = []
        for r in range(8):
            c_nl._first_iteration = True  # forces the cold init path
            t0 = time.perf_counter()
            res_c = c_nl.optimize(x0h, u0h)
            jax.block_until_ready(res_c.cmd)
            lat_c.append(time.perf_counter() - t0)
        out[f"latency_nlmpc_b{B}_warm_ms"] = round(warm_ms, 3)
        out[f"latency_nlmpc_b{B}_cold_ms"] = round(
            float(np.median(lat_c) * 1e3), 3)
        nl_warm[B] = warm_ms
    if nlmpc_anchor_ms:
        cross = [B for B in batches if nl_warm[B] < B * nlmpc_anchor_ms]
        out["latency_nlmpc_anchor_ms"] = round(float(nlmpc_anchor_ms), 3)
        out["latency_nlmpc_crossover_batch"] = min(cross) if cross else -1

    # -- serving deadline datapoint ---------------------------------------
    # can the device hold the CPU anchor's own single-solve budget while
    # serving a whole batch?  deadline = the anchor's mean per-solve time
    # (13.7 ms for the quadrotor QP); hit = synchronized step under the
    # deadline with a SUCCESS/INACCURATE status.
    if lmpc_anchor_ms:
        B = 256
        x0 = jnp.asarray(0.05 * rng.normal(size=(B, 12)), dtype)
        u0 = jnp.zeros((B, 4), dtype)
        wx = jnp.zeros((B, dims.nz), dtype)
        wy = jnp.zeros((B, dims.m), dtype)
        res, wx, wy = step(prob, x0, u0, wx, wy, jnp.asarray(False), built)
        jax.block_until_ready(res.cmd)
        hits, n_steps = 0, 50
        u = res.cmd
        for r in range(n_steps):
            t0 = time.perf_counter()
            res, wx, wy = step(prob, x0, u, wx, wy, jnp.asarray(True), built)
            jax.block_until_ready(res.cmd)
            dt_ms = (time.perf_counter() - t0) * 1e3
            ok = bool(np.all(np.asarray(res.status) == 0))
            hits += int(ok and dt_ms <= lmpc_anchor_ms)
            u = res.cmd
        out["latency_serving_batch"] = B
        out["latency_serving_deadline_ms"] = round(float(lmpc_anchor_ms), 3)
        out["latency_serving_hit_frac"] = round(hits / n_steps, 4)
    return out


def _nlmpc_bench(B: int = 4096):
    """Secondary metric: batched Van der Pol NLMPC solves/s (full SQP with
    exact autodiff derivatives, warm-started steady state)."""
    params = vdp_params()
    rng = np.random.default_rng(0)
    x0 = np.asarray(rng.uniform(-1, 1, size=(B, 2)), np.float32)
    c, _ = _make_vdp(jnp.float32, params)
    c.set_stats_mode("lazy")  # pipelined steady state: no per-solve sync
    res = c.optimize(x0, np.zeros((B, 1), np.float32))
    res = c.optimize(x0, res.cmd)
    jax.block_until_ready(res.cmd)
    reps = 6
    t0 = time.perf_counter()
    for _ in range(reps):
        res = c.optimize(x0, res.cmd)
    jax.block_until_ready(res.cmd)
    rate = B * reps / (time.perf_counter() - t0)
    success = float(np.mean(np.asarray(res.status) == 0))
    return round(rate, 1), round(success, 4)


def _golden_check(c, dims, dtype):
    """Float32 accuracy of the PRODUCTION path on the golden instance: the
    same solver configuration the throughput loop uses (ADMM + PCG polish)
    solving the golden problem, command compared against the reference's
    double-precision golden (test/LMPC/test_common.cpp:230-236)."""
    import jax.numpy as jnp

    from libmpc_tpu.lmpc import problem as qp
    from libmpc_tpu.ops import admm

    golden = np.array([-0.9916, 1.74839, -0.9916, 1.74839])
    prob = c._prob
    P, A, lineq, uineq = qp.build_time_invariant(dims, prob)
    q, l, u = qp.build_time_varying(
        dims, prob, lineq, uineq, jnp.zeros((12,), dtype), jnp.zeros((4,), dtype),
        c._y_ref, c._u_ref, c._du_ref, c._u_meas,
    )
    sol = admm.admm_solve(P, A, q, l, u, c._params,
                          eq_mask=jnp.arange(dims.m) < dims.n_eq)
    states, inputs, _ = qp.unpack_solution(dims, prob, sol.x, c._u_meas)
    err = np.abs(np.asarray(inputs)[0] - golden).max()
    return round(float(err), 8)


if __name__ == "__main__":
    main()
