"""Scaling-efficiency harness.

Measures fleet solves/s at 1, 2, ..., N devices for a fixed per-device batch
(weak scaling) and reports efficiency vs the single-device rate — the
protocol BASELINE.md asks to report at 1 chip / 1 host / N hosts.  On real
multi-chip hardware the data axis rides ICI; on a single-process CPU run
(XLA_FLAGS=--xla_force_host_platform_device_count=N) the numbers validate
the harness rather than the interconnect.

Usage:  python misc/scaling_bench.py [--per-device 512] [--steps 5]
"""

import os

if os.environ.get("LIBMPC_PLATFORM"):
    # explicit platform choice (e.g. a CPU rehearsal on virtual devices)
    import jax as _jax

    _jax.config.update("jax_platforms", os.environ["LIBMPC_PLATFORM"])

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import numpy as np

import jax
import jax.numpy as jnp


def measure(n_devices: int, per_device: int, steps: int) -> float:
    from libmpc_tpu import LParameters
    from libmpc_tpu.parallel import mesh as mesh_lib
    from libmpc_tpu.parallel.fleet import LMPCFleet

    from __graft_entry__ import _quadrotor_setup

    dtype = jnp.float32
    c = _quadrotor_setup(dtype)
    c.set_optimizer_parameters(
        LParameters(maximum_iteration=250, enable_warm_start=True, polish=False,
                    rho=0.01)
    )
    mesh = mesh_lib.make_mesh(data=n_devices,
                              devices=jax.devices()[:n_devices])
    fleet = LMPCFleet(c, mesh)

    B = per_device * n_devices
    rng = np.random.default_rng(0)
    x0 = np.asarray(0.05 * rng.normal(size=(B, 12)), np.float32)
    u = np.zeros((B, 4), np.float32)

    result, _ = fleet.optimize(x0, u)  # compile + cold start
    result, _ = fleet.optimize(x0, np.asarray(result.cmd))
    lats = []
    for _ in range(steps):
        t0 = time.perf_counter()
        result, _ = fleet.optimize(x0, np.asarray(result.cmd))
        jax.block_until_ready(result.cmd)
        lats.append(time.perf_counter() - t0)
    return B / float(np.median(lats))


def measure_row_sharded(n_model: int, B: int, steps: int,
                        params=None) -> float:
    """Model-parallel datapoint: the quadrotor QP with constraint rows
    sharded over ``model`` axis devices (data axis 1), median wall-clock of
    ``steps`` repeat solves through the CACHED sharded program (the first
    call compiles; subsequent calls must not retrace)."""
    from libmpc_tpu import LParameters
    from libmpc_tpu.lmpc import problem as qp
    from libmpc_tpu.parallel import mesh as mesh_lib
    from libmpc_tpu.parallel.qp_sharded import solve_sharded

    from __graft_entry__ import _quadrotor_setup

    dtype = jnp.float32
    c = _quadrotor_setup(dtype)
    params = params or LParameters(
        maximum_iteration=250, rho=0.01, polish=True, polish_mode="dense",
    )
    dims, prob = c.dims, c._prob
    P, A, lineq, uineq = qp.build_time_invariant(dims, prob)
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(0.05 * rng.normal(size=(B, 12)), dtype)
    q, l, u = qp.build_time_varying(
        dims, prob, lineq, uineq, x0, jnp.zeros((B, 4), dtype),
        c._y_ref, c._u_ref, c._du_ref, c._u_meas,
    )
    mesh = mesh_lib.make_mesh(data=1, model=n_model,
                              devices=jax.devices()[:n_model])
    eq_mask = jnp.arange(dims.m) < dims.n_eq
    sol = solve_sharded(P, A, q, l, u, mesh, params, eq_mask=eq_mask)
    jax.block_until_ready(sol.x)
    lats = []
    for _ in range(steps):
        t0 = time.perf_counter()
        sol = solve_sharded(P, A, q, l, u, mesh, params, eq_mask=eq_mask)
        jax.block_until_ready(sol.x)
        lats.append(time.perf_counter() - t0)
    return B / float(np.median(lats))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--row-sharded", action="store_true",
                    help="measure the model-parallel (row-sharded) QP path "
                         "at model axis 1/2/4 instead of the fleet scaling")
    ap.add_argument("--batch", type=int, default=1024,
                    help="batch size for --row-sharded")
    args = ap.parse_args()

    if args.row_sharded:
        n_avail = len(jax.devices())
        rows = []
        base = None
        for n in (1, 2, 4):
            if n > n_avail:
                break
            rate = measure_row_sharded(n, args.batch, args.steps)
            if base is None:
                base = rate
            rows.append({"model_axis": n, "solves_per_s": round(rate, 1),
                         "vs_single": round(rate / base, 3)})
            print(json.dumps(rows[-1]), flush=True)
        print(json.dumps({
            "row_sharded": rows, "batch": args.batch,
            "platform": jax.devices()[0].platform,
            "note": ("single-process virtual devices validate the harness "
                     "and measure sharding overhead, not ICI"
                     if jax.devices()[0].platform == "cpu" else "hardware"),
        }))
        return

    n_avail = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
    rows = []
    base_rate_per_dev = None
    for n in sizes:
        rate = measure(n, args.per_device, args.steps)
        if base_rate_per_dev is None:
            base_rate_per_dev = rate
        eff = rate / (base_rate_per_dev * n)
        rows.append({"devices": n, "solves_per_s": round(rate, 1),
                     "efficiency": round(eff, 3)})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"scaling": rows, "per_device_batch": args.per_device,
                      "platform": jax.devices()[0].platform}))


if __name__ == "__main__":
    main()
