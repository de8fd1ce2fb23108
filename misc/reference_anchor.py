"""Reference CPU anchor measurements.

BASELINE.md's protocol asks for the reference binary's own profiler stats as
the CPU anchor.  The reference cannot be built in this environment: its
dependency bootstrap requires network access (``/root/reference/configure.sh``
apt-installs Eigen and git-clones NLopt + OSQP v0.6.3) and none of Eigen /
OSQP / NLopt / pybind11 are present on the system (verified: no matches in
``/usr/include`` or ``dpkg -l``).  This script records the closest honest
stand-ins, on the same machine, single-threaded, double precision:

* **LMPC anchor** — the quadrotor QP (identical matrices to
  examples/quadrotor_ex.cpp) solved by the independent native C++ dense ADMM
  oracle (``native/qp_oracle.cpp``), which implements the same OSQP v0.6.3
  algorithm (rho-scaled ADMM + polish) the reference drives.  Like the
  reference, the solver state is rebuilt every step (LOptimizer.hpp:261
  re-runs osqp_setup per solve).
* **NLMPC anchor** — the Van der Pol closed loop (identical formulation to
  examples/vanderpol_ex.cpp: trapezoidal defects, move blocking, u <= 0.5)
  solved by ``scipy.optimize.minimize(method="SLSQP")`` with finite-difference
  derivatives.  SciPy's SLSQP is Dieter Kraft's original Fortran code — the
  very algorithm NLopt's LD_SLSQP wraps (reference: NLOptimizer.hpp:64) — and
  FD derivatives match the reference's differentiation strategy
  (Objective.hpp:198-264, Constraints.hpp:844-905).

* **Oscillators anchor** — the networked-oscillators NLMPC closed loop
  (identical formulation to examples/networked_oscillators_ex.cpp at full
  size, nz=301) under the same SciPy SLSQP — the CPU-scale anchor for the
  bench's ``nlmpc_osc_solves_per_s`` section.

Writes ``BASELINE_ANCHOR.json`` at the repo root.

Usage:  python misc/reference_anchor.py
          [--qp-solves N] [--nl-loops N] [--osc-steps N] [--out PATH]
"""

import argparse
import json
import os
import platform
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def lmpc_anchor(n_solves: int) -> dict:
    """Quadrotor QP solved per-step by the native dense ADMM oracle."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
    from test_lmpc import make_quadrotor_controller
    from libmpc_tpu import native_qp
    from libmpc_tpu.lmpc import problem as qp
    import jax.numpy as jnp

    c = make_quadrotor_controller()
    dims = c.dims
    P, A, lineq, uineq = qp.build_time_invariant(dims, c._prob)
    x0 = jnp.zeros((dims.nx,), jnp.float64)
    u0 = jnp.zeros((dims.nu,), jnp.float64)
    q, l, u = qp.build_time_varying(
        dims, c._prob, lineq, uineq, x0, u0,
        c._y_ref, c._u_ref, c._du_ref, c._u_meas,
    )
    Pn, An, qn, ln, un = (np.asarray(a, np.float64) for a in (P, A, q, l, u))

    # warm-up + timing; eps matches the reference's LParameters defaults
    sol = native_qp.solve(Pn, An, qn, ln, un, eps_abs=1e-4, eps_rel=1e-4)
    assert sol.status in (1, 2), f"oracle status {sol.status}"
    t0 = time.perf_counter()
    for _ in range(n_solves):
        sol = native_qp.solve(Pn, An, qn, ln, un, eps_abs=1e-4, eps_rel=1e-4)
    dt = (time.perf_counter() - t0) / n_solves
    golden = np.array([-0.9916, 1.74839, -0.9916, 1.74839])
    # cmd = x_u of block 1 (input applied at step 0)
    nxu = dims.nxu
    cmd = sol.x[nxu + dims.nx : nxu + dims.nx + dims.nu]
    return {
        "problem": "quadrotor LMPC QP (n=%d, m=%d)" % (Pn.shape[0], An.shape[0]),
        "solver": "native dense ADMM oracle (OSQP v0.6.3 algorithm), f64, setup per solve",
        "per_solve_ms": round(dt * 1e3, 3),
        "solves_per_s": round(1.0 / dt, 1),
        "iters": sol.iters,
        "cmd_err_vs_golden": float(np.max(np.abs(cmd - golden))),
    }


def nlmpc_anchor(n_loops: int) -> dict:
    """Van der Pol NLMPC closed loop under SciPy SLSQP (= Kraft SLSQP, the
    algorithm inside NLopt LD_SLSQP) with FD derivatives."""
    from scipy.optimize import minimize

    ph, ch, nx, nu, ts = 10, 5, 2, 1, 0.1
    nz = ph * nx + ch * nu + 1

    def unpack(z):
        X = z[: ph * nx].reshape(ph, nx)
        U = z[ph * nx : ph * nx + ch * nu].reshape(ch, nu)
        idx = np.minimum(np.arange(ph), ch - 1)
        Ufull = U[idx]  # (ph, nu)
        return X, Ufull

    def fdyn(x, u):
        return np.array([x[1], (1.0 - x[0] ** 2) * x[1] - x[0] + u[0]])

    def defects(z, x0):
        X, U = unpack(z)
        Xall = np.vstack([x0, X])
        c = np.empty((ph, nx))
        h = ts / 2.0
        for k in range(ph):
            c[k] = (
                Xall[k]
                + h * (fdyn(Xall[k], U[k]) + fdyn(Xall[k + 1], U[k]))
                - Xall[k + 1]
            )
        return c.ravel()

    def cost(z, x0):
        X, U = unpack(z)
        Xall = np.vstack([x0, X])
        Uall = np.vstack([U, U[-1]])
        return float(np.sum(Xall**2) + np.sum(Uall**2))

    def ineq(z, x0):  # u <= 0.5 per step (vanderpol_ex.cpp:56-65) -> >= 0 form
        _, U = unpack(z)
        Uall = np.vstack([U, U[-1]])
        return 0.5 - Uall[:, 0]

    solve_times = []
    nit_total = 0
    n_success = 0
    for _ in range(n_loops):
        x = np.array([0.1, 0.1])
        z = np.zeros(nz)
        for step in range(40):
            t0 = time.perf_counter()
            res = minimize(
                cost, z, args=(x,), method="SLSQP",
                constraints=[
                    {"type": "eq", "fun": defects, "args": (x,)},
                    {"type": "ineq", "fun": ineq, "args": (x,)},
                ],
                options={"maxiter": 100, "ftol": 1e-6},
            )
            solve_times.append(time.perf_counter() - t0)
            nit_total += res.nit
            n_success += int(res.success)
            z = res.x
            u = z[ph * nx : ph * nx + 1]
            x = x + ts * fdyn(x, u)  # Euler plant step like the reference
            if np.max(np.abs(x)) < 0.01:
                break
    st = np.asarray(solve_times)
    return {
        "problem": "Van der Pol NLMPC (nz=%d, ph=%d, ch=%d), closed loop" % (nz, ph, ch),
        "solver": "scipy SLSQP (Kraft SLSQP = NLopt LD_SLSQP algorithm), FD derivatives",
        "per_solve_ms_mean": round(float(st.mean() * 1e3), 3),
        "per_solve_ms_min": round(float(st.min() * 1e3), 3),
        "solves_per_s": round(float(1.0 / st.mean()), 1),
        "n_solves": int(st.size),
        "slsqp_iters_mean": round(nit_total / st.size, 1),
        "success_frac": round(n_success / max(st.size, 1), 4),
        "final_state_max_abs": float(np.max(np.abs(x))),
    }


def oscillators_anchor(n_steps: int) -> dict:
    """Networked-oscillators NLMPC (the reference's largest example,
    examples/networked_oscillators_ex.cpp: 12 states / 6 inputs, ph=20,
    ch=10 -> nz=301) under SciPy SLSQP with FD derivatives — the CPU-scale
    anchor for the bench's ``nlmpc_osc_solves_per_s`` section."""
    from scipy.optimize import minimize

    N, mu, kcpl = 6, 1.0, 0.1
    ph, ch, nx, nu, ts = 20, 10, 2 * N, N, 0.1
    nz = ph * nx + ch * nu + 1

    def fdyn(x, u):
        pos, vel = x[0::2], x[1::2]
        coupling = kcpl * (np.sum(pos) - N * pos)
        dvel = mu * (1.0 - pos**2) * vel - pos + u + coupling
        dx = np.empty_like(x)
        dx[0::2] = vel
        dx[1::2] = dvel
        return dx

    def unpack(z):
        X = z[: ph * nx].reshape(ph, nx)
        U = z[ph * nx : ph * nx + ch * nu].reshape(ch, nu)
        idx = np.minimum(np.arange(ph), ch - 1)
        return X, U[idx]

    def defects(z, x0):
        X, U = unpack(z)
        Xall = np.vstack([x0, X])
        h = ts / 2.0
        c = np.empty((ph, nx))
        for k in range(ph):
            c[k] = (Xall[k] + h * (fdyn(Xall[k], U[k]) + fdyn(Xall[k + 1], U[k]))
                    - Xall[k + 1])
        return c.ravel()

    def cost(z, x0):
        X, U = unpack(z)
        Xall = np.vstack([x0, X])
        Uall = np.vstack([U, U[-1]])
        return float(np.sum(Xall**2) + np.sum(Uall**2))

    def ineq(z, x0):  # u <= 0.5 per entry -> >= 0 form
        _, U = unpack(z)
        Uall = np.vstack([U, U[-1]])
        return (0.5 - Uall).ravel()

    # instance 0 of the bench's inputs EXACTLY (bench._nlmpc_osc_bench:
    # seed-13 rng draws x0 of shape (B, nx) then per-step 0.01*normal process
    # noise of shape (K, B, nx); drawing at the bench's B and slicing row 0
    # reproduces the identical stream), so the anchor's warm-started closed
    # loop solves the same disturbed problem sequence the bench does
    bench_B = 256
    rng = np.random.default_rng(13)
    x = rng.uniform(-0.5, 0.5, size=(bench_B, nx))[0]
    noise = 0.01 * rng.normal(size=(n_steps, bench_B, nx))[:, 0]
    z = np.zeros(nz)
    solve_times = []
    nit_total = 0
    n_success = 0
    for step in range(n_steps):
        t0 = time.perf_counter()
        res = minimize(
            cost, z, args=(x,), method="SLSQP",
            constraints=[
                {"type": "eq", "fun": defects, "args": (x,)},
                {"type": "ineq", "fun": ineq, "args": (x,)},
            ],
            options={"maxiter": 100, "ftol": 1e-6},
        )
        solve_times.append(time.perf_counter() - t0)
        nit_total += res.nit
        n_success += int(res.success)
        z = res.x
        u = z[ph * nx : ph * nx + nu]
        x = x + ts * fdyn(x, u) + noise[step]
    st = np.asarray(solve_times)
    # a non-converged SLSQP solve would silently contaminate the anchor all
    # vs_reference_cpu ratios divide by — record the verdict alongside
    return {
        "problem": ("networked oscillators NLMPC (nz=%d, ph=%d, ch=%d), "
                    "closed loop" % (nz, ph, ch)),
        "solver": "scipy SLSQP (Kraft SLSQP = NLopt LD_SLSQP algorithm), FD derivatives",
        "per_solve_ms_mean": round(float(st.mean() * 1e3), 3),
        "per_solve_ms_min": round(float(st.min() * 1e3), 3),
        "solves_per_s": round(float(1.0 / st.mean()), 2),
        "n_solves": int(st.size),
        "slsqp_iters_mean": round(nit_total / st.size, 1),
        "success_frac": round(n_success / max(st.size, 1), 4),
        "final_state_max_abs": float(np.max(np.abs(x))),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--qp-solves", type=int, default=200)
    ap.add_argument("--nl-loops", type=int, default=2)
    ap.add_argument("--osc-steps", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "BASELINE_ANCHOR.json"))
    args = ap.parse_args()

    out = {
        "note": (
            "Reference binary not buildable here (configure.sh needs network: "
            "apt libeigen3-dev + git clones of NLopt/OSQP; none present on "
            "system). These are algorithm-equivalent single-threaded f64 CPU "
            "anchors on the same machine."
        ),
        "cpu": platform.processor() or platform.machine(),
        "nlmpc_vanderpol": nlmpc_anchor(args.nl_loops),
        "nlmpc_oscillators": oscillators_anchor(args.osc_steps),
        "lmpc_quadrotor": lmpc_anchor(args.qp_solves),
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
        fh.write("\n")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
