"""Analytic FLOP and byte models for the benchmark sections.

These models count the *useful algorithm FLOPs* of each solver's dominant
dense-algebra terms (matmul-level operations; elementwise vector work and
control flow excluded), so ``tflops = flops / time`` is a lower bound on
the sustained rate.  ``measure_matmul_peak`` and ``measure_hbm_peak`` time
a large float32 matmul at the solver's ``highest`` precision and a
streaming triad on the device at hand, the ceilings those rates are read
against.

Models (per instance, per iteration; B and measured iteration counts
multiply in the caller):

* ADMM iteration (ops/admm.py::one_iteration, shared KKT inverse):
  rhs build ``(rho z - y) @ A`` = 2mn, x-update ``rhs @ Minv`` = 2n^2,
  refinement pass (x_refine) ``xt @ M`` + ``· @ Minv`` = 4n^2,
  ``xt @ A.T`` = 2mn  ->  4mn + 6n^2 (+2n^2 without refine).
* ADMM termination check (every check_termination iterations):
  Ax, Px, A'y, A'dy, P dx, A dx ~ 6 matvecs -> 8mn + 4n^2 (counted via
  iters/check_every).
* Banded-IPM SQP iteration (ops/trajectory_kkt.py, per inner-IPM
  iteration): Gram assembly 6·mi·bs_p^2·ph, stage factorization
  ~14·ph·bs^3 (two SPD inverses + block products per stage), 3 solve
  sweeps ~12·ph·bs^2·(2+w), residual matvecs 4·(me+mi)·nz.
* SQP outer iteration extras: exact Jacobians by forward-mode over nz
  tangents ~ 2·nz·(me+mi)·c_model with c_model ~ 3 ops per output
  (tracking-cost/polynomial models), line-search/merit ~ (me+mi)·nz.

The models are unit-tested for structural sanity
(tests/test_utils.py::TestRooflineModels).
"""

from __future__ import annotations


def admm_iter_flops(n: int, m: int, x_refine: bool = True) -> float:
    """FLOPs of one ADMM iteration for one instance (shared (n,n)/(m,n))."""
    base = 4.0 * m * n + 2.0 * n * n
    if x_refine:
        base += 4.0 * n * n
    return base


def admm_check_flops(n: int, m: int) -> float:
    """FLOPs of one termination check for one instance."""
    return 8.0 * m * n + 4.0 * n * n


def admm_solve_flops(n: int, m: int, iters: float, check_every: int,
                     x_refine: bool = True) -> float:
    """Useful FLOPs of one ADMM solve at a measured iteration count."""
    checks = max(iters / max(check_every, 1), 1.0)
    return iters * admm_iter_flops(n, m, x_refine) + checks * admm_check_flops(n, m)


def traj_ipm_iter_flops(ph: int, ch: int, nx: int, nu: int, mi: int) -> float:
    """FLOPs of one banded-IPM (Mehrotra) iteration for one instance."""
    bs_p = nx + nu
    bs = bs_p + nx
    w = nu + 2
    me = ph * nx
    nz = ph * nx + ch * nu + 1
    gram = 6.0 * mi * bs_p * bs_p * ph
    factor = 14.0 * ph * bs**3
    sweeps = 12.0 * ph * bs * bs * (2 + w)
    resid = 4.0 * (me + mi) * nz
    return gram + factor + sweeps + resid


def sqp_iter_flops(ph: int, ch: int, nx: int, nu: int, mi: int,
                   ipm_iters: float = 20.0) -> float:
    """FLOPs of one SQP iteration with the banded-IPM inner engine."""
    nz = ph * nx + ch * nu + 1
    me = ph * nx
    jac = 2.0 * nz * (me + mi) * 3.0
    merit = 2.0 * (me + mi) * nz
    return jac + merit + ipm_iters * traj_ipm_iter_flops(ph, ch, nx, nu, mi)


def fused_sqp_iter_flops(nz: int, me: int, mi: int,
                         admm_iters: float = 60.0) -> float:
    """FLOPs of one SQP iteration with the fused Pallas inner-ADMM engine
    (small problems): per inner iteration ~ 4 m_qp nz + 2 nz^2 plus one
    (nz,nz) factorization per subproblem."""
    m_qp = me + mi + nz
    inner = admm_iters * (4.0 * m_qp * nz + 2.0 * nz * nz)
    factor = (2.0 / 3.0) * nz**3 + 2.0 * m_qp * nz * nz  # chol + A'RA
    jac = 2.0 * nz * (me + mi) * 3.0
    return inner + factor + jac


# ---------------------------------------------------------------------------
# HBM-traffic (bytes) models — the second roofline axis (round-5 task #3).
#
# Counting rule: bytes of BATCHED (B, n)/(B, m) arrays crossing the HBM
# boundary at kernel/fusion boundaries, per instance per iteration, f32.
# Elementwise chains are assumed fused into their producing matmul's
# epilogue (XLA does this); every matmul boundary materializes its output.
# Shared (n,n)/(m,n) matrices are read once per GRID, amortized over the
# batch — negligible per instance at production batch sizes (<=1% at
# B=16384) and excluded.  The models are therefore *lower bounds* on true
# traffic (spills and non-fused epilogues add), matching the FLOP models'
# lower-bound convention: pct_hbm_peak is a floor on how close the kernel
# runs to its memory-bound light speed.
# ---------------------------------------------------------------------------


def admm_xla_iter_bytes(n: int, m: int, x_refine: bool = True,
                        itemsize: int = 4) -> float:
    """HBM bytes of one XLA-path ADMM iteration for one instance.

    Op-by-op (ops/admm.py::one_iteration): rhs build reads z,y,x,q writes
    rhs (2m+3n+n); x-update reads rhs writes xt (2n); zt=xt@A' reads xt
    writes zt (n+m); z/y/x epilogue reads zt,z,y,l,u,xt,x writes x,z,y
    (5m+2n + n+2m).  Refinement adds xt@M and the correction matmul
    (reads 3n, writes 2n).
    """
    floats = 10.0 * m + 14.0 * n
    if x_refine:
        floats += 5.0 * n
    return itemsize * floats


def admm_check_bytes(n: int, m: int, itemsize: int = 4) -> float:
    """HBM bytes of one termination check for one instance (XLA ops).

    Three matvecs materialize Ax, Px, Aty (reads 2n+m, writes 2n+m); the
    residual/certificate pass reads Ax,z,Px,q,Aty,l,u,x,y,x_prev,y_prev
    and the infeasibility matvecs add Adx/Atdy/Pdx traffic — counted as
    ~12m + 10n reads and ~4m + 5n writes.
    """
    return itemsize * (16.0 * m + 15.0 * n)


def admm_solve_bytes(n: int, m: int, iters: float, check_every: int,
                     x_refine: bool = True) -> float:
    """HBM bytes of one ADMM solve at a measured iteration count."""
    checks = max(iters / max(check_every, 1), 1.0)
    return (iters * admm_xla_iter_bytes(n, m, x_refine)
            + checks * admm_check_bytes(n, m))


def _time_per_call(fn, arg, reps: int) -> float:
    """Seconds per call of a jitted ``fn(arg)``, warmed up, timed to
    ``block_until_ready`` over ``reps`` back-to-back calls."""
    import time

    import jax

    jax.block_until_ready(fn(arg))
    t0 = time.perf_counter()
    out = arg
    for _ in range(reps):
        out = fn(out)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def measure_hbm_peak(size_mb: int = 256, reps: int = 20) -> float:
    """Sustained device-memory bandwidth (GB/s) of a streaming triad
    ``out = b + 0.5*out``: read out, read b, write out per call."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    n = size_mb * 1024 * 1024 // 4
    rng = np.random.default_rng(99)
    b = jnp.asarray(rng.normal(size=(n,)).astype(np.float32))
    out0 = jnp.asarray(rng.normal(size=(n,)).astype(np.float32))
    triad = jax.jit(lambda out: b + 0.5 * out)
    return 3.0 * n * 4 / _time_per_call(triad, out0, reps) / 1e9


def measure_matmul_peak(dtype_str: str = "float32", size: int = 4096,
                        reps: int = 10) -> float:
    """Sustained TFLOP/s of a large square matmul at the solver's
    ``highest`` precision (IEEE float32 on a GPU, no TF32)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(12345)
    a = jnp.asarray(rng.normal(size=(size, size)) / np.sqrt(size), dtype_str)
    b = jnp.asarray(rng.normal(size=(size, size)) / np.sqrt(size), dtype_str)

    @jax.jit
    def mm(x):
        with jax.default_matmul_precision("highest"):
            return x @ b

    return 2.0 * size**3 / _time_per_call(mm, a, reps) / 1e12
