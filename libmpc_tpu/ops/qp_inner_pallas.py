"""Fused batched small-QP ADMM solver — one Pallas (Triton) kernel per solve.

The SQP inner QP (ops/sqp.py) is a *per-instance* problem: every batch
element has its own Hessian ``P`` and constraint matrix ``A`` (tens of rows
and columns).  The XLA path (``vmap`` of :func:`ops.admm.admm_solve`) runs
each of its hundreds of lockstep iterations as several small kernels over
the whole batch, and the batch iterates until its slowest instance
converges.  This module runs the ENTIRE solve — KKT assembly, explicit
inverse, the ADMM iteration loop with periodic convergence checks and
adaptive rho — inside one GPU kernel.

Layout: batch axis leading, ``tile`` instances per program.  Every matrix
is padded to power-of-two widths (Triton's block rule) and stays in
registers for the whole solve; nothing is carried between programs, so
programs run in any order and each one stops as soon as its own instances
have converged.  Matrix rows and columns are selected with masked
reductions (Triton has no register indexing), and all arithmetic is
float32 multiply-and-reduce: no tensor-core (TF32) rounding enters.
Division is Triton's float32 ``div.full`` (within 2 ulp); an IEEE
``div.rn``/``sqrt.rn`` build was slower on the card and converged no more
often (PERF.md).

Algorithm (identical to ops/admm.py's ``one_iteration`` and the adaptive
rho of its ``termination_check``, reference OSQP v0.6.3 / LOptimizer.hpp):
x-update through the explicit KKT inverse with one refinement pass,
over-relaxation ``alpha``, box projection, exact-zero inactive duals, and a
scalar rho per instance inside the float32 bounds of ``admm._rho_bounds``,
expanded to rows as ``admm._rho_vec_of`` does (equality rows boosted, loose
rows at the minimum).  The inverse is an in-place Gauss-Jordan sweep, which
needs no pivoting on the SPD KKT matrix.  Ruiz equilibration runs once per
problem in XLA before the kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .admm import (
    ADAPTIVE_RHO_TOLERANCE, INF_BOUND, RHO_EQ_OVER_RHO_INEQ, RHO_MIN,
    _ruiz_equilibration,
)

# float32 rho bounds of ops/admm.py's _rho_bounds
_RHO_LO, _RHO_HI = 1e-3, 1e3
# instances per program and warps per program, chosen on the card at the
# Van der Pol widths: one instance on one warp was fastest of (1, 1),
# (1, 2), (1, 4), (2, 2), (2, 4), (4, 4), (4, 8) (PERF.md)
TILE_B = 1
NUM_WARPS = 1
# register budget: M, Minv, P and A of every instance stay resident for the
# whole solve; past these padded widths the kernel spills
_MAX_N, _MAX_M = 32, 64


def _pow2(k: int) -> int:
    return 1 << max(k - 1, 0).bit_length()


def supported(n: int, m: int) -> bool:
    """Whether the fused kernel takes an (n, m) subproblem (padded widths
    within the register budget).  Larger problems use an XLA engine."""
    return _pow2(n) <= _MAX_N and _pow2(m) <= _MAX_M


def _kernel(
    P_ref, A_ref, q_ref, l_ref, u_ref, loose_ref, x0_ref, y0_ref,
    dinv_ref, einv_ref, cinv_ref,
    x_out, y_out, z_out, meta_out,
    *, n_eq, rho, sigma, alpha, eps_abs, eps_rel, n_blocks, check_every,
    refine,
):
    f1 = jnp.float32
    P = P_ref[...]  # (T, n, n)
    A = A_ref[...]  # (T, m, n)
    q = q_ref[...]  # (T, n)
    lo = l_ref[...]  # (T, m)
    hi = u_ref[...]
    dinv = dinv_ref[...]
    einv = einv_ref[...]
    cinv = cinv_ref[...]  # (T, 1)
    loose = loose_ref[...] > 0.5  # (T, m)
    T, m, n = A.shape
    i_n = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)
    i_m = jax.lax.broadcasted_iota(jnp.int32, (1, m), 1)
    row_n = jax.lax.broadcasted_iota(jnp.int32, (1, n, n), 1)
    col_n = jax.lax.broadcasted_iota(jnp.int32, (1, n, n), 2)
    row_m = jax.lax.broadcasted_iota(jnp.int32, (1, m, n), 1)
    eye = (row_n == col_n).astype(f1)

    def rho_vec_of(rs):  # (T, 1) per-instance rho -> (T, m) row penalties
        rv = jnp.where(i_m < n_eq, RHO_EQ_OVER_RHO_INEQ * rs, rs)
        return jnp.where(loose, RHO_MIN, rv)

    def mv(Mat, v):  # (T, r, c) @ (T, c) -> (T, r)
        return jnp.sum(Mat * v[:, None, :], axis=2)

    def tmv(Mat, v):  # (T, r, c)' @ (T, r) -> (T, c)
        return jnp.sum(Mat * v[:, :, None], axis=1)

    def amax(v):
        return jnp.max(jnp.abs(v), axis=1, keepdims=True)

    def factorize(rho):
        """M = P + sigma I + A' diag(rho) A and its explicit inverse."""

        def add_row(r, M):
            a_r = jnp.sum(jnp.where(row_m == r, A, 0.0), axis=1)  # (T, n)
            rho_r = jnp.sum(jnp.where(i_m == r, rho, 0.0), axis=1, keepdims=True)
            return M + (rho_r * a_r)[:, :, None] * a_r[:, None, :]

        M = jax.lax.fori_loop(0, m, add_row, P + sigma * eye)

        def sweep(k, a):
            # in-place Gauss-Jordan step on pivot k (SPD: no pivoting)
            rk = row_n == k
            ck = col_n == k
            row = jnp.sum(jnp.where(rk, a, 0.0), axis=1)  # a[:, k, :]
            col = jnp.sum(jnp.where(ck, a, 0.0), axis=2)  # a[:, :, k]
            piv = jnp.sum(jnp.where(i_n == k, row, 0.0), axis=1, keepdims=True)
            r_k = jnp.where(i_n == k, 1.0, row) / piv
            f_k = jnp.where(i_n == k, 0.0, col)
            a = jnp.where(ck, 0.0, a) - f_k[:, :, None] * r_k[:, None, :]
            return jnp.where(rk, r_k[:, None, :], a)

        return M, jax.lax.fori_loop(0, n, sweep, M)

    def block(c):
        k, x, z, y, rs, M, Minv, done, iters, pri, dua = c
        act = done == 0
        rho = rho_vec_of(rs)

        def one_iter(_, xzy):
            x, z, y = xzy
            rhs = sigma * x - q + tmv(A, rho * z - y)
            xt = mv(Minv, rhs)
            if refine:
                xt = xt + mv(Minv, rhs - mv(M, xt))
            zt = mv(A, xt)
            x_new = alpha * xt + (1.0 - alpha) * x
            z_relax = alpha * zt + (1.0 - alpha) * z
            z_unc = z_relax + y / rho
            z_new = jnp.minimum(jnp.maximum(z_unc, lo), hi)
            clipped = (z_unc < lo) | (z_unc > hi)
            y_new = jnp.where(clipped, y + rho * (z_relax - z_new), 0.0)
            return (
                jnp.where(act, x_new, x), jnp.where(act, z_new, z),
                jnp.where(act, y_new, y),
            )

        x, z, y = jax.lax.fori_loop(0, check_every, one_iter, (x, z, y))
        # convergence check on UNSCALED residuals (OSQP semantics): the
        # iteration runs on the Ruiz-scaled problem, the stopping test
        # multiplies back by D^-1 / E^-1 / c^-1
        Ax = einv * mv(A, x)
        Px = dinv * mv(P, x)
        Aty = dinv * tmv(A, y)
        ez = einv * z
        dq = dinv * q
        pri = amax(Ax - ez)
        dua = cinv * amax(Px + dq + Aty)
        pri_rel = jnp.maximum(amax(Ax), amax(ez))
        dua_rel = cinv * jnp.maximum(jnp.maximum(amax(Px), amax(Aty)), amax(dq))
        conv = (pri <= eps_abs + eps_rel * pri_rel) & (
            dua <= eps_abs + eps_rel * dua_rel
        )
        iters = iters + jnp.where(act, check_every, 0)
        # adaptive rho (OSQP 5.2), as admm.termination_check: the
        # per-instance estimate rho * sqrt(scaled primal / scaled dual
        # residual), clipped to the float32 bounds; refactor only when some
        # active, unconverged instance moves by more than the tolerance
        ratio = jnp.sqrt(jnp.clip(
            (pri / jnp.maximum(pri_rel, 1e-12))
            / jnp.maximum(dua / jnp.maximum(dua_rel, 1e-12), 1e-12),
            1e-10, 1e10,
        ))
        ratio = jnp.where(ratio == ratio, ratio, 1.0)  # NaN -> 1
        rho_est = jnp.clip(rs * ratio, _RHO_LO, _RHO_HI)
        adapt = act & ~conv & (
            (rho_est > rs * ADAPTIVE_RHO_TOLERANCE)
            | (rho_est < rs / ADAPTIVE_RHO_TOLERANCE)
        )

        def refactor(ops):
            rs, _, _ = ops
            rs = jnp.where(adapt, rho_est, rs)
            M, Minv = factorize(rho_vec_of(rs))
            return rs, M, Minv

        rs, M, Minv = jax.lax.cond(
            jnp.max(adapt.astype(jnp.int32)) > 0, refactor, lambda ops: ops,
            (rs, M, Minv),
        )
        done = jnp.where(conv, 1, done)
        return k + 1, x, z, y, rs, M, Minv, done, iters, pri, dua

    def cond(c):
        k, done = c[0], c[7]
        return (k < n_blocks) & (jnp.min(done) == 0)

    rs = jnp.full((T, 1), min(max(rho, _RHO_LO), _RHO_HI), f1)
    M, Minv = factorize(rho_vec_of(rs))
    x = x0_ref[...]
    y = y0_ref[...]
    zero = jnp.zeros((T, 1), f1)
    init = (
        jnp.int32(0), x, mv(A, x), y, rs, M, Minv,
        jnp.zeros((T, 1), jnp.int32), jnp.zeros((T, 1), jnp.int32), zero, zero,
    )
    _, x, z, y, _, _, _, done, iters, pri, dua = jax.lax.while_loop(
        cond, block, init
    )
    x_out[...] = x
    y_out[...] = y
    z_out[...] = z
    i4 = jax.lax.broadcasted_iota(jnp.int32, (1, 4), 1)
    meta_out[...] = jnp.where(
        i4 == 0, iters.astype(f1),
        jnp.where(i4 == 1, done.astype(f1), jnp.where(i4 == 2, pri, dua)),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_eq", "rho", "sigma", "alpha", "eps_abs", "eps_rel", "max_iter",
        "check_every", "refine", "ruiz_iters", "tile", "num_warps",
        "interpret",
    ),
)
def solve_batched(
    P, A, q, l, u, x0, y0,
    *, n_eq=0, rho=0.1, sigma=1e-5, alpha=1.6, eps_abs=5e-6, eps_rel=5e-6,
    max_iter=500, check_every=25, refine=True, ruiz_iters=10,
    tile=TILE_B, num_warps=NUM_WARPS, interpret=False,
):
    """Solve a batch of small dense QPs in one fused kernel.

    Args (batch axis leading): P (B,n,n), A (B,m,n), q (B,n), l/u (B,m),
    warm starts x0 (B,n), y0 (B,m) — all UNSCALED.  The first ``n_eq``
    rows are equalities; ``rho`` is the initial penalty.  Ruiz
    equilibration runs here in XLA (once per problem, batched ops), the
    kernel iterates on the scaled problem and applies the stopping test to
    unscaled residuals, and the returned (x, y, z, iters, done, pri, dua)
    are unscaled with the batch axis leading.

    The kernel compiles for the GPU through Triton; ``interpret=True`` runs
    it in the Pallas interpreter instead (tests on the CPU).
    """
    B, n = q.shape
    m = A.shape[1]
    dtype = jnp.float32
    P = P.astype(dtype)
    A = A.astype(dtype)
    q = q.astype(dtype)
    if ruiz_iters > 0:
        d, e, c = jax.vmap(
            lambda Pb, Ab, qb: _ruiz_equilibration(Pb, Ab, qb, ruiz_iters)
        )(P, A, q)
    else:
        d = jnp.ones((B, n), dtype)
        e = jnp.ones((B, m), dtype)
        c = jnp.ones((B,), dtype)
    cb = c[:, None]
    P = cb[:, :, None] * P * d[:, None, :] * d[:, :, None]
    A = A * e[:, :, None] * d[:, None, :]
    q = cb * q * d
    l = e * jnp.maximum(l.astype(dtype), -INF_BOUND)
    loose = ((l <= -INF_BOUND) & (u >= INF_BOUND)).astype(dtype)
    u = e * jnp.minimum(u.astype(dtype), INF_BOUND)
    # warm starts into scaled space: xbar = x/d, ybar = c*y/e
    x0 = x0.astype(dtype) / d
    y0 = cb * y0.astype(dtype) / e
    dinv = 1.0 / d
    einv = 1.0 / e
    cinv = (1.0 / c)[:, None]

    # pad the widths to powers of two: padded variables get a unit diagonal
    # and no constraint coupling (they stay exactly zero), padded rows are
    # empty equalities 0 <= 0 <= 0 with zero duals
    n_p, m_p = _pow2(n), _pow2(m)
    dn, dm = n_p - n, m_p - m
    P = jnp.pad(P, ((0, 0), (0, dn), (0, dn)))
    P = P + jnp.diag(jnp.arange(n_p) >= n).astype(dtype)
    A = jnp.pad(A, ((0, 0), (0, dm), (0, dn)))
    q, x0, dinv_p = (
        jnp.pad(v, ((0, 0), (0, dn)), constant_values=cv)
        for v, cv in ((q, 0.0), (x0, 0.0), (dinv, 1.0))
    )
    l, u, y0, loose = (jnp.pad(v, ((0, 0), (0, dm))) for v in (l, u, y0, loose))
    einv_p = jnp.pad(einv, ((0, 0), (0, dm)), constant_values=1.0)

    # pad the batch to whole tiles by edge-replicating the last instance, so
    # pad lanes solve a well-posed problem and converge with their tile
    Bp = -(-B // tile) * tile
    args = [P, A, q, l, u, loose, x0, y0, dinv_p, einv_p, cinv]
    if Bp > B:
        args = [
            jnp.concatenate(
                [a, jnp.broadcast_to(a[-1:], (Bp - B,) + a.shape[1:])]
            )
            for a in args
        ]

    def spec(*shape):
        return pl.BlockSpec(
            (tile,) + shape, lambda i, _k=len(shape): (i,) + (0,) * _k
        )

    kern = functools.partial(
        _kernel, n_eq=int(n_eq), rho=float(rho), sigma=float(sigma),
        alpha=float(alpha),
        eps_abs=float(eps_abs), eps_rel=float(eps_rel),
        n_blocks=max(1, -(-int(max_iter) // int(check_every))),
        check_every=int(check_every), refine=bool(refine),
    )
    x_o, y_o, z_o, meta = pl.pallas_call(
        kern,
        grid=(Bp // tile,),
        in_specs=[
            spec(n_p, n_p), spec(m_p, n_p), spec(n_p), spec(m_p), spec(m_p),
            spec(m_p), spec(n_p), spec(m_p), spec(n_p), spec(m_p), spec(1),
        ],
        out_specs=(spec(n_p), spec(m_p), spec(m_p), spec(4)),
        out_shape=(
            jax.ShapeDtypeStruct((Bp, n_p), dtype),
            jax.ShapeDtypeStruct((Bp, m_p), dtype),
            jax.ShapeDtypeStruct((Bp, m_p), dtype),
            jax.ShapeDtypeStruct((Bp, 4), dtype),
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="qp_inner_admm",
    )(*args)

    x_o, y_o, z_o, meta = x_o[:B, :n], y_o[:B, :m], z_o[:B, :m], meta[:B]
    # unscale: x = D xbar, z = E^-1 zbar, y = E ybar / c
    x_o = x_o * d
    z_o = z_o * einv
    y_o = y_o * e * cinv
    iters = meta[:, 0].astype(jnp.int32)
    done = meta[:, 1] > 0.5
    return x_o, y_o, z_o, iters, done, meta[:, 2], meta[:, 3]


@functools.lru_cache(maxsize=None)
def make_inner_qp_solver(
    n_eq=0, rho=0.1, sigma=1e-5, alpha=1.6, eps_abs=5e-6, eps_rel=5e-6,
    max_iter=500, check_every=25, interpret=False,
):
    """A per-instance QP solve whose ``vmap`` is the fused batched kernel.

    The SQP driver (ops/sqp.py) is written per-instance and batched with an
    outer ``vmap``; ``jax.custom_batching.custom_vmap`` lets that vmap (and
    the batched ``while_loop`` body it produces) dispatch the whole inner-QP
    batch to ONE :func:`solve_batched` kernel call instead of hundreds of
    tiny lockstep XLA ops.  The unbatched call path runs the same kernel on
    a batch of one, so batched and unbatched numerics are identical.
    """
    kw = dict(
        n_eq=n_eq, rho=rho, sigma=sigma, alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
        max_iter=max_iter, check_every=check_every, interpret=interpret,
    )

    @jax.custom_batching.custom_vmap
    def solve(P, A, q, l, u, x0, y0):
        outs = solve_batched(
            P[None], A[None], q[None], l[None], u[None], x0[None], y0[None],
            **kw,
        )
        return tuple(o[0] for o in outs)

    @solve.def_vmap
    def _solve_vmap(axis_size, in_batched, *args):
        args = tuple(
            a if b else jnp.broadcast_to(a[None], (axis_size,) + a.shape)
            for a, b in zip(args, in_batched)
        )
        outs = solve_batched(*args, **kw)
        return tuple(outs), tuple(True for _ in outs)

    return solve
