"""Tests for the explicit SPD inverse (ops/batched_linalg.py) and the
compensated (double-single) residual arithmetic used by the LMPC polish.

Reference context: OSQP's polish solves its active-set KKT systems with a
float64 sparse LDL factorization (osqp polish.c); this design reaches the
same accuracy class from float32 via exact-product splits and error-free
additions (ops/admm.py::_comp_mm) plus explicit small SPD inverses.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libmpc_tpu.ops import admm, batched_linalg


class TestSpdInverse:
    def _spd_batch(self, B, k, seed=0):
        rng = np.random.default_rng(seed)
        Q = rng.normal(size=(B, k, k)).astype(np.float32)
        return Q @ np.transpose(Q, (0, 2, 1)) / k + 0.5 * np.eye(
            k, dtype=np.float32
        )

    @pytest.mark.parametrize("k", [8, 24, 48, 96])
    def test_matches_numpy(self, k):
        C = self._spd_batch(5, k, seed=k)
        Ci = np.asarray(batched_linalg.spd_inverse(jnp.asarray(C)))
        ref = np.linalg.inv(C.astype(np.float64))
        assert Ci.dtype == np.float32
        assert np.abs(Ci - ref).max() < 1e-3 * np.abs(ref).max()

    def test_vmap_matches_batched_call(self):
        C = jnp.asarray(self._spd_batch(6, 24, seed=13))
        Cv = np.asarray(jax.vmap(batched_linalg.spd_inverse)(C))
        Cb = np.asarray(batched_linalg.spd_inverse(C))
        np.testing.assert_allclose(Cv, Cb, rtol=1e-5, atol=1e-6)


class TestCompensatedMatmul:
    def test_comp_mm_beats_plain_rounding(self):
        rng = np.random.default_rng(1)
        X = rng.normal(size=(64, 96)).astype(np.float32)
        M = rng.normal(size=(96, 80)).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            hi, lo = admm._comp_mm(jnp.asarray(X), jnp.asarray(M))
            plain = jnp.asarray(X) @ jnp.asarray(M)
        truth = X.astype(np.float64) @ M.astype(np.float64)
        comp = np.asarray(hi).astype(np.float64) + np.asarray(lo).astype(
            np.float64
        )
        err_comp = np.abs(comp - truth).max()
        err_plain = np.abs(np.asarray(plain) - truth).max()
        assert err_comp < err_plain
        # compensation target: ~eps-level of the TERM scale, well under the
        # plain accumulation error
        assert err_comp < 5e-6

    def test_two_sum_is_error_free(self):
        a = jnp.asarray(np.float32(1.0))
        b = jnp.asarray(np.float32(3e-8))
        s, e = admm._two_sum(a, b)
        # s + e reproduces the exact sum of the float32 inputs in double
        assert float(s) + float(e) == float(a) + float(b)

    def test_split_heads_are_bf16_exact(self):
        x = jnp.asarray(np.float32(1.2345678))
        hi, lo = admm._split12(x)
        # head survives a bfloat16 round trip unchanged
        assert float(jnp.asarray(hi).astype(jnp.bfloat16).astype(jnp.float32)) == float(hi)
        assert float(hi) + float(lo) == pytest.approx(1.2345678, abs=1e-7)


class TestPolishAccuracy:
    def test_f32_polish_reaches_data_floor(self):
        """Random equality-constrained QP: the float32 shared polish must
        land ~10x under the 1e-4-class plain-f32 stall."""
        rng = np.random.default_rng(7)
        n, me, B = 24, 10, 4
        Q = rng.normal(size=(n, n))
        P = (Q @ Q.T / n + 0.5 * np.eye(n)).astype(np.float32)
        A = np.concatenate(
            [rng.normal(size=(me, n)), np.eye(n)], axis=0
        ).astype(np.float32)
        m = me + n
        q = rng.normal(size=(B, n)).astype(np.float32)
        be = rng.normal(size=(B, me)).astype(np.float32) * 0.1
        l = np.concatenate([be, -5 * np.ones((B, n))], axis=1).astype(np.float32)
        u = np.concatenate([be, 5 * np.ones((B, n))], axis=1).astype(np.float32)
        eq = jnp.arange(m) < me
        from libmpc_tpu.types import LParameters

        par = LParameters(maximum_iteration=500, polish=True,
                          polish_mode="shared", rho=0.1)
        sol = jax.vmap(
            lambda qq, ll, uu: admm.admm_solve(
                jnp.asarray(P), jnp.asarray(A), qq, ll, uu, par, eq_mask=eq
            ),
            in_axes=(0, 0, 0),
        )(jnp.asarray(q), jnp.asarray(l), jnp.asarray(u))
        # f64 reference by KKT solve on the equality-active set (bounds are
        # not active at these scales)
        for b in range(B):
            K = np.block([
                [P.astype(np.float64), A[:me].T.astype(np.float64)],
                [A[:me].astype(np.float64), np.zeros((me, me))],
            ])
            rhs = np.concatenate([-q[b].astype(np.float64), be[b].astype(np.float64)])
            xs = np.linalg.solve(K, rhs)[:n]
            err = np.abs(np.asarray(sol.x)[b] - xs).max()
            assert err < 2e-5, (b, err)
