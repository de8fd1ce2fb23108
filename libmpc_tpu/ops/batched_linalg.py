"""Explicit inverse of small SPD matrices.

Several solvers keep an explicit inverse instead of a factor, so that every
later solve is one matrix product: the ADMM KKT inverse (ops/admm.py), the
f32 interior-point Newton systems (ops/pdip.py), the stage pivots of the
banded KKT factorization (ops/trajectory_kkt.py) and the shared polish's
capacitance systems.  Leading axes are batch axes; under ``vmap`` XLA lowers
the Cholesky factor and the two triangular solves to batched GPU routines.
"""

from __future__ import annotations

import jax.numpy as jnp
import jax.scipy.linalg as jsl


def spd_inverse(M):
    """Inverse of the SPD matrix (or batch of matrices) ``M`` (..., k, k)."""
    eye = jnp.broadcast_to(jnp.eye(M.shape[-1], dtype=M.dtype), M.shape)
    return jsl.cho_solve(jsl.cho_factor(M), eye)
