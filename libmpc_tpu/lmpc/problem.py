"""Linear MPC QP assembly.

Builds the same sparse/simultaneous QP as the reference's ``ProblemBuilder``
(reference: include/mpc/LMPC/ProblemBuilder.hpp:70-76, 642-822), expressed as
dense block operations over jnp arrays so the whole assembly lives inside the
jitted solve and batches trivially.

Formulation (identical to the reference):

* The state is augmented with the previous input, ``x_aug = [x; x_u]`` with
  ``x_u(k) = u(k-1)``, so the QP input is the *increment* ``du``
  (ProblemBuilder.hpp:190-209)::

      ssA = [[A, B], [0, I]]   ssB = [[B], [I]]   ssC = [[C, 0], [0, I]]

* Decision vector ``z = [x_aug_0 .. x_aug_ph ; du_0 .. du_{ph-1}]`` of length
  ``(ph+1)(nx+nu) + ph*nu`` (ProblemBuilder.hpp:70-76).
* Constraint rows, in order (ProblemBuilder.hpp:704-822):
  dynamics equalities | box on x_aug | output rows ``C x`` | du box |
  scalar constraint.

Data layout note: unlike the reference's (feature, time) Eigen matrices, all
horizon-dependent quantities here are *time-major* ``(ph+1, feature)`` arrays,
the natural layout for ``lax.scan``/``vmap`` and for batched updates.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def _highest_matmul(fn):
    """Run the assembly at full float32 matmul precision.

    Default-precision float32 matmuls may round through reduced-precision
    passes (TF32 on a GPU); letting the QP *data* round at ~1e-4 relative
    puts an irreducible kappa-sized error in every solution no matter how
    well the solver does (the quadrotor golden command error then floors
    at ~1e-4 from the P assembly alone)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped

from ..dims import LDims
from ..types import default_dtype, inf


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LProblemData:
    """Time-invariant data of the linear MPC problem (functional state).

    Mirrors the mutable fields of ``ProblemBuilder``
    (reference: include/mpc/LMPC/ProblemBuilder.hpp:826-857) as an immutable
    pytree; setters in the controller produce updated copies.

    Index-0 convention: slots ``[0]`` of the (ph+1)-length arrays correspond
    to the initial-state row and are kept equal to slot ``[1]`` by the
    controller's setters, matching the reference's column-0 duplication
    (ProblemBuilder.hpp:254-262).
    """

    # augmented state-space model
    ssA: jax.Array  # (nxu, nxu)
    ssB: jax.Array  # (nxu, nu)
    ssC: jax.Array  # (ny+nu, nxu)
    ssBv: jax.Array  # (nxu, ndu)
    ssDv: jax.Array  # (ny+nu, ndu)
    # objective weights, time-major
    w_out: jax.Array  # (ph+1, ny)
    w_u: jax.Array  # (ph+1, nu)
    w_du: jax.Array  # (ph, nu)
    # box bounds, time-major
    min_x: jax.Array  # (ph+1, nx)
    max_x: jax.Array
    min_y: jax.Array  # (ph+1, ny)
    max_y: jax.Array
    min_u: jax.Array  # (ph, nu)
    max_u: jax.Array
    # scalar constraint
    s_min: jax.Array  # (ph+1,)
    s_max: jax.Array  # (ph+1,)
    s_mult: jax.Array  # (nxu,) single [X; U] row replicated per step


def init_problem(dims: LDims, dtype=None) -> LProblemData:
    """Default-initialized problem: zero model/weights, +-inf bounds
    (reference: include/mpc/LMPC/ProblemBuilder.hpp:120-149)."""
    dtype = dtype or default_dtype()
    nxu = dims.nxu
    z = lambda *s: jnp.zeros(s, dtype)
    full = lambda v, *s: jnp.full(s, v, dtype)
    return LProblemData(
        ssA=z(nxu, nxu),
        ssB=z(nxu, dims.nu),
        ssC=z(dims.ny + dims.nu, nxu),
        ssBv=z(nxu, dims.ndu),
        ssDv=z(dims.ny + dims.nu, dims.ndu),
        w_out=z(dims.ph + 1, dims.ny),
        w_u=z(dims.ph + 1, dims.nu),
        w_du=z(dims.ph, dims.nu),
        min_x=full(-inf, dims.ph + 1, dims.nx),
        max_x=full(inf, dims.ph + 1, dims.nx),
        min_y=full(-inf, dims.ph + 1, dims.ny),
        max_y=full(inf, dims.ph + 1, dims.ny),
        min_u=full(-inf, dims.ph, dims.nu),
        max_u=full(inf, dims.ph, dims.nu),
        s_min=full(-inf, dims.ph + 1),
        s_max=full(inf, dims.ph + 1),
        s_mult=z(nxu),
    )


def make_augmented_model(A, B, C):
    """Augment (A, B, C) with the input-memory states
    (reference: include/mpc/LMPC/ProblemBuilder.hpp:190-209)."""
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    C = jnp.asarray(C)
    nx, nu = B.shape
    ny = C.shape[0]
    dtype = A.dtype
    ssA = jnp.block(
        [
            [A, B],
            [jnp.zeros((nu, nx), dtype), jnp.eye(nu, dtype=dtype)],
        ]
    )
    ssB = jnp.concatenate([B, jnp.eye(nu, dtype=dtype)], axis=0)
    ssC = jnp.block(
        [
            [C, jnp.zeros((ny, nu), dtype)],
            [jnp.zeros((nu, nx), dtype), jnp.eye(nu, dtype=dtype)],
        ]
    )
    return ssA, ssB, ssC


def make_disturbance_model(Bd, Dd, nu: int):
    """Lift disturbance maps into the augmented space
    (reference: include/mpc/LMPC/ProblemBuilder.hpp:222-236)."""
    Bd = jnp.asarray(Bd)
    Dd = jnp.asarray(Dd)
    ndu = Bd.shape[1]
    ssBv = jnp.concatenate([Bd, jnp.zeros((nu, ndu), Bd.dtype)], axis=0)
    ssDv = jnp.concatenate([Dd, jnp.zeros((nu, ndu), Dd.dtype)], axis=0)
    return ssBv, ssDv


@_highest_matmul
def build_time_invariant(
    dims: LDims, prob: LProblemData
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Assemble P, A and the static inequality bounds.

    Mirrors ``buildTimeInvariantTems``
    (reference: include/mpc/LMPC/ProblemBuilder.hpp:642-822).  Returns
    ``(P, A, lineq, uineq)`` where lineq/uineq cover only the inequality rows
    (the equality RHS is time-varying).
    """
    ph, ch = dims.ph, dims.ch
    nx, nu, ny = dims.nx, dims.nu, dims.ny
    nxu = dims.nxu
    dtype = prob.ssA.dtype

    # -- P: per-step ssC' W ssC blocks + du weights ----------------------
    # W_i = diag([w_out_i; w_u_i])  (ProblemBuilder.hpp:651-667)
    w_ext = jnp.concatenate([prob.w_out, prob.w_u], axis=1)  # (ph+1, ny+nu)
    # blocks_i = ssC' diag(w_i) ssC, vmapped over the horizon
    blocks = jax.vmap(lambda w: prob.ssC.T @ (w[:, None] * prob.ssC))(w_ext)
    P = jnp.zeros((dims.nz, dims.nz), dtype)
    # scatter diagonal blocks via block-diag construction
    P = P.at[: dims.n_aug, : dims.n_aug].set(
        jax.scipy.linalg.block_diag(*[blocks[i] for i in range(ph + 1)])
    )
    P = P.at[dims.n_aug :, dims.n_aug :].set(
        jnp.diag(prob.w_du.reshape(-1))
    )

    # -- Aeq: kron(I,-I) + kron(downshift, ssA) | kron(downshift_B, ssB) --
    # (ProblemBuilder.hpp:671-702)
    eye_h = jnp.eye(ph + 1, dtype=dtype)
    down = jnp.zeros((ph + 1, ph + 1), dtype).at[1:, :-1].set(jnp.eye(ph, dtype=dtype))
    down_b = jnp.zeros((ph + 1, ph), dtype).at[1:, :].set(jnp.eye(ph, dtype=dtype))
    Aeq_x = jnp.kron(eye_h, -jnp.eye(nxu, dtype=dtype)) + jnp.kron(down, prob.ssA)
    Aeq_u = jnp.kron(down_b, prob.ssB)
    Aeq = jnp.concatenate([Aeq_x, Aeq_u], axis=1)

    # -- Aineq rows ------------------------------------------------------
    # box rows on x_aug (identity), output rows kron(I, ssC[:ny]),
    # du identity rows, scalar row (ProblemBuilder.hpp:704-822)
    Aineq = jnp.zeros((dims.n_ineq, dims.nz), dtype)
    Aineq = Aineq.at[: dims.n_box, : dims.n_aug].set(jnp.eye(dims.n_box, dtype=dtype))
    Aineq = Aineq.at[dims.n_box : dims.n_box + dims.n_out, : dims.n_aug].set(
        jnp.kron(eye_h, prob.ssC[:ny, :])
    )
    r0 = dims.n_box + dims.n_out
    Aineq = Aineq.at[r0 : r0 + dims.n_dub, dims.n_aug :].set(
        jnp.eye(dims.n_dub, dtype=dtype)
    )
    r1 = r0 + dims.n_dub
    Aineq = Aineq.at[r1:, : dims.n_aug].set(jnp.kron(eye_h, prob.s_mult[None, :]))

    A = jnp.concatenate([Aeq, Aineq], axis=0)

    # -- static inequality bounds ----------------------------------------
    # box: [min_x_i ; min_u_{min(i, ph-1)}] per step (ProblemBuilder.hpp:735-749).
    # Bound leaves may carry a leading batch axis (per-instance bounds for
    # fleet solves); the model/weight terms above stay shared.
    batch = jnp.broadcast_shapes(
        prob.min_x.shape[:-2], prob.min_u.shape[:-2], prob.min_y.shape[:-2],
        prob.s_min.shape[:-1],
    )
    bcast = lambda a, tail: jnp.broadcast_to(a, batch + tail)
    u_idx = jnp.minimum(jnp.arange(ph + 1), ph - 1)
    e_min = jnp.concatenate(
        [
            bcast(prob.min_x, (ph + 1, nx)),
            bcast(jnp.take(prob.min_u, u_idx, axis=-2), (ph + 1, nu)),
        ],
        axis=-1,
    ).reshape(batch + (-1,))
    e_max = jnp.concatenate(
        [
            bcast(prob.max_x, (ph + 1, nx)),
            bcast(jnp.take(prob.max_u, u_idx, axis=-2), (ph + 1, nu)),
        ],
        axis=-1,
    ).reshape(batch + (-1,))
    # du rows: free through step ch, pinned to 0 after (ProblemBuilder.hpp:782-793)
    steps = jnp.arange(ph)
    du_min = jnp.where(steps[:, None] > ch, 0.0, -inf) * jnp.ones((1, nu), dtype)
    du_max = jnp.where(steps[:, None] > ch, 0.0, inf) * jnp.ones((1, nu), dtype)

    lineq = jnp.concatenate(
        [
            e_min,
            bcast(prob.min_y, (ph + 1, ny)).reshape(batch + (-1,)),
            jnp.broadcast_to(du_min.reshape(-1), batch + (ph * nu,)),
            bcast(prob.s_min, (ph + 1,)),
        ],
        axis=-1,
    )
    uineq = jnp.concatenate(
        [
            e_max,
            bcast(prob.max_y, (ph + 1, ny)).reshape(batch + (-1,)),
            jnp.broadcast_to(du_max.reshape(-1), batch + (ph * nu,)),
            bcast(prob.s_max, (ph + 1,)),
        ],
        axis=-1,
    )
    return P, A, lineq, uineq


@_highest_matmul
def build_time_varying(
    dims: LDims,
    prob: LProblemData,
    lineq: jax.Array,
    uineq: jax.Array,
    x0: jax.Array,
    u0: jax.Array,
    y_ref: jax.Array,
    u_ref: jax.Array,
    du_ref: jax.Array,
    u_meas: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Per-step (q, l, u) assembly.

    Mirrors ``ProblemBuilder::get``
    (reference: include/mpc/LMPC/ProblemBuilder.hpp:528-633).  References and
    measured disturbances are (ph, feature) time-major; horizon slot i uses
    row ``max(i-1, 0)`` because slot 0 is the current state
    (ProblemBuilder.hpp:564-577).

    All array arguments may carry a leading batch axis (broadcast rules make
    the same code serve both); ``x0``/``u0`` shaped (..., nx) / (..., nu).
    """
    ph = dims.ph
    nx, nu, ny = dims.nx, dims.nu, dims.ny
    nxu = dims.nxu

    idx = jnp.maximum(jnp.arange(ph + 1) - 1, 0)
    y_ref_e = jnp.take(y_ref, idx, axis=-2)  # (..., ph+1, ny)
    u_ref_e = jnp.take(u_ref, idx, axis=-2)
    du_ref_e = jnp.take(du_ref, idx, axis=-2)
    u_meas_e = jnp.take(u_meas, idx, axis=-2)  # (..., ph+1, ndu)

    # q over x_aug blocks: ssC' W_i (-eRef_i + ssDv d_i)  (hpp:586-587)
    e_ref = jnp.concatenate([y_ref_e, u_ref_e], axis=-1)  # (..., ph+1, ny+nu)
    w_ext = jnp.concatenate([prob.w_out, prob.w_u], axis=1)  # (ph+1, ny+nu)
    inner = w_ext * (-e_ref + u_meas_e @ prob.ssDv.T)
    q_aug = inner @ prob.ssC  # (..., ph+1, nxu)

    # q over du blocks: -w_du_i * du_ref_i for i < ph (hpp:590-594)
    q_du = -(prob.w_du * du_ref_e[..., :ph, :])

    batch = jnp.broadcast_shapes(
        x0.shape[:-1], u0.shape[:-1], y_ref.shape[:-2], u_meas.shape[:-2],
        lineq.shape[:-1],
    )
    q_aug = jnp.broadcast_to(q_aug, batch + q_aug.shape[-2:])
    q_du = jnp.broadcast_to(q_du, batch + q_du.shape[-2:])
    q = jnp.concatenate(
        [q_aug.reshape(batch + (-1,)), q_du.reshape(batch + (-1,))], axis=-1
    )

    # equality RHS: block 0 = [-x0; -u0], block i>0 = -ssBv d_{i-1} (hpp:597-613)
    leq_head = -jnp.concatenate([x0, u0], axis=-1)[..., None, :]  # (..., 1, nxu)
    leq_tail = -(u_meas_e[..., 1:, :] @ prob.ssBv.T)  # (..., ph, nxu)
    # x0 may carry a batch axis while the references do not — broadcast both
    # operands to the joint batch shape before stacking
    leq_head = jnp.broadcast_to(leq_head, batch + leq_head.shape[-2:])
    leq_tail = jnp.broadcast_to(leq_tail, batch + leq_tail.shape[-2:])
    leq = jnp.concatenate([leq_head, leq_tail], axis=-2).reshape(batch + (-1,))

    # inequality offsets on the output rows: -ssDv[:ny] d_i (hpp:605-607)
    out_off = -(u_meas_e @ prob.ssDv[:ny, :].T)
    out_off = jnp.broadcast_to(out_off, batch + out_off.shape[-2:]).reshape(batch + (-1,))
    offset = jnp.zeros(batch + (dims.n_ineq,), q.dtype)
    offset = jax.lax.dynamic_update_slice_in_dim(
        offset, out_off, dims.n_box, axis=-1
    )

    l = jnp.concatenate(
        [leq, jnp.broadcast_to(lineq, batch + lineq.shape[-1:]) + offset], axis=-1
    )
    u = jnp.concatenate(
        [leq, jnp.broadcast_to(uineq, batch + uineq.shape[-1:]) + offset], axis=-1
    )
    return q, l, u


def unpack_solution(dims: LDims, prob: LProblemData, z: jax.Array, u_meas: jax.Array):
    """Extract (state, input, output) sequences from the QP solution.

    Mirrors the unpack loop (reference: include/mpc/LMPC/LOptimizer.hpp:304-338):
    states are the first nx entries of each augmented block; inputs are the
    x_u component *shifted forward one step* (``x_u(k) = u(k-1)``), with the
    last row repeated; outputs come from ``mapToOutput`` with the step's
    measured disturbance.
    """
    ph, nx, nu, ny = dims.ph, dims.nx, dims.nu, dims.ny
    batch = z.shape[:-1]
    aug = z[..., : dims.n_aug].reshape(batch + (ph + 1, dims.nxu))
    states = aug[..., :nx]
    xu = aug[..., nx:]
    shift_idx = jnp.minimum(jnp.arange(ph + 1) + 1, ph)
    inputs = jnp.take(xu, shift_idx, axis=-2)

    idx = jnp.maximum(jnp.arange(ph + 1) - 1, 0)
    u_meas_e = jnp.take(u_meas, idx, axis=-2)
    outputs = states @ prob.ssC[:ny, :nx].T + u_meas_e @ prob.ssDv[:ny, :].T
    return states, inputs, outputs


def map_to_output(prob: LProblemData, ny: int, nx: int, state, meas_dist):
    """``y = C x + Dd d`` (reference: include/mpc/LMPC/ProblemBuilder.hpp:514-517)."""
    return state @ prob.ssC[:ny, :nx].T + meas_dist @ prob.ssDv[:ny, :].T


def _shift_stages(vec, n_stages: int, width: int):
    """Roll per-stage blocks one stage earlier, duplicating the last stage."""
    blocks = vec.reshape(vec.shape[:-1] + (n_stages, width))
    blocks = jnp.concatenate([blocks[..., 1:, :], blocks[..., -1:, :]], axis=-2)
    return blocks.reshape(vec.shape[:-1] + (n_stages * width,))


def shift_warm_start(dims: LDims, warm_x, warm_y):
    """Advance an LMPC warm start one control step along the horizon.

    The reference warm-starts OSQP with the *unshifted* previous solution
    (include/mpc/LMPC/LOptimizer.hpp:372); after the plant advances one step
    that guess is misaligned by one stage.  Rolling every per-stage block of
    the primal (augmented states, then Δu moves) and the dual (dynamics,
    state-box, output, Δu-box and scalar rows — the row layout of
    build_time_invariant) one stage earlier and duplicating the terminal
    stage re-aligns it — the receding-horizon shift NLopt-style solvers
    apply to their own warm starts (ops/sqp.py::shift_warm_start is the
    NLMPC analog).  Measured on the closed-loop quadrotor family this
    halves the p99 ADMM iteration count (50 -> 25) and cuts
    iteration-cap hits ~10x, which is what a lockstep batch pays for.
    """
    warm_x = jnp.concatenate(
        [
            _shift_stages(warm_x[..., : dims.n_aug], dims.ph + 1, dims.nxu),
            _shift_stages(warm_x[..., dims.n_aug :], dims.ph, dims.nu),
        ],
        axis=-1,
    )
    segments = (
        (dims.ph + 1, dims.nxu),  # dynamics equality rows
        (dims.ph + 1, dims.nxu),  # state/input box rows
        (dims.ph + 1, dims.ny),   # output rows
        (dims.ph, dims.nu),       # delta-u box rows
        (dims.ph + 1, 1),         # scalar-constraint rows
    )
    parts, offset = [], 0
    for n_stages, width in segments:
        size = n_stages * width
        parts.append(
            _shift_stages(warm_y[..., offset : offset + size], n_stages, width)
        )
        offset += size
    return warm_x, jnp.concatenate(parts, axis=-1)
