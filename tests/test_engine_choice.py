"""Truth table of the one function that picks the SQP inner-QP engine
(ops/sqp.py::inner_engine): dtype x backend x size x plan x request."""

import itertools

import jax.numpy as jnp
import pytest

from libmpc_tpu.ops import sqp, trajectory_kkt as tk
from libmpc_tpu.types import NLParameters

# (nz, me, mi) of the Van der Pol subproblem (the kernel's widths) and of
# the networked oscillators (too wide for the kernel), with their plans
SIZES = {
    "fits": ((26, 20, 11), tk.TrajPlan(ph=10, ch=5, nx=2, nu=1, mi=11)),
    "wide": ((301, 240, 126), tk.TrajPlan(ph=20, ch=10, nx=12, nu=6, mi=126)),
}

# the "fused" request, keyed by (float32, backend, size, plan verified)
FUSED = {
    (True, "gpu", "fits", True): "fused",
    (True, "gpu", "fits", False): "fused",
    (True, "gpu", "wide", True): "riccati",
    (True, "gpu", "wide", False): "admm",
    (True, "cpu", "fits", True): "riccati",
    (True, "cpu", "fits", False): "pdip",
    (True, "cpu", "wide", True): "riccati",
    (True, "cpu", "wide", False): "admm",
    (False, "gpu", "fits", True): "riccati",
    (False, "gpu", "fits", False): "pdip",
    (False, "gpu", "wide", True): "riccati",
    (False, "gpu", "wide", False): "pdip",
    (False, "cpu", "fits", True): "riccati",
    (False, "cpu", "fits", False): "pdip",
    (False, "cpu", "wide", True): "riccati",
    (False, "cpu", "wide", False): "pdip",
}


def _expected(request, f32, backend, size, plan):
    if request == "fused":
        return FUSED[(f32, backend, size, plan)]
    if request == "riccati":
        return "riccati" if plan else "pdip"
    return request  # "pdip" and "admm" are taken as asked


@pytest.mark.parametrize(
    "request_,f32,backend,size,plan",
    list(itertools.product(("fused", "riccati", "pdip", "admm"),
                           (True, False), ("gpu", "cpu"), ("fits", "wide"),
                           (True, False))),
)
def test_inner_engine_truth_table(request_, f32, backend, size, plan):
    (nz, me, mi), traj_plan = SIZES[size]
    params = NLParameters(inner_qp=request_, hessian_reg="gershgorin")
    dtype = jnp.float32 if f32 else jnp.float64
    got = sqp.inner_engine(params, dtype, nz, me, mi,
                           traj_plan if plan else None, backend=backend)
    assert got == _expected(request_, f32, backend, size, plan)


@pytest.mark.parametrize("reg", ["eigh", "bfgs"])
def test_dense_curvature_never_takes_the_band(reg):
    # eigh fills in V W V' and bfgs is dense: a verified plan is unusable
    (nz, me, mi), plan = SIZES["wide"]
    params = NLParameters(inner_qp="riccati", hessian_reg=reg)
    assert sqp.inner_engine(params, jnp.float32, nz, me, mi, plan,
                            backend="gpu") == "pdip"
