"""Test configuration.

Tests run on a virtual 8-device CPU mesh (no accelerator required) with float64
enabled — the parity configuration matching the double-precision reference.
The reference's dual static/dynamic compilation trick
(test/CMakeLists.txt:56-65) maps to JAX as: every shape specialization is its
own compiled program; the `dims` fixture sweeps dimension tuples instead.
"""

import os

# force the CPU backend: tests must run identically with or without an
# accelerator attached
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# jax may already be imported by a pytest plugin, in which case it captured
# the session's JAX_PLATFORMS — override through the config too.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest


@pytest.fixture(autouse=True)
def _reset_logger():
    from libmpc_tpu.utils.logger import Logger

    Logger._reset_for_tests()
    yield
    Logger._reset_for_tests()


@pytest.fixture
def fused_kernel_interpreted(monkeypatch):
    """Route ``inner_qp="fused"`` to the fused kernel as on a GPU, with the
    kernel run by the Pallas interpreter (it compiles for the GPU only)."""
    from libmpc_tpu.ops import qp_inner_pallas, sqp

    choose = sqp.inner_engine
    make = qp_inner_pallas.make_inner_qp_solver
    monkeypatch.setattr(
        sqp, "inner_engine",
        lambda *a, **kw: choose(*a, **{**kw, "backend": "gpu"}),
    )
    monkeypatch.setattr(
        qp_inner_pallas, "make_inner_qp_solver",
        lambda **kw: make(**kw, interpret=True),
    )
