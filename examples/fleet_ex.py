"""Fleet example — the headline batched capability.

No reference counterpart: one quadrotor controller configuration, a fleet of
randomized scenarios solved in lockstep over the device mesh, with
per-instance references and bounds, fleet statistics aggregated by ICI
collectives, and a fully on-device closed-loop rollout.

Run on any backend; on CPU set XLA_FLAGS=--xla_force_host_platform_device_count=8
to simulate an 8-device mesh.
"""

import numpy as np

import jax
import jax.numpy as jnp

from libmpc_tpu import LParameters
from libmpc_tpu.parallel import mesh as mesh_lib
from libmpc_tpu.parallel.fleet import LMPCFleet
from libmpc_tpu.rollout import lmpc_rollout

from quadrotor_ex import build_controller


def main():
    n_dev = len(jax.devices())
    mesh = mesh_lib.make_mesh(data=n_dev)
    print(f"mesh: {dict(mesh.shape)} over {jax.devices()[0].platform}")

    controller = build_controller()
    controller.set_optimizer_parameters(
        LParameters(maximum_iteration=250, enable_warm_start=True, polish=False)
    )
    fleet = LMPCFleet(controller, mesh)

    B = 16 * n_dev
    rng = np.random.default_rng(0)
    x0 = 0.05 * rng.normal(size=(B, 12))
    u0 = np.zeros((B, 4))

    # per-instance altitude references
    y_ref = np.zeros((B, 10, 12))
    y_ref[:, :, 2] = rng.uniform(0.5, 1.5, size=(B, 1))

    result, stats = fleet.optimize(x0, u0, y_ref=y_ref)
    print(stats)

    # fully on-device closed loop for the same fleet (shared reference here)
    Ad = np.asarray(controller._prob.ssA)[:12, :12]
    Bd = np.asarray(controller._prob.ssB)[:12, :]
    Ad_j, Bd_j = jnp.asarray(Ad), jnp.asarray(Bd)
    plant = lambda x, u, k: x @ Ad_j.T + u @ Bd_j.T
    roll = lmpc_rollout(controller, plant, x0, u0, n_steps=40)
    final_alt = np.asarray(roll.states)[:, -1, 2]
    print(f"rollout: {B} instances x 40 steps, "
          f"altitude mean {final_alt.mean():.3f} "
          f"(target 1.0), all-success={bool((np.asarray(roll.statuses) == 0).all())}")


if __name__ == "__main__":
    main()
