"""Two-process ``jax.distributed`` dryrun over localhost.

The reference is single-process (SURVEY §2.3); this framework's multi-host
story is ``jax.distributed.initialize`` + one global mesh + ``shard_map``
(``libmpc_tpu/parallel/mesh.py``).  Single-process tests exercise the mesh on
8 virtual devices, but nothing there proves the program actually runs across
PROCESS boundaries.  This harness does: two OS processes, each with 4 virtual
CPU devices, join one 8-device global mesh and run the same
``solve_body`` + psum-fleet-stats program ``LMPCFleet`` compiles
(``parallel/fleet.py``), with the batch sharded across the processes.

Checks per worker:
* the global mesh spans both processes (8 devices, 4 addressable);
* fleet stats psum over the cross-process data axis returns the GLOBAL
  counts (n_total == B, all SUCCESS) on every process;
* every locally-addressable command shard reproduces the reference's golden
  quadrotor command (reference: test/LMPC/test_common.cpp:230-236).

Usage::

    python misc/multihost_dryrun.py            # orchestrates the 2 workers
    python misc/multihost_dryrun.py --worker I --port P   # internal
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROC = 2
DEV_PER_PROC = 4
B = 16
GOLDEN = [-0.9916, 1.74839, -0.9916, 1.74839]


def worker(pid: int, port: int) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEV_PER_PROC}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(f"127.0.0.1:{port}", N_PROC, pid)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, REPO)
    from __graft_entry__ import _quadrotor_setup
    from libmpc_tpu.lmpc import controller as lmpc_controller
    from libmpc_tpu.parallel import mesh as mesh_lib
    from libmpc_tpu.parallel.fleet import _local_stats

    n_dev = N_PROC * DEV_PER_PROC
    assert len(jax.devices()) == n_dev, jax.devices()
    assert len(jax.local_devices()) == DEV_PER_PROC

    c = _quadrotor_setup(jnp.float64)
    dims, params, prob = c.dims, c._params, c._prob
    built = lmpc_controller.build_prepared(
        dims, params, prob, c._y_ref, c._u_ref, c._du_ref, c._u_meas
    )
    mesh = mesh_lib.make_mesh(data=n_dev, model=1)
    axis = mesh_lib.DATA_AXIS
    data_sh = NamedSharding(mesh, P(axis))
    repl_sh = NamedSharding(mesh, P())

    def gput(tree, sh):
        # every process holds the identical full host array; device_put
        # places each process's addressable shards of the global array
        return jax.tree.map(lambda a: jax.device_put(a, sh), tree)

    x0 = gput(np.zeros((B, 12)), data_sh)
    u0 = gput(np.zeros((B, 4)), data_sh)
    warm = gput(np.zeros((B, dims.nz)), data_sh)
    warm_y = gput(np.zeros((B, dims.m)), data_sh)
    prev = gput(np.zeros((B, 4)), data_sh)
    shared = gput((prob, built, c._y_ref, c._u_ref, c._du_ref, c._u_meas),
                  repl_sh)
    prob_g, built_g, y_ref, u_ref, du_ref, u_meas = shared

    def step(prob, built, x0, u0, y_ref, u_ref, du_ref, u_meas,
             warm_x, warm_y, prev_cmd):
        result, seq, sol_x, sol_y, iters = lmpc_controller.solve_body(
            dims, params, prob, x0, u0, y_ref, u_ref, du_ref, u_meas,
            warm_x, warm_y, jnp.asarray(False), prev_cmd, built=built,
        )
        return result, _local_stats(result.status, iters, axis)

    n_shared = len(jax.tree.leaves((prob_g, built_g)))
    sharded = jax.jit(jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(), prob_g),
                  jax.tree.map(lambda _: P(), built_g),
                  P(axis), P(axis), P(), P(), P(), P(),
                  P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P()),
        check_vma=False,
    ))
    result, stats = sharded(prob_g, built_g, x0, u0, y_ref, u_ref, du_ref,
                            u_meas, warm, warm_y, prev)

    # global psum stats visible identically on every process
    assert int(stats.n_total) == B, stats
    assert int(stats.n_success) == B, stats
    # every addressable command shard must hit the reference golden
    for shard in result.cmd.addressable_shards:
        err = np.max(np.abs(np.asarray(shard.data) - np.asarray(GOLDEN)))
        assert err < 1e-4, (shard.index, err)
    print(f"[worker {pid}] OK: mesh {n_dev} devices across {N_PROC} "
          f"processes, {n_shared} replicated leaves, global stats "
          f"n_success={int(stats.n_success)}/{B}, golden hit on "
          f"{len(result.cmd.addressable_shards)} local shards", flush=True)


def orchestrate() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(i), "--port", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(N_PROC)
    ]
    rc = 0
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        ok = p.returncode == 0 and f"[worker {i}] OK" in out
        print(out.strip())
        if not ok:
            rc = 1
    print("MULTIHOST DRYRUN:", "PASS" if rc == 0 else "FAIL", flush=True)
    return rc


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker(int(sys.argv[sys.argv.index("--worker") + 1]),
               int(sys.argv[sys.argv.index("--port") + 1]))
    else:
        sys.exit(orchestrate())
