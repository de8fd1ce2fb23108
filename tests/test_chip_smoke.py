"""The on-card smoke script (chip_smoke.py): its refusals, and every phase
at a tiny size on the CPU (the Pallas kernel in interpret mode).  The full
sizes run only on a GPU: ``python chip_smoke.py`` (one card) and
``python chip_smoke.py --four`` (four cards)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(cwd, script, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(extra_env or {}))
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=600, cwd=cwd, env=env)


def _no_result(out):
    return not any('"ok"' in line for line in out.stdout.splitlines())


class TestRefusals:
    def test_refuses_cpu_device(self, tmp_path):
        out = _run(REPO, os.path.join(REPO, "chip_smoke.py"),
                   {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        assert out.returncode != 0
        assert _no_result(out)
        assert "needs a GPU" in out.stderr

    def test_refuses_outside_checkout(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        out = _run(tmp_path, str(tmp_path / "chip_smoke.py"))
        assert out.returncode != 0
        assert _no_result(out)
        assert "checkout" in out.stderr


class TestPhasesTinyOnCPU:
    """Each phase end to end at a tiny size: control flow, shapes, oracle
    slicing and gates (values on the CPU are no device measurement)."""

    @pytest.mark.parametrize("name,call", [
        ("P1", lambda: chip_smoke.phase_lmpc("cpu", B=64)),
        ("P2", lambda: chip_smoke.phase_lmpc_closed_loop(
            "cpu", B=16, K=3, oracle_lanes=16)),
        ("P3", lambda: chip_smoke.phase_vdp(
            "cpu", B=16, K=3, oracle_lanes=16, reps=1)),
        ("P4", lambda: chip_smoke.phase_oscillators("cpu", B=2, K=1, n_ref=2)),
        ("P5", lambda: chip_smoke.phase_ugv("cpu", B=4, K=5)),
        ("P6", lambda: chip_smoke.phase_kernels(
            "cpu", B=8, reps=1, interpret=True)),
    ])
    def test_phase_passes_its_gates(self, name, call, capsys):
        call()
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["phase"].startswith(name)
        assert line["gates"]
        assert all(g["pass"] for g in line["gates"].values())

    def test_failed_gate_exits_nonzero(self, capsys):
        ph = chip_smoke.Phase("PX", "cpu")
        ph.gate("too_big", 2.0, 1.0)
        with pytest.raises(SystemExit) as exc:
            ph.finish()
        assert "too_big" in str(exc.value)
        assert json.loads(capsys.readouterr().out)["gates"]["too_big"][
            "pass"] is False


class TestFourDevicePhasesOnVirtualCPU:
    """The ``--four`` phases on four of the test session's virtual CPU
    devices (conftest): meshes and sharding rules, not device numbers."""

    @pytest.mark.parametrize("call", [
        lambda: chip_smoke.phase_four_lmpc("cpu", B_per=8),
        lambda: chip_smoke.phase_four_vdp("cpu", B_per=4),
        lambda: chip_smoke.phase_four_qp_sharded("cpu", B=8),
    ], ids=["lmpc_fleet", "vdp_fleet", "qp_row_sharded"])
    def test_four_way_matches_one_device(self, call, capsys):
        import jax

        assert len(jax.devices()) >= 4
        call()
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert all(g["pass"] for g in line["gates"].values())
