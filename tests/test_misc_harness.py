"""Smoke tests for the measurement harnesses so they don't rot."""

import json
import subprocess
import sys
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestScalingBench:
    def test_runs_and_reports(self, tmp_path):
        env = dict(os.environ)
        env["LIBMPC_PLATFORM"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
        )
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "misc", "scaling_bench.py"),
             "--per-device", "4", "--steps", "1"],
            capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        last = out.stdout.strip().splitlines()[-1]
        data = json.loads(last)
        assert data["platform"] == "cpu"
        assert [r["devices"] for r in data["scaling"]] == [1, 2]
        assert data["scaling"][0]["efficiency"] == 1.0


class TestBenchScript:
    def test_bench_emits_one_json_line(self):
        """bench.py must print exactly one JSON line with the driver's
        contract keys (runs on CPU with a tiny batch)."""
        env = dict(os.environ)
        env["LIBMPC_PLATFORM"] = "cpu"
        # shrink every section to smoke size: the full-size closed-loop
        # rollouts (16384x16 LMPC scan, nz=301 oscillators) take far past
        # the timeout to compile+run on CPU
        env.update({
            "LIBMPC_CL_B": "8", "LIBMPC_CL_K": "2",
            "LIBMPC_NL_CL_B": "4", "LIBMPC_NL_CL_K": "2",
            "LIBMPC_OSC_B": "2", "LIBMPC_OSC_K": "1",
            "LIBMPC_NL_B": "8",
            "LIBMPC_UGV_B": "4", "LIBMPC_UGV_K": "2",
            "LIBMPC_PEAK_SIZE": "256",
            # the latency table (multi-batch compiles, serving loop) and
            # the osc B-scaling curve are accelerator workloads; the HBM
            # probe just needs a smaller buffer on CPU
            "LIBMPC_SKIP_LATENCY": "1",
            "LIBMPC_SKIP_OSC_SCALING": "1",
            "LIBMPC_HBM_PROBE_MB": "64",
        })
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "bench.py"), "8"],
            capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        lines = [l for l in out.stdout.strip().splitlines() if l.startswith("{")]
        assert len(lines) == 1
        data = json.loads(lines[0])
        for key in ("metric", "value", "unit", "vs_baseline"):
            assert key in data
        assert data["unit"] == "solves/s"
        assert data["value"] > 0
        # a rehearsal says where it ran
        assert data["platform"] == "cpu"
        assert data["device_count"] >= 1
