"""`python -m h264decode_tpu_torch bench` on the CPU at QCIF: the JSON line
of the JAX package's bench.py (same keys and metric names), the stage
timers and the download line on stderr; with BENCH_MESH, the GOP-parallel
decoder."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mesh,metric", [(None, "qcif_main_cabac_fps_per_chip"),
                                         ("2x1", "qcif_main_cabac_fps_mesh2x1")])
def test_bench_prints_one_json_line(mesh, metric):
    env = dict(os.environ, BENCH_SIZE="qcif", BENCH_FRAMES="8")
    env.pop("BENCH_MESH", None)
    if mesh:
        env["BENCH_MESH"] = mesh
    res = subprocess.run([sys.executable, "-m", "h264decode_tpu_torch", "bench", "--device",
                          "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == metric and rec["unit"] == "frames/s"
    # value and vs_baseline (against 60 frames/s) are each rounded apart
    assert rec["value"] > 0 and abs(rec["vs_baseline"] - rec["value"] / 60.0) < 1e-4
    if not mesh:
        assert "per-stage:" in res.stderr and "device->host download" in res.stderr
