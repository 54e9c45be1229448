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


@pytest.mark.parametrize("mesh,metric", [(None, "qcif_main_cabac_fps_per_chip_hard"),
                                         ("2x1", "qcif_main_cabac_fps_mesh2x1")])
def test_bench_hard_content(mesh, metric):
    """BENCH_CONTENT=hard at QCIF, encoded here with x264 (bench.py's hard
    recipe), every frame bit-exact vs libavcodec (the bench raises
    otherwise); the per-chip metric takes the suffix _hard, the mesh metric
    keeps bench.py's name."""
    env = dict(os.environ, BENCH_SIZE="qcif", BENCH_FRAMES="8", BENCH_CONTENT="hard")
    env.pop("BENCH_MESH", None)
    if mesh:
        env["BENCH_MESH"] = mesh
    res = subprocess.run([sys.executable, "-m", "h264decode_tpu_torch", "bench", "--device",
                          "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    assert json.loads(lines[0])["metric"] == metric
    assert "bit-exact vs libavcodec" in res.stderr


def test_bench_hard_streams_without_x264(monkeypatch):
    """Without libx264 (the card's machine): the committed 1080p hard stream
    serves 8 frames, and any other hard stream raises, naming it; it never
    falls back to the default content."""
    from h264decode_tpu_torch import bench
    from h264decode_tpu_torch.golden import lavc

    def no_x264(*args, **kwargs):
        raise RuntimeError("libx264 encoder unavailable")

    monkeypatch.setattr(lavc, "encode_x264", no_x264)
    monkeypatch.setenv("BENCH_CONTENT", "hard")
    bs, want = bench.stream("1080p", 8, None)
    with open(os.path.join(bench.DATA, "smoke_1080p_high_hard.h264"), "rb") as f:
        assert bs == f.read()
    assert len(want) == 8
    with pytest.raises(RuntimeError, match="hard content at 1080p, 16 frames, 4 frames a GOP"):
        bench.stream("1080p", 16, bench.MESH_GOP)
