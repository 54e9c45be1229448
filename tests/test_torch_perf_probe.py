"""The stage-attribution probe (h264decode_tpu_torch/tools/perf_probe.py) on
the CPU at QCIF: one captured entry per frame, the `full` prefix replayed on
each frame's own references equal to GpuDecoder(device="cpu")'s frames bit
for bit (a Main I/P/B stream and a High 4:4:4 stream), every prefix reported
with its host time and operator count, and the command line's JSON line."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from h264decode_tpu_torch.golden import lavc
from h264decode_tpu_torch.pipeline.gpu_pipeline import GpuDecoder
from h264decode_tpu_torch.tools import perf_probe
from chip_smoke import md5s
from tests.conftest import make_test_frames

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def streams():
    """QCIF Main CABAC I/P/B (decode order I, P, B) and High 4:4:4 8-bit
    I/P."""
    frames = make_test_frames(3, 144, 176, seed=5)
    main = lavc.encode_x264(frames, qp=28, profile="main", cabac=True, bframes=1, gop=8,
                            preset="fast")
    full = [(y, np.kron(cb, np.ones((2, 2), np.uint8)), np.kron(cr, np.ones((2, 2), np.uint8)))
            for y, cb, cr in frames[:2]]
    high444 = lavc.encode_x264(full, qp=28, profile="high444", csp="yuv444p", cabac=True,
                               bframes=0, gop=8, preset="fast", extra_x264="8x8dct=1")
    return {"main": main, "444": high444}


@pytest.fixture(scope="module")
def captured(streams):
    """kind -> (the probe's entries, GpuDecoder(device="cpu")'s per-plane
    MD5s of each output frame)."""
    out = {}
    for kind, bs in streams.items():
        with GpuDecoder(device="cpu") as dec:
            want = [md5s(f.planes()) for f in dec.decode_stream(bs)]
        out[kind] = (perf_probe.capture(bs, CPU), want)
    return out


def _packed_md5s(packed: torch.Tensor, cat: int, W: int):
    """Per-plane MD5s of a packed frame ([H + Hc, W], or [3H, W] for 4:4:4),
    as the decoder's _PackedFrame splits it (the test streams need no
    cropping)."""
    a = packed.numpy()
    if cat == 3:
        H = a.shape[0] // 3
        return md5s((a[:H], a[H : 2 * H], a[2 * H :]))
    H = a.shape[0] * 2 // 3
    return md5s((a[:H], a[H:, : W // 2], a[H:, W // 2 :]))


@pytest.mark.parametrize("kind,n", [("main", 3), ("444", 2)])
def test_capture_keeps_one_entry_per_frame(captured, kind, n):
    entries, want = captured[kind]
    assert len(entries) == len(want) == n
    for e in entries:
        assert e["ring_y"].shape[0] == e["ring_c"].shape[0]
        rows = 3 * e["mb_h"] * (16 if kind == "444" else 8)
        assert e["packed"].shape == (rows, e["mb_w"] * 16)


@pytest.mark.parametrize("kind", ["main", "444"])
def test_full_replay_equals_the_decoder_bit_for_bit(captured, kind):
    entries, want = captured[kind]
    got = []
    for e in entries:
        ring_y, ring_c = e["ring_y"].clone(), e["ring_c"].clone()
        out = perf_probe.run_prefix("full", e, ring_y, ring_c)
        assert torch.equal(out, e["packed"])
        got.append(_packed_md5s(out, e["flags"][6], e["mb_w"] * 16))
    # the replays run in decode order, the decoder returns output order
    assert sorted(got) == sorted(want)


def test_every_prefix_and_stage_is_reported(streams):
    rec = perf_probe.probe_stream(streams["main"], "qcif_main", "cpu", max_frames=2,
                                  replays=1)
    assert rec["frames"] == 2 and rec["device"] == "cpu"
    assert "not measured on the CPU" in rec["device_ms"]
    assert [r["intra_only"] for r in rec["rows"]] == [True, False]
    for row in rec["rows"]:
        assert set(row["prefixes"]) == set(perf_probe.PREFIXES)
        for p in row["prefixes"].values():
            assert p["kernels"] >= 0 and p["host_ms"] >= 0 and p["device_ms"] is None
        # nested prefixes dispatch at least their prefix's operators
        counts = [row["prefixes"][p]["kernels"] for p in perf_probe.PREFIXES]
        assert counts[0] > 0 and counts[-1] >= counts[0]
    sums = rec["sums"]
    assert (sums["I"]["frames"], sums["inter"]["frames"]) == (1, 1)
    for group in sums.values():
        assert set(perf_probe.STAGES) <= set(group)
        total = sum(group[s]["kernels"] for s in perf_probe.STAGES)
        assert total == group["prefix:full"]["kernels"]
    assert "prefix:full" in perf_probe.table(rec)


def test_cli_prints_one_json_line(streams, tmp_path):
    path = tmp_path / "tiny.h264"
    path.write_bytes(lavc.encode_x264(make_test_frames(1, 32, 48), qp=28, profile="main",
                                      cabac=True, gop=8))
    res = subprocess.run([sys.executable, "-m", "h264decode_tpu_torch.tools.perf_probe",
                          "--stream", str(path), "--device", "cpu", "--replays", "1"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    rec = json.loads(lines[0])
    assert rec["stream"] == "tiny.h264" and rec["frames"] == 1
    assert set(rec["rows"][0]["prefixes"]) == set(perf_probe.PREFIXES)
    assert "unpack" in res.stderr and "ring_pack" in res.stderr
