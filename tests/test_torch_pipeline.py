"""The port's frame program and decoder on the CPU, against the JAX package
and libavcodec. Every comparison is bit-exact (tolerance 0)."""

import ast
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from h264decode_tpu.golden import lavc
from h264decode_tpu.pipeline import tpu_pipeline
from h264decode_tpu_torch import convert
from h264decode_tpu_torch.cli.main import main as cli_main
from h264decode_tpu_torch.entropy import native
from h264decode_tpu_torch.pipeline import gpu_pipeline
from h264decode_tpu_torch.pipeline.gpu_pipeline import GpuDecoder
from tests.conftest import make_test_frames

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "h264decode_tpu_torch")
DATA = os.path.join(PKG, "data")


def fade_frames(n, h, w, seed=3):
    """Textured frames with a brightness fade, so x264 codes real weights."""
    return [(np.clip(y.astype(np.float32) * (1.0 - 0.08 * i) + 3 * i, 0, 255)
             .astype(np.uint8), cb, cr)
            for i, (y, cb, cr) in enumerate(make_test_frames(n, h, w, seed=seed))]


def assert_frames_equal(golden, ours):
    assert len(golden) == len(ours)
    for fi, (g, o) in enumerate(zip(golden, ours)):
        for name, gp, op in zip("y cb cr".split(), g.planes(), o.planes()):
            assert np.array_equal(np.asarray(gp), np.asarray(op)), (fi, name)


def gpu_decode_cpu(bs):
    with GpuDecoder(device="cpu") as dec:
        return dec.decode_stream(bs)


def test_frame_step_matches_jax_on_weighted_p_frame(monkeypatch):
    """The same wire and ring through both frame programs."""
    frames = fade_frames(3, 64, 64)
    bs = lavc.encode_x264(frames, qp=26, profile="main", cabac=True, bframes=0,
                          extra_x264="weightp=2")
    calls = []
    orig = tpu_pipeline.frame_step

    def record(wire, ry, rcb, rcr, dyn, mb_h, mb_w, n_refs, flags):
        out = orig(wire, ry, rcb, rcr, dyn, mb_h, mb_w, n_refs, flags)
        calls.append((
            {k: np.asarray(v) for k, v in wire.items()}, np.asarray(ry), np.asarray(rcb),
            {k: (v if k == "qp_offsets" else np.asarray(v)) for k, v in dyn.items()},
            mb_h, mb_w, flags, [np.asarray(o) for o in out],
        ))
        return out

    monkeypatch.setattr(tpu_pipeline, "frame_step", record)
    tpu_pipeline.TpuDecoder().decode_stream(bs)
    weighted = [c for c in calls if "w_tab" in c[0]]
    assert weighted, "x264 coded no weighted P frame"
    wire, ry, rcb, dyn, mb_h, mb_w, flags, (jry, jrcb, _, jpacked) = weighted[0]
    assert (wire["w_tab"] != 32).any() or (wire["o_tab"] != 0).any()
    t_wire, t_dyn = convert.wire_from_numpy(wire, dyn)
    ring_y, ring_c = convert.ring_from_jax(ry, rcb)
    has_l8, has_pcm, apply_db, sparse, _, has_intra, _, _, need_s2 = flags
    packed = gpu_pipeline.frame_step(
        t_wire, ring_y, ring_c, t_dyn, mb_h, mb_w,
        (has_l8, has_pcm, apply_db, sparse, has_intra, need_s2), int(wire["slot_idx"][0]),
    )
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    ey, ec = convert.ring_from_jax(jry, jrcb)
    assert torch.equal(ring_y, ey)
    assert torch.equal(ring_c, ec)


def test_gpu_decoder_cpu_matches_tpu_decoder():
    frames = make_test_frames(3, 64, 64, seed=8)
    bs = lavc.encode_x264(frames, qp=28, profile="main", cabac=True, bframes=1)
    ref = tpu_pipeline.TpuDecoder().decode_stream(bs)
    ours = gpu_decode_cpu(bs)
    assert_frames_equal(ref, ours)
    assert_frames_equal(lavc.decode_annexb(bs), ours)


STREAMS = {
    "baseline_cavlc": dict(profile="baseline", cabac=False, bframes=0),
    "high_8x8dct": dict(profile="high", cabac=True, bframes=1,
                        extra_x264="8x8dct=1:partitions=all"),
    "weighted_pb": dict(profile="main", cabac=True, bframes=2,
                        extra_x264="weightp=2:weightb=1"),
    "four_slices": dict(profile="main", cabac=True, bframes=1, extra_x264="slices=4"),
    # routed to the numpy oracle, as in the JAX package
    "mbaff": dict(profile="high", cabac=True, bframes=0, extra_x264="interlaced=1"),
    "lossless": dict(qp=0, profile="main", cabac=True, bframes=0),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_gpu_decoder_cpu_matches_libavcodec(name):
    frames = fade_frames(4, 144, 176, seed=5) if name == "weighted_pb" else \
        make_test_frames(4, 144, 176, seed=6)
    bs = lavc.encode_x264(frames, **{"qp": 27, **STREAMS[name]})
    native.calls.clear()
    ours = gpu_decode_cpu(bs)
    assert native.calls["decode_slice"] > 0  # the native engine decoded
    assert_frames_equal(lavc.decode_annexb(bs), ours)


def test_rings_over_budget_decode_on_the_oracle(monkeypatch):
    monkeypatch.setattr(gpu_pipeline, "RING_BUDGET_MB", 0)
    bs = lavc.encode_x264(make_test_frames(3, 64, 64, seed=9), qp=28, profile="main",
                          cabac=True, bframes=1)
    with GpuDecoder(device="cpu") as dec:
        ours = dec.decode_stream(bs)
        assert dec._ring is None  # no frame reached the device path
    assert_frames_equal(lavc.decode_annexb(bs), ours)


def test_rings_larger_than_the_card_raise_on_cuda(monkeypatch):
    """On a CUDA device the budget is the card's memory, and a ring that
    cannot fit raises instead of sending pictures to the host oracle."""
    from types import SimpleNamespace

    monkeypatch.setattr(gpu_pipeline, "RING_BUDGET_MB", 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(total_memory=64 << 20))
    with GpuDecoder(device="cpu") as dec:
        dec.device = torch.device("cuda", 0)  # only the guard reads it here
        cif = SimpleNamespace(max_num_ref_frames=3, frame_height_in_mbs=18,
                              pic_width_in_mbs=22)
        assert not dec._ring_over_budget(cif)  # fits: stays on the card
        uhd = SimpleNamespace(max_num_ref_frames=16, frame_height_in_mbs=135,
                              pic_width_in_mbs=240)
        with pytest.raises(MemoryError, match="DPB rings"):
            dec._ring_over_budget(uhd)


def test_cli_decodes_cif_smoke_stream_to_committed_md5s(tmp_path):
    with open(os.path.join(DATA, "smoke_md5.json")) as f:
        want = json.load(f)["smoke_cif_high.h264"]
    out = tmp_path / "out.y4m"
    assert cli_main(["decode", os.path.join(DATA, "smoke_cif_high.h264"), str(out),
                     "--device", "cpu"]) == 0
    W, H = want["width"], want["height"]
    raw = out.read_bytes()
    frames = raw.split(b"FRAME\n")[1:]
    assert len(frames) == len(want["frames"])
    for fi, (fr, md5s) in enumerate(zip(frames, want["frames"])):
        y = fr[: W * H]
        cb = fr[W * H : W * H + W * H // 4]
        cr = fr[W * H + W * H // 4 : W * H + W * H // 2]
        got = [hashlib.md5(p).hexdigest() for p in (y, cb, cr)]
        assert got == md5s, fi


def test_gpu_decoder_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GpuDecoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["decode", os.path.join(DATA, "smoke_cif_high.h264"), "unused.y4m"])
    GpuDecoder(device="cpu").close()


def test_unported_formats_raise():
    frames = [(y, np.repeat(cb, 2, 0), np.repeat(cr, 2, 0))
              for y, cb, cr in make_test_frames(1, 32, 32)]
    bs = lavc.encode_x264(frames, qp=30, profile="high422", cabac=False, bframes=0,
                          csp="yuv422p")
    with GpuDecoder(device="cpu") as dec, pytest.raises(NotImplementedError,
                                                          match="ROADMAP"):
        dec.decode_stream(bs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli_main(["serve"])


def test_close_stops_worker_threads():
    dec = GpuDecoder(device="cpu")
    bs = lavc.encode_x264(make_test_frames(2, 32, 32), qp=30, profile="main",
                          cabac=True, bframes=0, extra_x264="slices=2")
    dec.decode_stream(bs)
    workers = [dec._recon_exec, dec._slice_exec]
    dec.close()
    assert dec._recon_exec is None and dec._slice_exec is None
    for ex in workers:
        assert all(not t.is_alive() for t in ex._threads)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "h264decode_tpu"), (path, mod)
    code = ("import sys, pkgutil, importlib, h264decode_tpu_torch as P\n"
            "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
            "    if not m.name.endswith('__main__'):\n"
            "        importlib.import_module(m.name)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'h264decode_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
