"""The port's frame program and decoder on the CPU, against the JAX package
and libavcodec. Every comparison is bit-exact (tolerance 0)."""

import ast
import json
import os
import socket
import subprocess
import sys
import threading
import time

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
from chip_smoke import md5s, y4m_md5s
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


def to_format(frames, csp, seed=0):
    """8-bit 4:2:0 test frames -> planes for x264's pixel format csp: gray
    keeps luma; 4:2:2 and 4:4:4 widen the chroma (with row detail of its
    own for 4:2:2); 10-bit formats scale by 4 and fill the low bits."""
    rng = np.random.default_rng(seed)
    out = []
    for y, cb, cr in frames:
        if csp == "gray":
            out.append((y,))
            continue
        if "422" in csp or "444" in csp:
            rows = np.arange(2 * cb.shape[0])[:, None]
            cb = np.clip(np.repeat(cb, 2, 0) + (8 * np.sin(rows / 3.0)).astype(int), 0, 255)
            cr = np.clip(np.repeat(cr, 2, 0) - (8 * np.cos(rows / 5.0)).astype(int), 0, 255)
        if "444" in csp:
            cb, cr = np.repeat(cb, 2, 1), np.repeat(cr, 2, 1)
        planes = [np.asarray(p, np.uint8) for p in (y, cb, cr)]
        if "10" in csp:
            planes = [(p.astype(np.uint16) << 2) | rng.integers(0, 4, p.shape, np.uint16)
                      for p in planes]
        out.append(tuple(planes))
    return out


def assert_frames_equal(golden, ours):
    """Bit-exact planes, dtype included. libavcodec returns no chroma for a
    monochrome stream; the decoder's chroma is then the mid-gray fill."""
    assert len(golden) == len(ours)
    for fi, (g, o) in enumerate(zip(golden, ours)):
        for name, gp, op in zip("y cb cr".split(), g.planes(), o.planes()):
            gp, op = np.asarray(gp), np.asarray(op)
            if gp.size == 0:
                mid = 1 << (8 * g.y.itemsize - 1)
                assert op.shape == ((g.y.shape[0] + 1) // 2, (g.y.shape[1] + 1) // 2)
                assert (op == mid).all(), (fi, name)
                continue
            assert gp.dtype == op.dtype, (fi, name)
            assert np.array_equal(gp, op), (fi, name)


def gpu_decode_cpu(bs):
    with GpuDecoder(device="cpu") as dec:
        return dec.decode_stream(bs)


def _record_jax_frame_steps(monkeypatch):
    """Record every call of the JAX package's frame_step as numpy: (wire,
    input rings, dyn, mb_h, mb_w, flags, outputs (rings..., packed))."""
    calls = []
    orig = tpu_pipeline.frame_step

    def record(wire, ry, rcb, rcr, dyn, mb_h, mb_w, n_refs, flags):
        out = orig(wire, ry, rcb, rcr, dyn, mb_h, mb_w, n_refs, flags)
        calls.append((
            {k: np.asarray(v) for k, v in wire.items()},
            (np.asarray(ry), np.asarray(rcb), np.asarray(rcr)),
            {k: (v if k == "qp_offsets" else np.asarray(v)) for k, v in dyn.items()},
            mb_h, mb_w, flags, [np.asarray(o) for o in out],
        ))
        return out

    monkeypatch.setattr(tpu_pipeline, "frame_step", record)
    return calls


def _port_frame_step_matches(call):
    """Run one recorded JAX frame through the port's frame_step: the packed
    output and every ring must be identical. The JAX flags are a 9-tuple
    with cf3 at index 4; the port's an 8-tuple with the ChromaArrayType."""
    wire, rings, dyn, mb_h, mb_w, flags, jout = call
    has_l8, has_pcm, apply_db, sparse, cf3, has_intra, cf2, bd, need_s2 = flags
    cat = 3 if cf3 else (2 if cf2 else 1)
    # the JAX rings hold Cb and Cr apart above 8 bits and for 4:4:4
    n_rings = 3 if bd > 8 or cf3 else 2
    t_wire, t_dyn = convert.wire_from_numpy(wire, dyn)
    ring_y, ring_c = convert.ring_from_jax(*rings[:n_rings])
    packed = gpu_pipeline.frame_step(
        t_wire, ring_y, ring_c, t_dyn, mb_h, mb_w,
        (has_l8, has_pcm, apply_db, sparse, has_intra, need_s2, cat, bd),
        int(wire["slot_idx"][0]),
    )
    jpacked = jout[-1]
    assert packed.shape == jpacked.shape
    np.testing.assert_array_equal(packed.numpy().view(jpacked.dtype), jpacked)
    ey, ec = convert.ring_from_jax(*jout[:n_rings])
    assert torch.equal(ring_y, ey)
    assert torch.equal(ring_c, ec)


def test_frame_step_matches_jax_on_weighted_p_frame(monkeypatch):
    """The same wire and ring through both frame programs."""
    frames = fade_frames(3, 64, 64)
    bs = lavc.encode_x264(frames, qp=26, profile="main", cabac=True, bframes=0,
                          extra_x264="weightp=2")
    calls = _record_jax_frame_steps(monkeypatch)
    tpu_pipeline.TpuDecoder().decode_stream(bs)
    weighted = [c for c in calls if "w_tab" in c[0]]
    assert weighted, "x264 coded no weighted P frame"
    wire = weighted[0][0]
    assert (wire["w_tab"] != 32).any() or (wire["o_tab"] != 0).any()
    _port_frame_step_matches(weighted[0])


def test_frame_step_matches_jax_on_high422_10bit_weighted_frame(monkeypatch):
    """High 4:2:2 10-bit: full-height chroma, the 2x4 chroma DC, 4:2:2 MC,
    16-bit rings and scaled weight offsets, through both frame programs."""
    frames = to_format(fade_frames(3, 64, 96), "yuv422p10le")
    bs = lavc.encode_x264(frames, qp=26, profile="high422", csp="yuv422p10le", cabac=True,
                          bframes=0, extra_x264="weightp=2:8x8dct=1")
    calls = _record_jax_frame_steps(monkeypatch)
    tpu_pipeline.TpuDecoder().decode_stream(bs)
    weighted = [c for c in calls if "w_tab" in c[0]]
    assert weighted, "x264 coded no weighted P frame"
    wire, _, _, _, _, flags, jout = weighted[0]
    assert flags[6] and flags[7] == 10  # 4:2:2, 10-bit
    assert (wire["o_tab"] != 0).any()  # offsets that the bit depth scales
    assert jout[-1].shape == (2 * 64, 96) and jout[-1].dtype == np.uint16
    _port_frame_step_matches(weighted[0])


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
    "high422_10_weighted": dict(profile="high422", csp="yuv422p10le", cabac=True, bframes=2,
                                extra_x264="weightp=2:8x8dct=1"),
    "high422_8": dict(profile="high422", csp="yuv422p", cabac=False, bframes=1),
    "high10_weighted": dict(profile="high10", csp="yuv420p10le", cabac=True, bframes=2,
                            extra_x264="weightp=2:weightb=1"),
    "mono": dict(profile="high", csp="gray", cabac=True, bframes=1, extra_x264="8x8dct=1"),
    "high444_8": dict(profile="high444", csp="yuv444p", cabac=True, bframes=2,
                      extra_x264="weightp=2:8x8dct=1"),
    "high444_8_cavlc_slices": dict(profile="high444", csp="yuv444p", cabac=False, bframes=1,
                                   extra_x264="slices=3:ref=3"),
    # routed to the numpy oracle, as in the JAX package
    "mbaff": dict(profile="high", cabac=True, bframes=0, extra_x264="interlaced=1"),
    "lossless": dict(qp=0, profile="main", cabac=True, bframes=0),
    "high444_10": dict(profile="high444", csp="yuv444p10le", cabac=True, bframes=1),
}
ORACLE_STREAMS = {"mbaff", "lossless", "high444_10"}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_gpu_decoder_cpu_matches_libavcodec(name):
    weighted = "weightp" in STREAMS[name].get("extra_x264", "")
    frames = fade_frames(4, 144, 176, seed=5) if weighted else \
        make_test_frames(4, 144, 176, seed=6)
    kw = {"qp": 27, **STREAMS[name]}
    bs = lavc.encode_x264(to_format(frames, kw.get("csp", "yuv420p")), **kw)
    native.calls.clear()
    with GpuDecoder(device="cpu") as dec:
        ours = dec.decode_stream(bs)
        # the frame program ran unless the stream's class is the oracle's
        assert (dec._ring is None) == (name in ORACLE_STREAMS)
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
        fmt = dict(chroma_array_type=1, bit_depth_luma=8)
        cif = SimpleNamespace(max_num_ref_frames=3, frame_height_in_mbs=18,
                              pic_width_in_mbs=22, **fmt)
        assert not dec._ring_over_budget(cif)  # fits: stays on the card
        uhd = SimpleNamespace(max_num_ref_frames=16, frame_height_in_mbs=135,
                              pic_width_in_mbs=240, **fmt)
        with pytest.raises(MemoryError, match="DPB rings"):
            dec._ring_over_budget(uhd)


@pytest.mark.parametrize("cat,bd", [(0, 8), (1, 8), (2, 8), (1, 10), (2, 10), (3, 8)])
def test_ring_bytes_count_what_the_decoder_allocates(cat, bd):
    """ring_bytes (the budget guard's measure) counts the rings _ensure_ring
    allocates: full-height 4:2:2 chroma, 2-byte samples above 8 bits, the
    mid-gray chroma ring of monochrome, and 4:4:4's Cb and Cr half-pel
    stacks."""
    from types import SimpleNamespace

    sps = SimpleNamespace(max_num_ref_frames=2, frame_height_in_mbs=4, pic_width_in_mbs=6,
                          chroma_array_type=cat, bit_depth_luma=bd)
    with GpuDecoder(device="cpu") as dec:
        dec._ensure_ring(sps)
        ring_y, ring_c = dec._ring
        assert ring_y.dtype == (torch.uint8 if bd == 8 else torch.int16)
        assert ring_c.shape[-2] == (64 if cat in (2, 3) else 32) + 2 * 8
        assert ring_c.shape[-1] == (96 if cat == 3 else 48) + 2 * 8
        assert ring_c.shape[:3] == ((3, 2, 4) if cat == 3 else (3, 2, ring_c.shape[2]))
        got = sum(t.numel() * t.element_size() for t in dec._ring)
    assert got == GpuDecoder.ring_bytes(sps)


def test_cli_decodes_cif_smoke_stream_to_committed_md5s(tmp_path):
    with open(os.path.join(DATA, "smoke_md5.json")) as f:
        want = json.load(f)["smoke_cif_high.h264"]
    out = tmp_path / "out.y4m"
    assert cli_main(["decode", os.path.join(DATA, "smoke_cif_high.h264"), str(out),
                     "--device", "cpu"]) == 0
    assert y4m_md5s(str(out), want) == want["frames"]


@pytest.mark.parametrize("name", ["smoke_cif_high10.h264", "smoke_cif_gray.h264",
                                  "smoke_cif_high444.h264"])
def test_cli_decodes_new_format_smoke_streams_to_committed_md5s(tmp_path, name):
    """High 10 (uint16 samples in the Y4M), monochrome (mid-gray 4:2:0
    chroma) and High 4:4:4 Predictive 8-bit (full-size chroma, the JVT
    scaling lists) through the CLI, to the committed libavcodec MD5s."""
    with open(os.path.join(DATA, "smoke_md5.json")) as f:
        want = json.load(f)[name]
    out = tmp_path / "out.y4m"
    assert cli_main(["decode", os.path.join(DATA, name), str(out), "--device", "cpu"]) == 0
    got = y4m_md5s(str(out), want)
    assert len(got) == len(want["frames"]) == 8
    assert got == want["frames"]


def test_gpu_decoder_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GpuDecoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["decode", os.path.join(DATA, "smoke_cif_high.h264"), "unused.y4m"])
    # serve makes its first decoder before it listens: no card, no server
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["serve", "--port", "0", "--once"])
    GpuDecoder(device="cpu").close()


def test_unported_formats_raise(monkeypatch):
    """Every stream format and every backend of the JAX package is ported:
    the multi-device backends sharded and gop no longer raise
    NotImplementedError. Like the gpu backend, their mesh takes CUDA
    devices unless --device cpu asks for the CPU, so without a card they
    raise for want of one."""
    from h264decode_tpu_torch.cli import main as cli_mod
    from h264decode_tpu_torch.dist.decoder import ShardedDecoder
    from h264decode_tpu_torch.dist.gop import GopParallelDecoder

    assert not hasattr(cli_mod, "_NOT_PORTED")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend, cls in (("sharded", ShardedDecoder), ("gop", GopParallelDecoder)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_main(["decode", os.path.join(DATA, "smoke_cif_high.h264"), "unused.y4m",
                      "--backend", backend])
        dec = cli_mod._make_decoder(backend, True, "cpu", mesh="1x2")
        assert isinstance(dec, cls) and dec.mesh.shape == {"gop": 1, "row": 2}


def test_serve_once_on_cpu_matches_libavcodec(tmp_path, capsys):
    """`serve --once --port 0 --device cpu` on a thread: it prints the port
    it bound, decodes the stream sent over one TCP connection into
    stream_0.y4m with a decoder of its own, and returns once the file is
    written; the frames equal libavcodec's."""
    bs = lavc.encode_x264(make_test_frames(3, 64, 64, seed=12), qp=28, profile="main",
                          cabac=True, bframes=1)
    rc = []
    srv = threading.Thread(target=lambda: rc.append(cli_main(
        ["serve", "--once", "--port", "0", "--device", "cpu", "--out-dir", str(tmp_path)])))
    srv.start()
    out, deadline = "", time.time() + 60
    while "listening on" not in out and time.time() < deadline:
        time.sleep(0.05)
        out += capsys.readouterr().out
    port = int(out.split("listening on ")[1].split(";")[0].rsplit(":", 1)[1])
    with socket.create_connection(("127.0.0.1", port)) as conn:
        for i in range(0, len(bs), 1000):  # in pieces, as a network delivers it
            conn.sendall(bs[i : i + 1000])
    srv.join(timeout=120)
    assert not srv.is_alive() and rc == [0]
    golden = lavc.decode_annexb(bs)
    want = dict(width=64, height=64, bit_depth=8, chroma="420")
    assert y4m_md5s(str(tmp_path / "stream_0.y4m"), want) == [md5s(g.planes())
                                                              for g in golden]


def test_close_stops_worker_threads():
    dec = GpuDecoder(device="cpu")
    bs = lavc.encode_x264(make_test_frames(2, 32, 32), qp=30, profile="main",
                          cabac=True, bframes=0, extra_x264="slices=2")
    dec.decode_stream(bs)
    workers = [dec._recon_exec, dec._picture_exec, dec._slice_exec]
    dec.close()
    assert dec._recon_exec is None and dec._picture_exec is None and dec._slice_exec is None
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
    dist = {os.path.basename(f) for f in files if os.path.dirname(f).endswith("dist")}
    assert {"mesh.py", "sharded.py", "decoder.py", "gop.py", "multihost.py"} <= dist
    assert os.path.join(PKG, "tools", "perf_probe.py") in files
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
