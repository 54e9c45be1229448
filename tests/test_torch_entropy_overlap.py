"""GpuDecoder's pictures in flight, on the CPU: each picture on the native
engine decodes its entropy as a task beside the main thread
(pipeline/decoder.py _decode_entropy, run by GpuDecoder._submit_entropy),
a B picture's task waiting only for its colocated picture's, the recon
worker only for the picture it builds.

Every frame stays bit-exact with libavcodec with several pictures' engine
calls running at once; the colocated arrays of a picture that marking has
removed from the DPB are kept while a B picture in flight still reads them
(pipeline/dpb.py colocated_arrays); picture N+1's engine call starts before
picture N's returns, and a B picture's only once its colocated picture is
decoded; the strict policy still raises an engine failure out of
decode_iter and no frame of the failed picture gives pixels; the skip
policy, which decodes each picture's entropy on the main thread, gives
the frames and the error count it gave when every picture did."""

import contextlib
import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from chip_smoke import md5s
from h264decode_tpu_torch.entropy import native
from h264decode_tpu_torch.golden import lavc
from h264decode_tpu_torch.pipeline import decoder as decoder_mod
from h264decode_tpu_torch.pipeline import dpb as dpb_mod
from h264decode_tpu_torch.pipeline.gpu_pipeline import GpuDecoder
from tests.conftest import make_test_frames
from tests.test_torch_host_pool import _mbaff_b_stream
from tests.test_torch_pipeline import fade_frames

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "h264decode_tpu_torch", "data")
pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="the native entropy engine is off (H264_NATIVE=0)")
# how long the held engine calls and gates wait before a test gives up
PATIENCE_S = 60


def _committed(name):
    with open(os.path.join(DATA, name), "rb") as f:
        bs = f.read()
    with open(os.path.join(DATA, "smoke_md5.json")) as f:
        return bs, json.load(f)[name]["frames"]


def _golden(bs):
    return bs, [md5s((f.y, f.cb, f.cr)) for f in lavc.decode_annexb(bs)]


def _first_headers_only(bs: bytes) -> bytes:
    """The stream with its first SPS and PPS and no repeat of them: x264
    repeats both before every IDR, and a new SPS starts a new DPB."""
    starts = [m.start() for m in re.finditer(b"\x00\x00\x01", bs)]
    out, seen = [], set()
    for i, at in enumerate(starts):
        nal = bs[at: starts[i + 1] if i + 1 < len(starts) else len(bs)]
        kind = nal[3] & 0x1F
        if kind in (7, 8) and kind in seen:
            continue
        seen.add(kind)
        out.append(b"\x00" + nal.rstrip(b"\x00"))  # a 4-byte start code each
    return b"".join(out)


def _panning(n: int, h: int, w: int):
    """A smooth pattern panned by a velocity that changes every 4 frames,
    so that no two GOPs share their motion; the third GOP stands still
    (its P picture's colocated blocks all read as colZero in spatial
    direct, 8.4.1.2.2, where the second GOP's read as moving)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    frames, ox, oy = [], 0, 0
    for i in range(n):
        x, y = xx + ox, yy + oy
        luma = 128 + 60 * np.sin(x / 7.0) * np.cos(y / 9.0) + (x + y) % 32
        frames.append((np.clip(luma, 0, 255).astype(np.uint8),
                       np.full((h // 2, w // 2), 128, np.uint8),
                       np.full((h // 2, w // 2), 128, np.uint8)))
        vx, vy = ((2, 0), (3, 1), (0, 0), (4, -1))[i // 4 % 4]
        ox, oy = ox + vx, oy + vy
    return frames


def _ibbp(direct: str, n: int = 16):
    """QCIF Main CABAC, IDR P B B in decode order every 4 frames (closed
    GOPs, fixed B placement, non-reference B pictures) and `direct`
    prediction, under one SPS: every B picture's RefPicList1[0] is the P
    just before it."""
    return _first_headers_only(lavc.encode_x264(
        _panning(n, 144, 176), qp=28, profile="main", cabac=True, bframes=2,
        preset="fast", gop=4, extra_x264=f"direct={direct}:scenecut=0:b-pyramid=none:b-adapt=0"))


STREAMS = {
    "smoke_cif_high": lambda: _committed("smoke_cif_high.h264"),
    "smoke_cif_main_slices2_nodb": lambda: _committed("smoke_cif_main_slices2_nodb.h264"),
    "x264_temporal_direct": lambda: _golden(lavc.encode_x264(
        make_test_frames(8, 144, 176, seed=12), qp=28, profile="main", cabac=True, bframes=2,
        preset="fast", extra_x264="direct=temporal")),
    "mbaff_b": lambda: _golden(_mbaff_b_stream()),
    "weighted": lambda: _golden(lavc.encode_x264(
        fade_frames(6, 144, 176, seed=5), qp=27, profile="main", cabac=True, bframes=2,
        extra_x264="weightp=2:weightb=1")),
}


def _spy_engine(monkeypatch, before=None):
    """Wrap the engine call: `before(state, hdr, ref_uids_l1)` runs first,
    on the calling thread. Returns the list of (picture's state id,
    "start"/"end", thread) events, in order."""
    decode_slice = native.decode_slice_native
    events, lock = [], threading.Lock()

    def spy(state, hdr, sps, pps, rbsp, slice_id, l0, l1, direct_ctx, **kw):
        with lock:
            events.append((id(state), "start", threading.get_ident()))
        try:
            if before is not None:
                before(state, hdr, l1)
            return decode_slice(state, hdr, sps, pps, rbsp, slice_id, l0, l1, direct_ctx, **kw)
        finally:
            with lock:
                events.append((id(state), "end", threading.get_ident()))

    monkeypatch.setattr(native, "decode_slice_native", spy)
    return events


def _peak_pictures(events) -> int:
    """The most pictures that had an engine call running at once."""
    running: dict = {}
    peak = 0
    for pic, what, _ in events:
        running[pic] = running.get(pic, 0) + (1 if what == "start" else -1)
        peak = max(peak, sum(1 for v in running.values() if v > 0))
    return peak


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_bit_exact_with_pictures_in_flight(name, monkeypatch):
    """Each engine call is held 100 ms, so the main thread sets up the next
    pictures meanwhile: at least two pictures' calls run at once, and
    every frame equals libavcodec's."""
    bs, want = STREAMS[name]()
    events = _spy_engine(monkeypatch, lambda *_: time.sleep(0.1))
    with GpuDecoder(device="cpu") as dec:
        got = [md5s(f.planes()) for f in dec.decode_iter(bs)]
    assert got == want
    assert _peak_pictures(events) >= 2
    main = threading.get_ident()
    assert all(t != main for _, _, t in events)  # every call off the main thread


@pytest.mark.parametrize("direct", ["spatial", "temporal"])
def test_colocated_arrays_outlive_the_dpb_while_read(direct, monkeypatch):
    """Each B picture's engine calls wait until the reference picture after
    the next IDR has written its colocated arrays: by then the IDR's marking
    has removed the B picture's RefPicList1[0] (the P before it) from the
    DPB, and that P's set would be the first free one. The frames stay
    bit-exact only if the set is kept for the B pictures in flight that read
    it."""
    bs, want = _golden(_ibbp(direct))
    gop_of: dict[int, int] = {}  # picture uid -> its GOP, from the marking
    idr_uid: dict[int, int] = {}  # GOP -> its IDR's uid
    released = {g: threading.Event() for g in range(len(want) // 4)}
    held = []
    mark, fill = dpb_mod.DPB.mark, decoder_mod.fill_colocated

    def marking(self, pic, hdr):
        if hdr.idr_pic_flag:
            idr_uid[len(idr_uid)] = pic.uid
        gop_of[pic.uid] = len(idr_uid) - 1
        return mark(self, pic, hdr)

    def filling(pic, ft, motion):
        fill(pic, ft, motion)
        for g, uid in list(idr_uid.items()):
            if g and pic.uid > uid:  # a picture after GOP g's IDR: release g - 1
                released[g - 1].set()

    def hold_b(state, hdr, l1):
        if hdr.is_b and gop_of[l1[0]] + 1 < len(released):  # the last GOP has no next IDR
            held.append(released[gop_of[l1[0]]].wait(timeout=PATIENCE_S))

    monkeypatch.setattr(dpb_mod.DPB, "mark", marking)
    monkeypatch.setattr(decoder_mod, "fill_colocated", filling)
    _spy_engine(monkeypatch, hold_b)
    with GpuDecoder(device="cpu") as dec:
        # the planes are read after the decode: an IDR hands out the frames
        # of the GOP before it, whose B pictures are still held
        got = [md5s(f.planes()) for f in dec.decode_stream(bs)]
    assert len(held) == 6 and all(held)  # two B pictures in each of 3 GOPs
    assert got == want


def test_next_picture_starts_before_this_one_returns(monkeypatch):
    """I P P P: the IDR's engine call is held until the first P's starts
    (a P picture waits for no earlier picture's entropy); were the pictures
    decoded one after another, it would wait in vain."""
    bs, want = _golden(lavc.encode_x264(make_test_frames(4, 144, 176, seed=13), qp=28,
                                        profile="main", cabac=True, bframes=0))
    p_started = threading.Event()
    seen = []

    def gate(state, hdr, l1):
        if hdr.frame_num == 1:
            p_started.set()
        elif hdr.idr_pic_flag:
            seen.append(p_started.wait(timeout=PATIENCE_S))

    events = _spy_engine(monkeypatch, gate)
    with GpuDecoder(device="cpu") as dec:
        # the planes are read after the decode: with no reordering, reading
        # each frame as it is yielded would wait for its picture first
        got = [md5s(f.planes()) for f in dec.decode_stream(bs)]
    assert seen == [True] and got == want
    idr = events[0][0]
    p_start = next(i for i, (pic, what, _) in enumerate(events) if pic != idr)
    assert p_start < events.index((idr, "end", events[0][2]))  # before the IDR's call ended


def test_b_picture_waits_for_its_colocated_picture(monkeypatch):
    """IDR P B B: each B picture's first engine call starts after its
    colocated P has written its colocated arrays, although the P's call is
    held 50 ms."""
    bs, want = _golden(_ibbp("temporal", n=8))
    filled: dict[int, float] = {}
    starts = []
    fill = decoder_mod.fill_colocated

    def filling(pic, ft, motion):
        fill(pic, ft, motion)
        filled[pic.uid] = time.perf_counter()

    def timing(state, hdr, l1):
        if hdr.is_b:
            starts.append((l1[0], time.perf_counter()))
        elif hdr.is_p:
            time.sleep(0.05)

    monkeypatch.setattr(decoder_mod, "fill_colocated", filling)
    _spy_engine(monkeypatch, timing)
    with GpuDecoder(device="cpu") as dec:
        got = [md5s(f.planes()) for f in dec.decode_iter(bs)]
    assert got == want and len(starts) == 4
    assert all(col in filled and t > filled[col] for col, t in starts)


def _failing_engine(monkeypatch, fails):
    """The engine raises on the call for which fails(n, hdr) holds, n
    counting the calls from 1."""
    decode_slice = native.decode_slice_native
    n = [0]
    lock = threading.Lock()

    def failing(state, hdr, *args, **kw):
        with lock:
            n[0] += 1
            fail = fails(n[0], hdr)
        if fail:
            raise ValueError("native slice decode failed: -1")
        return decode_slice(state, hdr, *args, **kw)

    monkeypatch.setattr(native, "decode_slice_native", failing)


@pytest.mark.parametrize("read_planes", [True, False])
def test_strict_policy_raises_out_of_decode_iter(read_planes, monkeypatch):
    """The first P picture of the CIF High stream fails in its task: the
    error comes out of decode_iter (or out of a yielded frame's planes,
    when the caller reads them); the frames whose planes were read before
    it are libavcodec's, in order, and none of the failed picture or after
    it gives pixels."""
    bs, want = _committed("smoke_cif_high.h264")
    failed = []
    _failing_engine(monkeypatch, lambda n, hdr: hdr.is_p and not failed
                    and not failed.append(n))
    dec = GpuDecoder(device="cpu")
    got, frames = [], 0
    with pytest.raises(ValueError, match="native slice decode failed"):
        for f in dec.decode_iter(bs):
            frames += 1
            if read_planes:
                got.append(md5s(f.planes()))
    with contextlib.suppress(ValueError):  # close() drains what is still pending
        dec.close()
    assert len(failed) == 1 and frames < len(want)
    assert got == want[: len(got)] and bool(got) == read_planes


def _skip_cases():
    bs = lavc.encode_x264(make_test_frames(5, 144, 176), qp=26, profile="main", cabac=True,
                          bframes=0)
    flipped = bytearray(bs)
    flipped[len(bs) // 2] ^= 0xFF
    return {"truncated": (bs[: len(bs) // 2], None), "bitflip": (bytes(flipped), None),
            "engine_failure": (bs, 3)}


# error_policy="skip": (errors, each frame's plane MD5s) of _skip_cases()
# as GpuDecoder decoded them when every picture's entropy decode ran inline
# on the decoding thread
SKIP_OUTPUTS = {
    "truncated": (1, [
        ["e7de82c779d60e2dd46109d3344a386d", "ac042580d35bedce212536c15433a62b", "e78b2d1a9914edcdd67ddacc80d5201e"],
        ["445dbd0876040716bad07c9fe699abcd", "56d47925f4992f6df844d6a8c5d10f02", "abb35852feb2c3acfd3c61a409d3f7db"],
    ]),
    "bitflip": (0, [
        ["e7de82c779d60e2dd46109d3344a386d", "ac042580d35bedce212536c15433a62b", "e78b2d1a9914edcdd67ddacc80d5201e"],
        ["445dbd0876040716bad07c9fe699abcd", "56d47925f4992f6df844d6a8c5d10f02", "abb35852feb2c3acfd3c61a409d3f7db"],
        ["23094522d3ece6dce3fe85cae3891231", "9daed9b3bc46f87ce40efb7110b1ff68", "eff40b1831adde42e46ed1a73209bcd9"],
        ["4569f56e76363dfb1cbc72fedd1fb0ef", "a108c2f9954c8f1f33eb857964449d0b", "35b1a7084af7bdf2c4fe20888bdf3903"],
        ["12e1033a245227958e58c146d6f7517a", "1b068d2e444dbea50a74c25e9a44752d", "cc9aaf2e850ef2eb9392203ce127d815"],
    ]),
    "engine_failure": (3, [
        ["e7de82c779d60e2dd46109d3344a386d", "ac042580d35bedce212536c15433a62b", "e78b2d1a9914edcdd67ddacc80d5201e"],
        ["445dbd0876040716bad07c9fe699abcd", "56d47925f4992f6df844d6a8c5d10f02", "abb35852feb2c3acfd3c61a409d3f7db"],
    ]),
}


@pytest.mark.parametrize("case", sorted(SKIP_OUTPUTS))
def test_skip_policy_gives_the_inline_outputs(case, monkeypatch):
    """error_policy="skip" runs each picture's task on the main thread
    (depth 1), so a failed picture is dropped before its marking: the
    error count and every frame are what they were with the entropy decode
    inline (the third picture's engine call failing, in "engine_failure")."""
    data, fail_at = _skip_cases()[case]
    if fail_at is not None:
        _failing_engine(monkeypatch, lambda n, hdr: n == fail_at)
    events = _spy_engine(monkeypatch)
    with GpuDecoder(device="cpu") as dec:
        dec.error_policy = "skip"
        got = [md5s(f.planes()) for f in dec.decode_stream(data)]
    assert (dec.error_count, got) == (SKIP_OUTPUTS[case][0],
                                      [list(t) for t in SKIP_OUTPUTS[case][1]])
    assert {t for _, _, t in events} == {threading.get_ident()}
