"""The decoder's per-picture host buffers on the CPU: the FramePool that
hands a picture its FrameTensors, MotionContext, intra mode grid and
NativeFrameState (entropy/native.py) and takes them back once the recon
worker has built the wire, and the colocated-motion arrays that only a
reference picture carries (pipeline/dpb.py colocated_motion).

A released set must read as a freshly made one (exact equality of every
array), no set may be handed out while another picture holds it, a splice
of streams of different geometry stays bit-exact with libavcodec, and the
one-pass colocated arrays equal the expressions they replaced (kept here)
on every reference picture of B streams, frame and MBAFF field coded."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from chip_smoke import md5s
from h264decode_tpu_torch.entropy import native
from h264decode_tpu_torch.golden import lavc
from h264decode_tpu_torch.pipeline import decoder as decoder_mod
from h264decode_tpu_torch.pipeline import dpb as dpb_mod
from h264decode_tpu_torch.pipeline.decoder import Decoder
from h264decode_tpu_torch.pipeline.gpu_pipeline import RECON_DEPTH, GpuDecoder
from h264decode_tpu_torch.tensors.frame_tensors import MB_I_PCM
from tests.conftest import make_test_frames
from tests.synth import pcm_frame_planes, pcm_slice, write_pps, write_sps

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "h264decode_tpu_torch", "data")
pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="the native entropy engine is off (H264_NATIVE=0)")


def _committed(name):
    with open(os.path.join(DATA, name), "rb") as f:
        bs = f.read()
    with open(os.path.join(DATA, "smoke_md5.json")) as f:
        return bs, json.load(f)[name]["frames"]


def _pcm_stream():
    """I_PCM macroblocks in an IDR and in a P picture (4x3 MBs): PCM sets
    the luma nnz without any residual level."""
    mb_w, mb_h = 4, 3
    a, b = (pcm_frame_planes(mb_w, mb_h, seed=s) for s in (2, 3))
    every = list(range(mb_w * mb_h))
    return (write_sps(mb_w, mb_h) + write_pps() + pcm_slice(a, every, mb_w)
            + pcm_slice(b, every, mb_w, slice_type=5, frame_num=1, idr=False, ref_idc=1,
                        poc_lsb=2))


def _arrays(state):
    """Every buffer of a NativeFrameState's set, by name."""
    ft, motion = state.ft, state.motion
    out = {f"ft.{name}": getattr(ft, name) for name, *_ in ft._layout()
           if getattr(ft, name) is not None}
    out.update({f"motion.{k}": getattr(motion, k)
                for k in ("mv", "ref", "absmvd", "refctx", "direct")})
    out.update({"modes": state.modes, "decode_order": state.decode_order,
                "n_decoded": state.n_decoded, "pcm_y": state.pcm_y, "pcm_cb": state.pcm_cb,
                "pcm_cr": state.pcm_cr})
    return out


def _fresh(state):
    return native.FramePool().take(state.ft.mb_h, state.ft.mb_w, state.ft.chroma_format,
                                   16 if state._pcm_dtype == np.uint16 else 8)


@pytest.mark.parametrize("name", ["smoke_cif_high.h264", "smoke_cif_main_slices2_nodb.h264",
                                  "pcm"])
def test_released_set_reads_as_a_fresh_one(name, monkeypatch):
    """Every array of every set GpuDecoder(device="cpu") gives back (cleared
    on the recon worker, at the coded rows only for a sparse frame) equals
    a freshly made set's, as do its PCM samples, decode order and coded
    rows; the frames stay bit-exact. Between them the streams reset dense I
    frames, sparse P and B frames, 8x8 transforms, several slices and PCM
    in a sparse frame."""
    if name == "pcm":
        bs = _pcm_stream()
        want = [md5s(f.planes()) for f in lavc.decode_annexb(bs)]
    else:
        bs, want = _committed(name)
    kinds, bad = [], []
    reset = native.NativeFrameState.reset

    def checked(self):
        ft = self.ft
        kinds.append(("sparse" if "l" in (ft.coded or {}) else "dense",
                      bool(ft.transform_8x8.any()), bool((ft.mb_class == MB_I_PCM).any())))
        reset(self)
        fresh = _fresh(self)
        for k, a in _arrays(self).items():
            b = _arrays(fresh)[k]
            if a.dtype != b.dtype or not np.array_equal(a, b):
                bad.append((len(kinds), k))
        if ft.pcm_samples or ft.decode_order or ft.coded is not None or self._keepalive:
            bad.append((len(kinds), "python state"))

    monkeypatch.setattr(native.NativeFrameState, "reset", checked)
    with GpuDecoder(device="cpu") as dec:
        got = [md5s(f.planes()) for f in dec.decode_stream(bs)]
    assert got == want
    assert len(kinds) == len(want) and not bad, bad
    if name == "pcm":
        assert ("sparse", False, True) in kinds  # the PCM P picture
    else:
        assert {"sparse", "dense"} == {k for k, *_ in kinds}
        assert any(t8 for _, t8, _ in kinds) == (name == "smoke_cif_high.h264")


def test_no_set_is_handed_out_while_held(monkeypatch):
    """With RECON_DEPTH pictures held back on the recon worker and one more
    in the entropy decode, no two sets held at once share any memory, and
    the pool grows to them rather than blocking."""
    bs, want = _committed("smoke_cif_high.h264")
    held: list = []
    lock = threading.Lock()
    gate = threading.Event()
    overlaps, peak = [], []
    take, give = native.FramePool.take, native.FramePool.give

    def taking(self, *args, **kw):
        state = take(self, *args, **kw)
        with lock:
            mine = list(_arrays(state).values())
            for other in held:
                overlaps.extend(k for k, a in _arrays(other).items()
                                if any(np.may_share_memory(a, b) for b in mine))
            held.append(state)
            peak.append(len(held))
            if len(held) > RECON_DEPTH:
                gate.set()
        return state

    def giving(self, ft):
        with lock:
            held[:] = [s for s in held if s.ft is not ft]
        give(self, ft)

    reconstruct = GpuDecoder._reconstruct

    def held_back(self, *args, **kw):
        gate.wait(timeout=60)
        return reconstruct(self, *args, **kw)

    monkeypatch.setattr(native.FramePool, "take", taking)
    monkeypatch.setattr(native.FramePool, "give", giving)
    monkeypatch.setattr(GpuDecoder, "_reconstruct", held_back)
    with GpuDecoder(device="cpu") as dec:
        got = [md5s(f.planes()) for f in dec.decode_stream(bs)]
        sets = len(dec._frames._idle)
    assert got == want
    assert not overlaps, overlaps
    assert max(peak) == RECON_DEPTH + 1 and sets == RECON_DEPTH + 1


def test_pool_under_thread_stress():
    """Sixteen threads (more than the cores) take and give sets of one pool
    with the switch interval shortened: no state is ever handed to two
    holders at once, and the pool keeps no more sets than can be held at
    once (one a thread)."""
    pool = native.FramePool()
    lock = threading.Lock()
    out, twice = set(), []

    def work():
        for _ in range(200):
            state = pool.take(2, 3, 1, 8)
            with lock:
                if id(state) in out:
                    twice.append(id(state))
                out.add(id(state))
            state.ft.qp[0] = 1  # a picture's write, undone by the reset
            with lock:
                out.discard(id(state))
            pool.give(state.ft)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not twice and pool._out == {}
    assert 1 <= len(pool._idle) <= 16
    assert all(s.ft.qp[0] == 0 for s in pool._idle)


def test_geometry_splice_is_bit_exact():
    """QCIF Main, then the CIF High stream, then QCIF again, through one
    GpuDecoder: every frame as libavcodec decodes the spliced stream, and
    the pool keeps only the sets of the geometry last taken."""
    qcif = lavc.encode_x264(make_test_frames(4, 144, 176, seed=5), qp=28, profile="main",
                            cabac=True, bframes=1, gop=4)
    cif, _ = _committed("smoke_cif_high.h264")
    bs = qcif + cif + qcif
    want = [md5s((f.y, f.cb, f.cr)) for f in lavc.decode_annexb(bs)]
    with GpuDecoder(device="cpu") as dec:
        got = [md5s(f.planes()) for f in dec.decode_stream(bs)]
        pool = dec._frames
        assert pool._key[:2] == (9, 11)
        assert all(s.ft.mb_w == 11 for s in pool._idle)
    assert len(got) == 16 and got == want


def _old_colocated(ft, motion):
    """The colocated expressions the decoder ran on every picture before
    colocated_motion replaced them."""
    use_l0 = motion.ref[0] >= 0
    use_l1 = (~use_l0) & (motion.ref[1] >= 0)
    out = {
        "col_ref_idx": np.where(
            use_l0, motion.ref[0], np.where(use_l1, motion.ref[1], -1)).astype(np.int8),
        "col_mv": np.where(use_l0[..., None], motion.mv[0],
                           np.where(use_l1[..., None], motion.mv[1], 0)).astype(np.int32),
    }
    rp = ft.ref_pic
    sel = np.where(rp[:, 0, :] >= 0, rp[:, 0, :], rp[:, 1, :])
    part_grid = (sel.reshape(ft.mb_h, ft.mb_w, 2, 2).transpose(0, 2, 1, 3)
                 .reshape(ft.mb_h * 2, ft.mb_w * 2))
    out["col_ref_uid"] = part_grid.repeat(2, axis=0).repeat(2, axis=1).astype(np.int32)
    rpar = ft.ref_parity
    sel_par = np.where(rp[:, 0, :] >= 0, rpar[:, 0, :], rpar[:, 1, :])
    out["col_ref_parity"] = (sel_par.reshape(ft.mb_h, ft.mb_w, 2, 2).transpose(0, 2, 1, 3)
                             .reshape(ft.mb_h * 2, ft.mb_w * 2).repeat(2, axis=0)
                             .repeat(2, axis=1).astype(np.int8))
    out["col_mb_field"] = ft.mb_field.copy() if ft.mb_field.any() else None
    return out


def _mbaff_b_stream():
    from tests.test_mbaff import _field_coded_frames

    return lavc.encode_x264(_field_coded_frames(n=7, mixed=True), qp=25, profile="high",
                            cabac=True, bframes=2, preset="fast", gop=4,
                            extra_x264="interlaced=1")


@pytest.mark.parametrize("name", ["smoke_cif_high.h264", "mbaff"])
def test_colocated_arrays_of_reference_pictures(name, monkeypatch):
    """On every reference picture the arrays colocated_motion writes equal
    the old expressions in value, dtype and layout; the field parities and MB field
    flags exist exactly where the picture has field MBs (the engine reads a
    parity only at a colocated field MB); no non-reference picture carries
    any; the B frames stay bit-exact."""
    if name == "mbaff":
        bs = _mbaff_b_stream()
        want = [md5s((f.y, f.cb, f.cr)) for f in lavc.decode_annexb(bs)]
    else:
        bs, want = _committed(name)
    pictures, bad = [], []
    made = dpb_mod.colocated_motion

    def compared(ft, motion, out):
        old = _old_colocated(ft, motion)
        new = made(ft, motion, out)
        for k, a in old.items():
            b = new[k]
            if k == "col_mb_field":
                ok = (a is None and b is None) or (b.dtype == np.uint8 and np.array_equal(a, b))
            elif k == "col_ref_parity" and old["col_mb_field"] is None:
                ok = b is None
            else:
                ok = b.dtype == a.dtype and b.flags.c_contiguous and np.array_equal(a, b)
            if not ok:
                bad.append((len(pictures), k))
        return new

    def picture(**kw):
        pictures.append(dpb_mod.Picture(**kw))
        return pictures[-1]

    refs = []
    submit = GpuDecoder._submit_reconstruct

    def submitting(self, ft, sps, pps, slices, *args):
        refs.append(bool(slices[0][0].nal_ref_idc))
        return submit(self, ft, sps, pps, slices, *args)

    monkeypatch.setattr(dpb_mod, "colocated_motion", compared)
    monkeypatch.setattr(decoder_mod, "Picture", picture)
    monkeypatch.setattr(GpuDecoder, "_submit_reconstruct", submitting)
    with GpuDecoder(device="cpu") as dec:
        got = [md5s(f.planes()) for f in dec.decode_stream(bs)]
    assert got == want and not bad, bad
    assert True in refs and False in refs
    for is_ref, pic in zip(refs, pictures, strict=True):
        assert (pic.col_ref_idx is not None) == is_ref
        if not is_ref:
            assert pic.col_mv is pic.col_ref_uid is pic.col_ref_parity is None
    with_fields = [p for p in pictures if p.col_mb_field is not None]
    assert bool(with_fields) == (name == "mbaff")
    assert all(p.col_ref_parity is not None for p in with_fields)


def test_multi_slice_b_stream_passes_colocated_arrays_uncopied(monkeypatch):
    """The multi-slice B stream through the base Decoder: every slice hands
    the engine its colocated picture's own arrays (no per-slice copy), the
    engine writes what it writes when its slices get copies of them (the
    old per-slice astype), and the frames stay bit-exact."""
    bs, want = _committed("smoke_cif_main_slices2_nodb.h264")
    lib = native._load()
    passed = []

    class Lib:  # the engine, recording the colocated arrays it is given
        def decode_slice(self, buf, n, bit, params, fb):
            p = params._obj
            if p.n_col:
                passed.append((p.col_mv, p.col_ref_idx, p.col_ref_uid))
            return lib.decode_slice(buf, n, bit, params, fb)

    monkeypatch.setattr(native, "_load", Lib)
    decode_slice = native.decode_slice_native
    finish = native.NativeFrameState.finish

    def run(copy):
        own, outputs = [], []
        passed.clear()

        def spy(state, hdr, sps, pps, rbsp, slice_id, l0, l1, direct_ctx, **kw):
            if direct_ctx is not None and direct_ctx.col_mv is not None:
                if copy:
                    for k in ("col_mv", "col_ref_idx", "col_ref_uid"):
                        setattr(direct_ctx, k, getattr(direct_ctx, k).copy())
                own.append(tuple(getattr(direct_ctx, k).ctypes.data
                                 for k in ("col_mv", "col_ref_idx", "col_ref_uid")))
            return decode_slice(state, hdr, sps, pps, rbsp, slice_id, l0, l1, direct_ctx, **kw)

        def snapshot(self):
            finish(self)
            outputs.append({k: a.copy() for k, a in _arrays(self).items()
                            if k.startswith(("ft.", "motion."))})

        monkeypatch.setattr(native, "decode_slice_native", spy)
        monkeypatch.setattr(native.NativeFrameState, "finish", snapshot)
        got = [md5s(f.planes()) for f in Decoder().decode_stream(bs)]
        return got, own, list(passed), outputs

    got, own, passed_own, outputs = run(copy=False)
    got_c, own_c, passed_c, outputs_c = run(copy=True)
    assert got == want and got_c == want
    # two slices a B picture, decoded concurrently: compare as multisets
    assert len(own) >= 4 and sorted(passed_own) == sorted(own)
    assert sorted(passed_c) == sorted(own_c) and len(own_c) == len(own)
    assert len(outputs) == len(outputs_c) == len(want)
    for a, b in zip(outputs, outputs_c):
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_failed_picture_is_not_pooled_again(monkeypatch):
    """A picture whose entropy decode fails (error_policy="skip") leaves no
    set held in the pool, its own set is never handed out again, and the
    decode goes on."""
    bs, want = _committed("smoke_cif_high.h264")
    decode_slice = native.decode_slice_native
    calls, failed = [], []

    def failing(state, *args, **kw):
        calls.append(state)
        if len(calls) == 5:
            failed.append(state)
            raise ValueError("native slice decode failed: -1")
        return decode_slice(state, *args, **kw)

    monkeypatch.setattr(native, "decode_slice_native", failing)
    with GpuDecoder(device="cpu") as dec:
        dec.error_policy = "skip"
        frames = dec.decode_stream(bs)
        pool = dec._frames
    # pictures that predict from the lost one may fail in turn
    assert failed and dec.error_count >= 1 and 0 < len(frames) < len(want)
    assert pool._out == {} and all(s is not failed[0] for s in pool._idle)


def test_wire_build_records_the_coded_rows(monkeypatch):
    """A sparse frame's wire build leaves on its FrameTensors the rows that
    hold levels (the reset clears those only), covering every nonzero level,
    and a picture that has no 8x8 transforms, sparse or dense, an empty 8x8
    row list."""
    bs, want = _committed("smoke_cif_main_slices2_nodb.h264")
    rows = []
    reset = native.NativeFrameState.reset

    def checking(self):
        ft = self.ft
        if "l" in (ft.coded or {}):
            for key, (name, width) in ft._CODED_ROWS.items():
                a = getattr(ft, name).reshape(-1, width)
                nz = np.flatnonzero(a.any(axis=1))
                rows.append(set(nz.tolist()) <= set(ft.coded[key].tolist()))
        assert len(ft.coded["l8"]) == 0
        reset(self)

    monkeypatch.setattr(native.NativeFrameState, "reset", checking)
    with GpuDecoder(device="cpu") as dec:
        got = [md5s(f.planes()) for f in dec.decode_stream(bs)]
    assert got == want and rows and all(rows)


def test_host_stages_tool(capsys):
    """tools/host_stages.py decodes a committed stream with no pixels and
    prints, for every picture, the main thread's stages (set-up and finish
    among them) as one JSON line."""
    from h264decode_tpu_torch.tools import host_stages

    assert host_stages.main(["--stream", "smoke_cif_high.h264"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["stream"] == "smoke_cif_high.h264" and res["pictures"] == 8
    for k in host_stages.STAGES:
        assert res[k]["wall_ms"] >= 0 and res[k]["cpu_ms"] >= 0
    assert res["entropy_native"]["wall_ms"] > 0
