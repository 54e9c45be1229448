"""GpuDecoder(device="cpu") on the stream classes that x264 does not emit
and that only the JAX package's own suite covered: FMO map types 0-6, I_PCM,
MMCO 1-6 and long-term references, ref-list modification, POC types 1 and
2, data partitioning, error_policy="skip" on a truncated and on a
bit-flipped stream, PAFF field pictures and SP/SI slices.

The streams are those of the JAX tests (tests/synth.py's writer and their
stream functions, at 4x3 MBs; QCIF from x264 for the error cases). The oracle is
libavcodec where it decodes the class, else the JAX package's numpy Decoder
(FMO, data partitioning and SP/SI, which libavcodec does not implement),
plus the known PCM pixels the JAX tests assert. Streams whose every picture
the frame program does not run (PAFF, SI) must leave the decoder's DPB ring
unallocated: they decoded on the host oracle, as in the JAX package."""

import numpy as np
import pytest
import torch

from h264decode_tpu.pipeline.decoder import Decoder as JaxDecoder
from h264decode_tpu_torch.golden import lavc
from h264decode_tpu_torch.pipeline.gpu_pipeline import GpuDecoder
from tests import test_dp, test_paff, test_spsi, test_synth_streams as tss
from tests.conftest import make_test_frames
from tests.synth import (
    paff_p_residual_slice,
    pcm_frame_planes,
    pcm_slice,
    pskip_frame,
    si_slice,
    write_pps,
    write_sps,
)

torch.set_num_threads(1)

MB_W, MB_H = tss.MB_W, tss.MB_H
N = MB_W * MB_H
ALL = list(range(N))


def _head(**sps):
    return write_sps(MB_W, MB_H, **sps) + write_pps()


def _markers(n):
    return [pcm_frame_planes(MB_W, MB_H, seed=10 + i) for i in range(n)]


def _pcm(planes, **kw):
    return pcm_slice(planes, ALL, MB_W, **kw)


def _fmo(map_type, change_dir=False, cycle=5):
    data, planes, _ = tss._build_fmo_stream(map_type, change_dir=change_dir, cycle=cycle)
    return dict(data=data, oracle="jax", known={0: planes})


def _ipcm_idr():
    a = pcm_frame_planes(MB_W, MB_H, seed=1)
    return dict(data=_head() + _pcm(a), known={0: a})


def _ipcm_in_p():
    a, b = (pcm_frame_planes(MB_W, MB_H, seed=s) for s in (2, 3))
    return dict(data=_head() + _pcm(a) + _pcm(b, slice_type=5, frame_num=1, idr=False,
                                              ref_idc=1, poc_lsb=2), known={1: b})


def _pskip():
    (a,) = _markers(1)
    return dict(data=_head() + _pcm(a) + pskip_frame(N, frame_num=1, poc_lsb=2, ref_idc=1),
                known={1: a})


def _ref_list_mod():
    a, b = _markers(2)
    data = (_head() + _pcm(a) + _pcm(b, frame_num=1, idr=False, ref_idc=1, poc_lsb=2)
            + pskip_frame(N, frame_num=2, poc_lsb=4, ref_list_mod=[(0, 1)]))
    return dict(data=data, known={2: a})


def _long_term_idr():
    a, b = _markers(2)
    data = (_head() + _pcm(a, long_term_reference_flag=True)
            + _pcm(b, frame_num=1, idr=False, ref_idc=1, poc_lsb=2)
            + pskip_frame(N, frame_num=2, poc_lsb=4, ref_list_mod=[(2, 0)]))
    return dict(data=data, known={2: a})


def _mmco3():
    a, b = _markers(2)
    data = (_head() + _pcm(a)
            + _pcm(b, frame_num=1, idr=False, ref_idc=1, poc_lsb=2, mmco_ops=[(3, 0, 0)])
            + pskip_frame(N, frame_num=2, poc_lsb=4, ref_list_mod=[(2, 0)]))
    return dict(data=data, known={2: a})


def _mmco6():
    a, b = _markers(2)
    data = (_head() + _pcm(a)
            + _pcm(b, frame_num=1, idr=False, ref_idc=1, poc_lsb=2, mmco_ops=[(4, 1), (6, 0)])
            + pskip_frame(N, frame_num=2, poc_lsb=4, ref_list_mod=[(2, 0)]))
    return dict(data=data, known={2: b})


def _mmco1():
    a, b, c = _markers(3)
    data = (_head(max_num_ref_frames=2) + _pcm(a)
            + _pcm(b, frame_num=1, idr=False, ref_idc=1, poc_lsb=2)
            + _pcm(c, frame_num=2, idr=False, ref_idc=1, poc_lsb=4, mmco_ops=[(1, 0)])
            + pskip_frame(N, frame_num=3, poc_lsb=6, ref_list_mod=[(0, 2)]))
    return dict(data=data, known={3: a})


def _mmco2():
    a, b = _markers(2)
    data = (_head() + _pcm(a, long_term_reference_flag=True)
            + _pcm(b, frame_num=1, idr=False, ref_idc=1, poc_lsb=2, mmco_ops=[(2, 0)]))
    return dict(data=data, dpb=lambda d: not any(p.long_term for p in d.dpb.pictures))


def _mmco4():
    a, b = _markers(2)
    data = (_head() + _pcm(a, long_term_reference_flag=True)
            + _pcm(b, frame_num=1, idr=False, ref_idc=1, poc_lsb=2, mmco_ops=[(4, 0)]))
    return dict(data=data, dpb=lambda d: not any(p.long_term for p in d.dpb.pictures)
                and d.dpb.max_long_term_idx == -1)


def _mmco5():
    a, b, c = _markers(3)
    data = (_head() + _pcm(a) + _pcm(b, frame_num=1, idr=False, ref_idc=1, poc_lsb=2)
            + _pcm(c, frame_num=2, idr=False, ref_idc=1, poc_lsb=4, mmco_ops=[(5,)])
            + pskip_frame(N, frame_num=1, poc_lsb=2))
    return dict(data=data, oracle="jax", known={-1: c})


def _poc2():
    a, b = _markers(2)
    data = (_head(poc_type=2) + _pcm(a, poc_type=2)
            + _pcm(b, frame_num=1, idr=False, ref_idc=1, poc_type=2)
            + pskip_frame(N, frame_num=2, ref_idc=1, poc_type=2))
    return dict(data=data, known={1: b})


def _poc1(always_zero=False):
    a, b = _markers(2)
    d = {} if always_zero else {"delta_poc": 0}
    data = (write_sps(MB_W, MB_H, poc_type=1, poc_cycle_offsets=(2,),
                      delta_pic_order_always_zero=always_zero) + write_pps()
            + _pcm(a, poc_type=1, **d)
            + _pcm(b, frame_num=1, idr=False, ref_idc=1, poc_type=1, **d))
    if not always_zero:
        data += pskip_frame(N, frame_num=2, ref_idc=1, poc_type=1, delta_poc=0)
    return dict(data=data, known={1: b})


def _data_partitioning():
    # the ordinary-slice twin must decode to the same pixels
    return dict(data=test_dp._build_stream(split=True), oracle="jax",
                same_as=test_dp._build_stream(split=False))


def _x264_qcif():
    return lavc.encode_x264(make_test_frames(5, 144, 176), qp=26, profile="main", cabac=True,
                            bframes=0)


def _truncated():
    bs = _x264_qcif()
    return dict(data=bs[: len(bs) // 2], oracle="lavc_full", full=bs, policy="skip",
                fewer=True)


def _bitflip():
    bs = bytearray(_x264_qcif())
    full = bytes(bs)
    bs[len(bs) // 2] ^= 0xFF  # corrupt mid-stream slice data
    return dict(data=bytes(bs), oracle="lavc_full", full=full, policy="skip", first=1)


def _paff_pcm_pskip():
    pair, top, bot = test_paff._idr_pair(1, 2)
    n = MB_W * test_paff.MB_H_FIELD
    data = (test_paff._sps() + write_pps() + pair
            + pskip_frame(n, frame_num=1, poc_lsb=2, field=0, interlaced_sps=True)
            + pskip_frame(n, frame_num=1, poc_lsb=3, field=1, interlaced_sps=True))
    return dict(data=data, oracle_only=True,
                known={0: (test_paff._weave(top[0], bot[0]),)})


def _paff_residuals():
    pair, _, _ = test_paff._idr_pair(31, 32)
    data = test_paff._sps() + write_pps() + pair

    def plan(mb, blk):
        k = (mb * 16 + blk) % 19
        return k if k < 16 else None

    for field in (0, 1):
        data += paff_p_residual_slice(MB_W, test_paff.MB_H_FIELD, plan, frame_num=1,
                                      field=field, poc_lsb=2, deblock=True)
    return dict(data=data, oracle_only=True)


def _sp(switching):
    data, ref = test_spsi._sp_stream(switching, 4)
    want = test_spsi._expected_sp(ref, qp=26, qs=30, switching=switching)
    return dict(data=data, oracle="jax", known={1: want})


def _si():
    data = write_sps(MB_W, MB_H) + write_pps() + si_slice(N, idr=True, qs_delta=2)
    return dict(data=data, oracle="jax", oracle_only=True,
                known={0: test_spsi._expected_si(26, 28)})


CASES = {
    **{f"fmo_type{t}": (lambda t=t: _fmo(t)) for t in range(7)},
    **{f"fmo_type{t}_reverse": (lambda t=t: _fmo(t, change_dir=True, cycle=4))
       for t in (3, 4, 5)},
    "ipcm_idr": _ipcm_idr,
    "ipcm_in_p_slice": _ipcm_in_p,
    "pskip_copies_ref": _pskip,
    "ref_list_modification": _ref_list_mod,
    "long_term_ref_idr": _long_term_idr,
    "mmco1_sliding_window": _mmco1,
    "mmco2_unmark_long_term": _mmco2,
    "mmco3_short_to_long": _mmco3,
    "mmco4_max_long_term_idx": _mmco4,
    "mmco5_reset": _mmco5,
    "mmco6_current_to_long": _mmco6,
    "poc_type1": _poc1,
    "poc_type1_always_zero": lambda: _poc1(always_zero=True),
    "poc_type2": _poc2,
    "data_partitioning": _data_partitioning,
    "skip_policy_truncated": _truncated,
    "skip_policy_bitflip": _bitflip,
    "paff_pcm_and_pskip_fields": _paff_pcm_pskip,
    "paff_field_residuals": _paff_residuals,
    "sp_slice_nonswitching": lambda: _sp(False),
    "sp_slice_switching": lambda: _sp(True),
    "si_slice": _si,
}


def _planes(frames):
    return [[np.asarray(p) for p in f.planes()] for f in frames]


def _gpu_decode(data: bytes, policy: str):
    dec = GpuDecoder(device="cpu")
    dec.error_policy = policy
    with dec:
        frames = _planes(dec.decode_stream(data))
    return dec, frames


def _assert_frames(got, want, what):
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        for name, gp, wp in zip(("y", "cb", "cr"), g, w):
            assert np.array_equal(gp, wp), f"{what}: frame {i} plane {name}"


@pytest.mark.parametrize("name", list(CASES))
def test_stream_class(name):
    case = CASES[name]()
    policy = case.get("policy", "strict")
    dec, ours = _gpu_decode(case["data"], policy)
    oracle = case.get("oracle", "lavc")
    if oracle == "lavc":
        _assert_frames(ours, _planes(lavc.decode_annexb(case["data"])), "libavcodec")
    elif oracle == "jax":
        jax_dec = JaxDecoder(error_policy=policy)
        _assert_frames(ours, _planes(jax_dec.decode_stream(case["data"])), "JAX Decoder")
    else:  # a damaged stream: the frames it yields are libavcodec's of the whole one
        want = _planes(lavc.decode_annexb(case["full"]))
        assert 1 <= len(ours) and (len(ours) < len(want) if case.get("fewer") else True)
        n = case.get("first", len(ours))
        _assert_frames(ours[:n], want[:n], "libavcodec, undamaged")
    for idx, planes in case.get("known", {}).items():
        for got, want in zip(ours[idx], planes):
            assert np.array_equal(got, np.asarray(want)), f"known pixels of frame {idx}"
    if "same_as" in case:
        _assert_frames(ours, _gpu_decode(case["same_as"], policy)[1], "ordinary slices")
    if "dpb" in case:
        assert case["dpb"](dec)
    if case.get("oracle_only"):
        assert dec._ring is None  # every picture decoded on the host oracle
