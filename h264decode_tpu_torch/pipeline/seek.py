"""Random access: scan an Annex-B stream for access points (IDR access
units and recovery-point SEI, Annex D.2.7) and resume decoding from one.

The reference has no seek/resume affordance at all (SURVEY.md section 5);
its closest feature is a raw-stream tee to disk for offline replay
(/root/reference/h264/bit_reader.go:34-36). Here an access point carries
everything needed to restart a fresh decoder mid-stream: the byte offset
plus the active parameter sets seen before it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..bitstream.annexb import START3
from ..syntax import nal as nal_mod
from ..syntax.nal import parse_nal_unit
from ..syntax.sei import parse_sei
from .decoder import Decoder


@dataclass
class AccessPoint:
    offset: int  # byte offset of the AU's first NAL start code
    kind: str  # "idr" | "recovery"
    picture_index: int  # decode-order picture count before this point
    recovery_frame_cnt: int = 0
    exact_match: bool = True
    # latest SPS/PPS raw NAL bytes active at this point, by parameter-set id
    sps_nals: dict[int, bytes] = field(default_factory=dict)
    pps_nals: dict[int, bytes] = field(default_factory=dict)


def _iter_nalus_offsets(data: bytes):
    """(start_code_offset, nal_bytes) pairs; offset points at the first byte
    of the 3-byte start code (a preceding zero of a 4-byte code is inert)."""
    i = data.find(START3)
    while i >= 0:
        j = data.find(START3, i + 3)
        end = len(data) if j < 0 else j
        while end > i + 3 and data[end - 1] == 0:
            end -= 1
        if end > i + 3:
            yield i, data[i + 3 : end]
        if j < 0:
            return
        i = j


def scan_access_points(data: bytes) -> list[AccessPoint]:
    """All random-access entry points of the stream, in order: every IDR
    access unit, plus every access unit announced by a recovery-point SEI
    (gradual-refresh entry; exact only when exact_match_flag is set)."""
    points: list[AccessPoint] = []
    sps_nals: dict[int, bytes] = {}
    pps_nals: dict[int, bytes] = {}
    n_pics = 0
    pending_sei = None  # (offset, recovery_frame_cnt, exact_match)
    pending_au_start = None  # offset of the first non-VCL NAL of the next AU
    in_picture = False
    for off, raw in _iter_nalus_offsets(data):
        nal = parse_nal_unit(raw)
        if nal.type == nal_mod.NAL_SPS:
            sps_nals[_sps_id(nal.rbsp)] = raw
            in_picture = False
            pending_au_start = off if pending_au_start is None else pending_au_start
        elif nal.type == nal_mod.NAL_PPS:
            pps_nals[_pps_id(nal.rbsp)] = raw
            in_picture = False
            pending_au_start = off if pending_au_start is None else pending_au_start
        elif nal.type == nal_mod.NAL_SEI:
            try:
                rp = parse_sei(nal.rbsp).recovery_point()
            except Exception:
                rp = None
            if rp is not None:
                pending_sei = (rp.recovery_frame_cnt, rp.exact_match_flag)
            in_picture = False
            pending_au_start = off if pending_au_start is None else pending_au_start
        elif nal.is_vcl:
            first_mb_zero = _first_mb_is_zero(nal.rbsp)
            if not in_picture or first_mb_zero:
                # a new picture starts here (heuristic: MB address 0 —
                # exact for non-FMO streams, which is where seek applies)
                au_off = pending_au_start if pending_au_start is not None else off
                if nal.is_idr:
                    points.append(
                        AccessPoint(
                            offset=au_off,
                            kind="idr",
                            picture_index=n_pics,
                            sps_nals=dict(sps_nals),
                            pps_nals=dict(pps_nals),
                        )
                    )
                elif pending_sei is not None:
                    cnt, exact = pending_sei
                    points.append(
                        AccessPoint(
                            offset=au_off,
                            kind="recovery",
                            picture_index=n_pics,
                            recovery_frame_cnt=cnt,
                            exact_match=bool(exact),
                            sps_nals=dict(sps_nals),
                            pps_nals=dict(pps_nals),
                        )
                    )
                pending_sei = None
                n_pics += 1
                in_picture = True
            pending_au_start = None
        else:
            in_picture = False
            pending_au_start = off if pending_au_start is None else pending_au_start
    return points


def _ue_prefix(rbsp: bytes, count: int) -> list[int]:
    """First `count` ue(v) values of an RBSP (enough for ids/addresses)."""
    from ..bitstream.bitreader import BitReader

    r = BitReader(rbsp)
    return [r.ue() for _ in range(count)]


def _sps_id(rbsp: bytes) -> int:
    from ..bitstream.bitreader import BitReader

    r = BitReader(rbsp)
    r.u(24)  # profile_idc, flags, level_idc
    return r.ue()


def _pps_id(rbsp: bytes) -> int:
    return _ue_prefix(rbsp, 1)[0]


def _first_mb_is_zero(rbsp: bytes) -> bool:
    try:
        return _ue_prefix(rbsp, 1)[0] == 0
    except Exception:
        return False


def decode_from(data: bytes, point: AccessPoint, decoder: Decoder | None = None):
    """Resume decoding at `point`: a fresh decoder is fed the access point's
    active parameter sets followed by the stream tail. Yields DecodedFrames
    (for a "recovery" point, frames before the announced recovery count are
    best-effort unless exact_match)."""
    if decoder is None:
        decoder = Decoder()
    prefix = b"".join(
        b"\x00\x00\x00\x01" + n
        for n in list(point.sps_nals.values()) + list(point.pps_nals.values())
    )
    return decoder.decode_iter(prefix + data[point.offset :])
