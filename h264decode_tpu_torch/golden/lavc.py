"""ctypes bindings to the system libavcodec: golden H.264 decode + x264 encode.

This is the conformance oracle for the whole framework: every stage of the
TPU decoder is golden-tested against libavcodec's bit-exact YUV output
(SURVEY.md section 4 — the reference repo has no tests; we invert that).

Only a stable prefix of AVFrame/AVPacket is declared; everything else goes
through the AVOption API (av_opt_set with AV_OPT_SEARCH_CHILDREN) so we never
depend on private struct layout.

Pinned to the system sonames: libavcodec.so.59 / libavutil.so.57 (ffmpeg 5.x).
"""

from __future__ import annotations

import ctypes
from ctypes import (
    POINTER,
    byref,
    c_char_p,
    c_int,
    c_int64,
    c_uint8,
    c_void_p,
)
from dataclasses import dataclass

import numpy as np

_avcodec = ctypes.CDLL("libavcodec.so.59")
_avutil = ctypes.CDLL("libavutil.so.57")

AV_CODEC_ID_H264 = 27
AV_PIX_FMT_YUV420P = 0
AV_PIX_FMT_YUV422P = 4
AV_PIX_FMT_YUV444P = 5
AV_PIX_FMT_GRAY8 = 8
AV_PIX_FMT_YUV420P10LE = 62
AV_PIX_FMT_YUV422P10LE = 64
AV_PIX_FMT_YUV444P10LE = 68
# pixel format -> (chroma width shift, chroma height shift, bytes/sample)
_PIX_FMT_SHIFTS = {
    AV_PIX_FMT_YUV420P: (1, 1, 1),
    AV_PIX_FMT_YUV422P: (1, 0, 1),
    AV_PIX_FMT_YUV444P: (0, 0, 1),
    AV_PIX_FMT_YUV420P10LE: (1, 1, 2),
    AV_PIX_FMT_YUV422P10LE: (1, 0, 2),
    AV_PIX_FMT_YUV444P10LE: (0, 0, 2),
}
AV_OPT_SEARCH_CHILDREN = 1  # search priv_data (e.g. x264 options) too
AVERROR_EAGAIN = -11
AVERROR_EOF = -541478725  # FFERRTAG('E','O','F',' ')


class AVRational(ctypes.Structure):
    _fields_ = [("num", c_int), ("den", c_int)]


class AVFrame(ctypes.Structure):
    """Stable prefix of AVFrame (libavutil 57). Only fields up to `format`
    are accessed; trailing layout may differ and is never touched."""

    _fields_ = [
        ("data", c_void_p * 8),
        ("linesize", c_int * 8),
        ("extended_data", c_void_p),
        ("width", c_int),
        ("height", c_int),
        ("nb_samples", c_int),
        ("format", c_int),
    ]


class AVPacket(ctypes.Structure):
    """Stable prefix of AVPacket (libavcodec 59)."""

    _fields_ = [
        ("buf", c_void_p),
        ("pts", c_int64),
        ("dts", c_int64),
        ("data", POINTER(c_uint8)),
        ("size", c_int),
        ("stream_index", c_int),
        ("flags", c_int),
    ]


def _sig(fn, restype, argtypes):
    fn.restype = restype
    fn.argtypes = argtypes
    return fn


_avcodec_find_decoder = _sig(_avcodec.avcodec_find_decoder, c_void_p, [c_int])
_avcodec_find_encoder_by_name = _sig(
    _avcodec.avcodec_find_encoder_by_name, c_void_p, [c_char_p]
)
_avcodec_alloc_context3 = _sig(_avcodec.avcodec_alloc_context3, c_void_p, [c_void_p])
_avcodec_open2 = _sig(_avcodec.avcodec_open2, c_int, [c_void_p, c_void_p, c_void_p])
_avcodec_free_context = _sig(_avcodec.avcodec_free_context, None, [c_void_p])
_avcodec_send_packet = _sig(_avcodec.avcodec_send_packet, c_int, [c_void_p, c_void_p])
_avcodec_receive_frame = _sig(
    _avcodec.avcodec_receive_frame, c_int, [c_void_p, POINTER(AVFrame)]
)
_avcodec_send_frame = _sig(_avcodec.avcodec_send_frame, c_int, [c_void_p, c_void_p])
_avcodec_receive_packet = _sig(
    _avcodec.avcodec_receive_packet, c_int, [c_void_p, POINTER(AVPacket)]
)
_av_packet_alloc = _sig(_avcodec.av_packet_alloc, POINTER(AVPacket), [])
_av_packet_free = _sig(_avcodec.av_packet_free, None, [c_void_p])
_av_packet_unref = _sig(_avcodec.av_packet_unref, None, [POINTER(AVPacket)])
_av_parser_init = _sig(_avcodec.av_parser_init, c_void_p, [c_int])
_av_parser_close = _sig(_avcodec.av_parser_close, None, [c_void_p])
_av_parser_parse2 = _sig(
    _avcodec.av_parser_parse2,
    c_int,
    [
        c_void_p,
        c_void_p,
        POINTER(POINTER(c_uint8)),
        POINTER(c_int),
        POINTER(c_uint8),
        c_int,
        c_int64,
        c_int64,
        c_int64,
    ],
)
_av_frame_alloc = _sig(_avutil.av_frame_alloc, POINTER(AVFrame), [])
_av_frame_free = _sig(_avutil.av_frame_free, None, [c_void_p])
_av_frame_get_buffer = _sig(_avutil.av_frame_get_buffer, c_int, [POINTER(AVFrame), c_int])
_av_frame_make_writable = _sig(_avutil.av_frame_make_writable, c_int, [POINTER(AVFrame)])
_av_opt_set = _sig(_avutil.av_opt_set, c_int, [c_void_p, c_char_p, c_char_p, c_int])


@dataclass
class YUVFrame:
    """One decoded frame as exact uint8 planes (4:2:0 / 4:2:2 / 4:4:4)."""

    y: np.ndarray  # [H, W]
    cb: np.ndarray  # subsampled per the stream's chroma format
    cr: np.ndarray

    @property
    def shape(self):
        return self.y.shape

    def planes(self):
        return (self.y, self.cb, self.cr)


def _copy_plane(frame: AVFrame, idx: int, h: int, w: int,
                bps: int = 1) -> np.ndarray:
    ls = frame.linesize[idx]
    buf = ctypes.cast(frame.data[idx], POINTER(c_uint8 * (ls * h))).contents
    if bps == 2:  # 10-bit little-endian samples
        arr = np.frombuffer(buf, dtype=np.uint16).reshape(h, ls // 2)
    else:
        arr = np.frombuffer(buf, dtype=np.uint8).reshape(h, ls)
    return arr[:, :w].copy()


def _frame_to_yuv(frame: AVFrame) -> YUVFrame:
    if frame.format == AV_PIX_FMT_GRAY8:  # monochrome: no chroma planes
        empty = np.zeros((0, 0), np.uint8)
        return YUVFrame(
            y=_copy_plane(frame, 0, frame.height, frame.width),
            cb=empty,
            cr=empty,
        )
    shifts = _PIX_FMT_SHIFTS.get(frame.format)
    if shifts is None:
        raise ValueError(f"unsupported planar YUV format={frame.format}")
    sw, sh, bps = shifts
    h, w = frame.height, frame.width
    return YUVFrame(
        y=_copy_plane(frame, 0, h, w, bps),
        cb=_copy_plane(frame, 1, h >> sh, w >> sw, bps),
        cr=_copy_plane(frame, 2, h >> sh, w >> sw, bps),
    )


def decode_annexb(data: bytes) -> list[YUVFrame]:
    """Golden-decode an Annex-B H.264 elementary stream to exact YUV planes."""
    codec = _avcodec_find_decoder(AV_CODEC_ID_H264)
    if not codec:
        raise RuntimeError("libavcodec: no H.264 decoder")
    ctx = _avcodec_alloc_context3(codec)
    if _avcodec_open2(ctx, codec, None) < 0:
        raise RuntimeError("avcodec_open2 failed")
    parser = _av_parser_init(AV_CODEC_ID_H264)
    pkt = _av_packet_alloc()
    frame = _av_frame_alloc()
    frames: list[YUVFrame] = []

    def drain():
        while True:
            ret = _avcodec_receive_frame(ctx, frame)
            if ret in (AVERROR_EAGAIN, AVERROR_EOF):
                return
            if ret < 0:
                raise RuntimeError(f"avcodec_receive_frame: {ret}")
            frames.append(_frame_to_yuv(frame.contents))

    try:
        buf = (c_uint8 * len(data)).from_buffer_copy(data)
        pos = 0
        while pos < len(data):
            out_data = POINTER(c_uint8)()
            out_size = c_int(0)
            consumed = _av_parser_parse2(
                parser,
                ctx,
                byref(out_data),
                byref(out_size),
                ctypes.cast(ctypes.byref(buf, pos), POINTER(c_uint8)),
                len(data) - pos,
                0,
                0,
                -1,
            )
            if consumed < 0:
                raise RuntimeError("av_parser_parse2 failed")
            pos += consumed
            if out_size.value > 0:
                pkt.contents.data = out_data
                pkt.contents.size = out_size.value
                if _avcodec_send_packet(ctx, pkt) < 0:
                    raise RuntimeError("avcodec_send_packet failed")
                drain()
        # flush parser
        out_data = POINTER(c_uint8)()
        out_size = c_int(0)
        _av_parser_parse2(
            parser, ctx, byref(out_data), byref(out_size), None, 0, 0, 0, -1
        )
        if out_size.value > 0:
            pkt.contents.data = out_data
            pkt.contents.size = out_size.value
            _avcodec_send_packet(ctx, pkt)
            drain()
        # flush decoder
        _avcodec_send_packet(ctx, None)
        while True:
            ret = _avcodec_receive_frame(ctx, frame)
            if ret < 0:
                break
            frames.append(_frame_to_yuv(frame.contents))
    finally:
        ctx_p = c_void_p(ctx)
        _avcodec_free_context(byref(ctx_p))
        _av_parser_close(parser)
        pkt_p = ctypes.cast(pkt, c_void_p)
        _av_packet_free(byref(pkt_p))
        frame_p = ctypes.cast(frame, c_void_p)
        _av_frame_free(byref(frame_p))
    return frames


def decode_file(path: str) -> list[YUVFrame]:
    with open(path, "rb") as f:
        return decode_annexb(f.read())


def encode_x264(
    frames: list[YUVFrame] | list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    *,
    qp: int | None = 26,
    profile: str = "baseline",
    preset: str = "medium",
    gop: int | None = None,
    bframes: int | None = None,
    extra_x264: str = "",
    cabac: bool | None = None,
    csp: str = "yuv420p",
) -> bytes:
    """Encode YUV420 frames to an Annex-B H.264 stream with libx264.

    Used only to GENERATE test vectors; never part of the decode path.
    """
    codec = _avcodec_find_encoder_by_name(b"libx264")
    if not codec:
        raise RuntimeError("libx264 encoder unavailable")
    ctx = _avcodec_alloc_context3(codec)

    first = frames[0]
    y0 = first.y if isinstance(first, YUVFrame) else first[0]
    h, w = y0.shape

    def opt(name: str, val: str):
        ret = _av_opt_set(ctx, name.encode(), val.encode(), AV_OPT_SEARCH_CHILDREN)
        if ret < 0:
            raise RuntimeError(f"av_opt_set({name}={val}) -> {ret}")

    opt("video_size", f"{w}x{h}")
    opt("pixel_format", csp)
    opt("time_base", "1/25")
    opt("preset", preset)
    if profile:
        opt("profile", profile)
    x264_params = []
    if qp is not None:
        x264_params.append(f"qp={qp}")
    if gop is not None:
        x264_params.append(f"keyint={gop}:min-keyint={gop}")
    if bframes is not None:
        x264_params.append(f"bframes={bframes}")
    if cabac is not None:
        x264_params.append("cabac=1" if cabac else "cabac=0")
    # no psy tricks; deterministic single-thread output
    x264_params.append("threads=1:sliced-threads=0:scenecut=0")
    if extra_x264:
        x264_params.append(extra_x264)
    opt("x264-params", ":".join(x264_params))

    if _avcodec_open2(ctx, codec, None) < 0:
        raise RuntimeError("avcodec_open2 (encoder) failed")

    frame = _av_frame_alloc()
    frame.contents.width = w
    frame.contents.height = h
    frame.contents.format = {
        "yuv420p": AV_PIX_FMT_YUV420P,
        "yuv422p": AV_PIX_FMT_YUV422P,
        "yuv444p": AV_PIX_FMT_YUV444P,
        "gray": AV_PIX_FMT_GRAY8,
        "yuv420p10le": AV_PIX_FMT_YUV420P10LE,
        "yuv422p10le": AV_PIX_FMT_YUV422P10LE,
        "yuv444p10le": AV_PIX_FMT_YUV444P10LE,
    }[csp]
    if _av_frame_get_buffer(frame, 32) < 0:
        raise RuntimeError("av_frame_get_buffer failed")
    pkt = _av_packet_alloc()
    out = bytearray()

    def drain_packets():
        while True:
            ret = _avcodec_receive_packet(ctx, pkt)
            if ret in (AVERROR_EAGAIN, AVERROR_EOF):
                return
            if ret < 0:
                raise RuntimeError(f"avcodec_receive_packet: {ret}")
            out.extend(
                ctypes.string_at(
                    ctypes.cast(pkt.contents.data, c_void_p), pkt.contents.size
                )
            )
            _av_packet_unref(pkt)

    try:
        for i, f in enumerate(frames):
            planes = f.planes() if isinstance(f, YUVFrame) else f
            _av_frame_make_writable(frame)
            fr = frame.contents
            for idx, plane in enumerate(planes):
                ph, pw = plane.shape
                ls = fr.linesize[idx]
                dst = ctypes.cast(fr.data[idx], POINTER(c_uint8 * (ls * ph))).contents
                if plane.dtype == np.uint16:  # 10-bit LE samples
                    view = np.frombuffer(dst, dtype=np.uint16).reshape(ph, ls // 2)
                else:
                    view = np.frombuffer(dst, dtype=np.uint8).reshape(ph, ls)
                view[:, :pw] = plane
            # pts via raw offsetof hack: pts is right after data/linesize/extended_data/
            # width/height/nb_samples/format... safer: AVFrame option-less; use opt api
            _set_frame_pts(frame, i)
            if _avcodec_send_frame(ctx, frame) < 0:
                raise RuntimeError("avcodec_send_frame failed")
            drain_packets()
        _avcodec_send_frame(ctx, None)
        while True:
            ret = _avcodec_receive_packet(ctx, pkt)
            if ret < 0:
                break
            out.extend(
                ctypes.string_at(
                    ctypes.cast(pkt.contents.data, c_void_p), pkt.contents.size
                )
            )
            _av_packet_unref(pkt)
    finally:
        ctx_p = c_void_p(ctx)
        _avcodec_free_context(byref(ctx_p))
        frame_p = ctypes.cast(frame, c_void_p)
        _av_frame_free(byref(frame_p))
        pkt_p = ctypes.cast(pkt, c_void_p)
        _av_packet_free(byref(pkt_p))
    return bytes(out)


class _AVFramePtsProbe(ctypes.Structure):
    """AVFrame prefix through pts (libavutil 57 layout)."""

    _fields_ = [
        ("data", c_void_p * 8),
        ("linesize", c_int * 8),
        ("extended_data", c_void_p),
        ("width", c_int),
        ("height", c_int),
        ("nb_samples", c_int),
        ("format", c_int),
        ("key_frame", c_int),
        ("pict_type", c_int),
        ("sample_aspect_ratio", AVRational),
        ("pts", c_int64),
    ]


def _set_frame_pts(frame, pts: int):
    probe = ctypes.cast(frame, POINTER(_AVFramePtsProbe))
    probe.contents.pts = pts
