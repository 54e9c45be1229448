"""Generate the committed smoke streams and their libavcodec MD5s.

    python -m h264decode_tpu_torch.data.make_smoke_streams [NAME ...]

Writes, next to this file (only the NAMEd streams when any are given, their
MD5s merged into smoke_md5.json):
  smoke_1080p_main_cabac.h264    1920x1080 Main CABAC, I/P/B with 2 B-frames,
                                 x264 preset fast, QP 28, 8 frames (the stream
                                 recipe of bench.py's default content)
  smoke_cif_high.h264            352x288 High CABAC, 8x8dct, 4 slices,
                                 weightp=2, ref=3, 2 B-frames, 8 frames
  smoke_1080p_high422_10.h264    1920x1080 High 4:2:2 10-bit CABAC, I/P/B
                                 with 2 B-frames, 8x8dct, preset fast, QP 28,
                                 8 frames (the 1080p content at 10 bits with
                                 full-height chroma)
  smoke_cif_high10.h264          352x288 High 10 (4:2:0 10-bit) CABAC,
                                 8x8dct, 4 slices, weightp=2, ref=3,
                                 2 B-frames, 8 frames
  smoke_cif_gray.h264            352x288 High 4:0:0 (monochrome) 8-bit CABAC,
                                 8x8dct, 2 B-frames, 8 frames
  smoke_1080p_high444.h264       1920x1080 High 4:4:4 Predictive 8-bit CABAC,
                                 I/P/B with 2 B-frames, 8x8dct, preset fast,
                                 QP 28, 8 frames (the 1080p luma with
                                 full-size chroma of its own texture)
  smoke_cif_high444.h264         352x288 High 4:4:4 Predictive 8-bit CABAC,
                                 the CIF High options plus the JVT scaling
                                 lists (cqm=jvt), 8 frames
  smoke_1080p_main_slices4_nodb.h264
                                 the 1080p Main stream's recipe with 4
                                 slices of 17 MB rows each and the
                                 deblocking filter off (slices=4,
                                 no-deblock=1): the aligned mode of a 1x4
                                 row-band mesh (dist/), 8 frames
  smoke_cif_main_slices2_nodb.h264
                                 352x288 Main CABAC, the CIF content with 2
                                 slices of 9 MB rows each and the
                                 deblocking filter off, 2 B-frames, 8
                                 frames: the aligned mode of a 1x2 row-band
                                 mesh
  smoke_1080p_main_gop4.h264     the 1080p Main stream's recipe over 16
                                 frames with an IDR every 4 (keyint=4,
                                 min-keyint=4, scenecut=0): four closed
                                 GOPs for GOP-parallel decoding (dist/gop.py)
  smoke_1080p_high_hard.h264     1920x1080 High CABAC: bench.py's
                                 BENCH_CONTENT=hard content and recipe (QP
                                 24, preset medium, 2 B-frames, 4 slices,
                                 8x8dct, partitions=all, ref=3), 8 frames
  smoke_md5.json                 per stream: libavcodec's per-frame,
                                 per-plane MD5s (output order), its frame
                                 geometry, bit depth and chroma format.
                                 Samples above 8 bits are hashed as
                                 little-endian uint16. libavcodec returns no
                                 chroma planes for a monochrome stream; the
                                 decoder presents them as 4:2:0 planes of
                                 mid-gray 1 << (bd - 1), and the MD5s stored
                                 for them are those of such planes.

Needs the system libavcodec/libx264 (golden/lavc.py); decoding the streams
needs neither, which is why they are committed.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def frames_1080p(n: int = 8, h: int = 1080, w: int = 1920, ch: int | None = None):
    """bench.py's default content: a smooth textured plane panning by
    (2, 1) pixels per frame, with a slow chroma gradient. ch: chroma height
    (h // 2 for 4:2:0, the default; h for 4:2:2)."""
    ch = h // 2 if ch is None else ch
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.clip(
        128 + 60 * np.sin(xx / 17.0) * np.cos(yy / 23.0) + rng.normal(0, 8, (h, w)),
        0, 255,
    ).astype(np.uint8)
    cxx = np.mgrid[0:ch, 0 : w // 2][1]
    frames = []
    for i in range(n):
        y = np.roll(np.roll(base, 2 * i, axis=1), i, axis=0)
        cb = np.clip(110 + 40 * np.sin(cxx / 31.0 + i * 0.1), 0, 255).astype(np.uint8)
        cr = np.full((ch, w // 2), 128, np.uint8)
        frames.append((y, cb, cr))
    return frames


def frames_1080p_hard(n: int = 8, h: int = 1080, w: int = 1920):
    """bench.py's BENCH_CONTENT=hard content: a textured plane (a warped
    sine, a square-wave checker and noise) displaced by large,
    direction-changing steps with fresh noise every frame, and Cb/Cr
    sinusoids that drift, so skip and zero-MV shortcuts do not apply."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.clip(
        128
        + 70 * np.sin(xx / 5.0 + np.cos(yy / 7.0) * 3.0)
        + 40 * np.sign(np.sin(xx / 37.0) * np.sin(yy / 29.0))
        + rng.normal(0, 24, (h, w)),
        0, 255,
    ).astype(np.uint8)
    frames = []
    for i in range(n):
        dx = int(18 * np.sin(i * 1.3)) + 7 * i
        dy = int(11 * np.cos(i * 0.9)) + 3 * i
        y = np.roll(np.roll(base, dx, axis=1), dy, axis=0)
        y = np.clip(
            y.astype(np.int16) + rng.normal(0, 6, (h, w)).astype(np.int16), 0, 255,
        ).astype(np.uint8)
        cb = np.clip(110 + 60 * np.sin(xx[: h // 2, : w // 2] / 9.0 + i * 0.7),
                     0, 255).astype(np.uint8)
        cr = np.clip(140 + 50 * np.cos(yy[: h // 2, : w // 2] / 11.0 - i * 0.5),
                     0, 255).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


# bench.py's BENCH_CONTENT=hard encoder settings (High, 4 slices, 8x8
# transform, every partition size, 3 references; QP 24, preset medium)
HARD_X264 = "slices=4:8x8dct=1:partitions=all:ref=3"


def encode_hard(frames, gop: int, extra_x264: str = "") -> bytes:
    """bench.py's hard recipe over `frames` (golden/lavc.py, libx264)."""
    from ..golden import lavc

    return lavc.encode_x264(frames, qp=24, profile="high", cabac=True, bframes=2,
                            preset="medium", gop=gop,
                            extra_x264=HARD_X264 + (":" + extra_x264 if extra_x264 else ""))


def frames_cif(n: int = 8, h: int = 288, w: int = 352):
    """Moving texture with a brightness fade (so weighted prediction is
    really used) and local detail (so Intra8x8 and 4x4 modes occur)."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 50 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
            + 30 * np.sign(np.sin(xx / 23.0 + yy / 31.0)) + rng.normal(0, 10, (h, w)))
    frames = []
    for i in range(n):
        g = 1.0 - 0.06 * i
        y = np.clip(np.roll(base, 3 * i, axis=1) * g + 4 * i, 0, 255).astype(np.uint8)
        cb = np.clip(120 + 40 * np.sin(xx[: h // 2, : w // 2] / 11.0 + 0.3 * i) * g,
                     0, 255).astype(np.uint8)
        cr = np.clip(130 + 35 * np.cos(yy[: h // 2, : w // 2] / 7.0 - 0.2 * i) * g,
                     0, 255).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def with_444_chroma(frames, fade: float = 0.0, seed: int = 13):
    """The frames' luma with full-size Cb and Cr of a texture of their own
    (two oriented sine patterns with noise, panning by (2, 1) pixels per
    frame; with a fade, scaled by 1 - fade * i and lifted by 4 * i like
    frames_cif's luma), so the chroma planes code residuals, Intra4x4/8x8
    modes and weights of their own."""
    h, w = frames[0][0].shape
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cb0 = 128 + 40 * np.sin(xx / 13.0 + yy / 29.0) + rng.normal(0, 4, (h, w))
    cr0 = 128 + 35 * np.cos(yy / 11.0 - xx / 37.0) + rng.normal(0, 4, (h, w))
    out = []
    for i, (y, _, _) in enumerate(frames):
        g, lift = 1.0 - fade * i, 4 * i if fade else 0
        cb, cr = (np.clip(np.roll(np.roll(c, 2 * i, axis=1), i, axis=0) * g + lift, 0, 255)
                  .astype(np.uint8) for c in (cb0, cr0))
        out.append((y, cb, cr))
    return out


def to_10bit(frames):
    """8-bit content scaled to 10 bits (samples x 4), as uint16 planes."""
    return [tuple(p.astype(np.uint16) << 2 for p in planes) for planes in frames]


def plane_md5s(frames) -> list[list[str]]:
    return [[hashlib.md5(np.ascontiguousarray(p).tobytes()).hexdigest() for p in planes]
            for planes in frames]


def golden_planes(golden, bit_depth: int):
    """libavcodec's planes per frame; a monochrome frame's missing chroma
    planes become the 4:2:0 mid-gray planes the decoder presents."""
    out = []
    for g in golden:
        y, cb, cr = g.planes()
        if cb.size == 0:
            cb = cr = np.full(((y.shape[0] + 1) // 2, (y.shape[1] + 1) // 2),
                              1 << (bit_depth - 1), y.dtype)
        out.append((y, cb, cr))
    return out


def main(names=None):
    from ..golden import lavc

    cif = "8x8dct=1:slices=4:weightp=2:ref=3"
    # name -> () -> (stream, bit depth, chroma format)
    streams = {
        "smoke_1080p_main_cabac.h264": lambda: (lavc.encode_x264(
            frames_1080p(), qp=28, profile="main", cabac=True, bframes=2,
            preset="fast", gop=8,
        ), 8, "420"),
        "smoke_cif_high.h264": lambda: (lavc.encode_x264(
            frames_cif(), qp=28, profile="high", cabac=True, bframes=2,
            preset="medium", gop=8, extra_x264=cif,
        ), 8, "420"),
        "smoke_1080p_high422_10.h264": lambda: (lavc.encode_x264(
            to_10bit(frames_1080p(ch=1080)), qp=28, profile="high422", csp="yuv422p10le",
            cabac=True, bframes=2, preset="fast", gop=8, extra_x264="8x8dct=1",
        ), 10, "422"),
        "smoke_cif_high10.h264": lambda: (lavc.encode_x264(
            to_10bit(frames_cif()), qp=28, profile="high10", csp="yuv420p10le",
            cabac=True, bframes=2, preset="medium", gop=8, extra_x264=cif,
        ), 10, "420"),
        "smoke_cif_gray.h264": lambda: (lavc.encode_x264(
            [(y,) for y, _, _ in frames_cif()], qp=28, profile="high", csp="gray",
            cabac=True, bframes=2, preset="medium", gop=8, extra_x264="8x8dct=1",
        ), 8, "gray"),
        "smoke_1080p_high444.h264": lambda: (lavc.encode_x264(
            with_444_chroma(frames_1080p()), qp=28, profile="high444", csp="yuv444p",
            cabac=True, bframes=2, preset="fast", gop=8, extra_x264="8x8dct=1",
        ), 8, "444"),
        "smoke_cif_high444.h264": lambda: (lavc.encode_x264(
            with_444_chroma(frames_cif(), fade=0.06), qp=28, profile="high444",
            csp="yuv444p", cabac=True, bframes=2, preset="medium", gop=8,
            extra_x264=cif + ":cqm=jvt",
        ), 8, "444"),
        "smoke_1080p_main_slices4_nodb.h264": lambda: (lavc.encode_x264(
            frames_1080p(), qp=28, profile="main", cabac=True, bframes=2, preset="fast",
            gop=8, extra_x264="slices=4:no-deblock=1",
        ), 8, "420"),
        "smoke_cif_main_slices2_nodb.h264": lambda: (lavc.encode_x264(
            frames_cif(), qp=28, profile="main", cabac=True, bframes=2, preset="medium",
            gop=8, extra_x264="slices=2:no-deblock=1",
        ), 8, "420"),
        "smoke_1080p_high_hard.h264": lambda: (encode_hard(frames_1080p_hard(), gop=8),
                                               8, "420"),
        "smoke_1080p_main_gop4.h264": lambda: (lavc.encode_x264(
            frames_1080p(16), qp=28, profile="main", cabac=True, bframes=2, preset="fast",
            gop=4, extra_x264="keyint=4:min-keyint=4:scenecut=0",
        ), 8, "420"),
    }
    unknown = set(names or ()) - set(streams)
    if unknown:
        raise SystemExit(f"unknown stream names: {sorted(unknown)}")
    md5_path = os.path.join(HERE, "smoke_md5.json")
    md5 = {}
    if names:
        with open(md5_path) as f:
            md5 = json.load(f)
    for name in names or streams:
        bs, bit_depth, chroma = streams[name]()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(bs)
        golden = lavc.decode_annexb(bs)
        md5[name] = {
            "width": int(golden[0].y.shape[1]),
            "height": int(golden[0].y.shape[0]),
            "bit_depth": bit_depth,
            "chroma": chroma,
            "frames": plane_md5s(golden_planes(golden, bit_depth)),
        }
        print(f"{name}: {len(bs)} bytes, {len(golden)} frames")
    with open(md5_path, "w") as f:
        json.dump(md5, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:])
