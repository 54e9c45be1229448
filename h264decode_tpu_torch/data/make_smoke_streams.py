"""Generate the committed smoke streams and their libavcodec MD5s.

    python -m h264decode_tpu_torch.data.make_smoke_streams

Writes, next to this file:
  smoke_1080p_main_cabac.h264  1920x1080 Main CABAC, I/P/B with 2 B-frames,
                               x264 preset fast, QP 28, 8 frames (the stream
                               recipe of bench.py's default content)
  smoke_cif_high.h264          352x288 High CABAC, 8x8dct, 4 slices,
                               weightp=2, ref=3, 2 B-frames, 8 frames
  smoke_md5.json               per stream: libavcodec's per-frame, per-plane
                               MD5s (output order) and its frame geometry

Needs the system libavcodec/libx264 (golden/lavc.py); decoding the streams
needs neither, which is why they are committed.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def frames_1080p(n: int = 8, h: int = 1080, w: int = 1920):
    """bench.py's default content: a smooth textured plane panning by
    (2, 1) pixels per frame, with a slow chroma gradient."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.clip(
        128 + 60 * np.sin(xx / 17.0) * np.cos(yy / 23.0) + rng.normal(0, 8, (h, w)),
        0, 255,
    ).astype(np.uint8)
    frames = []
    for i in range(n):
        y = np.roll(np.roll(base, 2 * i, axis=1), i, axis=0)
        cb = np.clip(110 + 40 * np.sin(xx[: h // 2, : w // 2] / 31.0 + i * 0.1),
                     0, 255).astype(np.uint8)
        cr = np.full((h // 2, w // 2), 128, np.uint8)
        frames.append((y, cb, cr))
    return frames


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


def plane_md5s(frames) -> list[list[str]]:
    return [[hashlib.md5(np.ascontiguousarray(p).tobytes()).hexdigest() for p in planes]
            for planes in frames]


def main():
    from ..golden import lavc

    streams = {
        "smoke_1080p_main_cabac.h264": lavc.encode_x264(
            frames_1080p(), qp=28, profile="main", cabac=True, bframes=2,
            preset="fast", gop=8,
        ),
        "smoke_cif_high.h264": lavc.encode_x264(
            frames_cif(), qp=28, profile="high", cabac=True, bframes=2,
            preset="medium", gop=8, extra_x264="8x8dct=1:slices=4:weightp=2:ref=3",
        ),
    }
    md5 = {}
    for name, bs in streams.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(bs)
        golden = lavc.decode_annexb(bs)
        md5[name] = {
            "width": int(golden[0].y.shape[1]),
            "height": int(golden[0].y.shape[0]),
            "frames": plane_md5s([g.planes() for g in golden]),
        }
        print(f"{name}: {len(bs)} bytes, {len(golden)} frames")
    with open(os.path.join(HERE, "smoke_md5.json"), "w") as f:
        json.dump(md5, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
