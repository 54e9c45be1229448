"""Output writers: Y4M (mplayer/ffmpeg-compatible) and NPZ.

The reference never produces pixels (README.md:10 lists YCbCr decode as
TODO); these are the L9 output layer of SURVEY.md.
"""

from __future__ import annotations

import numpy as np


def write_y4m(path: str, frames, fps=(25, 1)) -> int:
    """frames: iterable of objects with .y/.cb/.cr uint8 planes; the chroma
    tag (C420mpeg2/C422/C444) is derived from the plane shapes.

    Streams: each frame is written (and its planes released) as it arrives,
    so piping `Decoder.decode_iter` through here holds O(1) frames in
    memory. Returns the number of frames written."""
    it = iter(frames)
    try:
        first = next(it)
    except StopIteration:
        return 0
    h, w = first.y.shape
    ch, cw = first.cb.shape
    if (ch, cw) == (h, w):
        ctag = "C444"
    elif ch == h:
        ctag = "C422"
    else:
        ctag = "C420mpeg2"
    n = 0
    with open(path, "wb") as f:
        f.write(
            f"YUV4MPEG2 W{w} H{h} F{fps[0]}:{fps[1]} Ip A1:1 {ctag}\n".encode()
        )

        def emit(fr):
            f.write(b"FRAME\n")
            f.write(np.ascontiguousarray(fr.y).tobytes())
            f.write(np.ascontiguousarray(fr.cb).tobytes())
            f.write(np.ascontiguousarray(fr.cr).tobytes())

        emit(first)
        n = 1
        for fr in it:
            emit(fr)
            n += 1
    return n


def write_npz(path: str, frames) -> None:
    ys = np.stack([f.y for f in frames])
    cbs = np.stack([f.cb for f in frames])
    crs = np.stack([f.cr for f in frames])
    pocs = np.array([f.poc for f in frames])
    np.savez_compressed(path, y=ys, cb=cbs, cr=crs, poc=pocs)
