"""The main thread's host stages of a decode, with no device and no pixels.

    python -m h264decode_tpu_torch.tools.host_stages [--stream NAME] [--frames N]

Decodes a committed stream (h264decode_tpu_torch/data/) through the base
Decoder with its pixel reconstruction replaced by a stub, so only what the
decoding thread itself runs is timed: parsing, picture set-up, the entropy
decode (the native engine's calls apart) and picture finish. The stub
returns 1x1 planes, and the picture's host buffers go back to the
decoder's pool as they do after a real reconstruction. Prints one JSON
line: wall and CPU ms a picture of each DecodeMetrics timer (entropy_native
summed over the slice threads). Host figures only, of the host it runs
on; the card's host gives its own through benchmarks/run.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..pipeline.decoder import Decoder
from ..utils.metrics import DecodeMetrics

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
STAGES = ("parse", "picture_setup", "entropy", "entropy_native", "picture_finish")


class _NoPixels(Decoder):
    def _reconstruct(self, ft, sps, pps, slices, ref_lists, weight_ctx, poc):
        plane = np.zeros((1, 1), np.uint8)
        return plane, plane, plane


def host_stages(data: bytes, frames: int | None = None) -> dict:
    """{stage: {"wall_ms", "cpu_ms"} a picture} over the first `frames`
    output frames of `data` (all when None), and "pictures"."""
    m = DecodeMetrics()
    n = 0
    for _ in _NoPixels(metrics=m).decode_iter(data):
        n += 1
        if frames is not None and n >= frames:
            break
    pics = m.counters["frames"]
    out = {"pictures": pics}
    for k in STAGES:
        out[k] = {"wall_ms": m.timers.get(k, 0.0) / pics * 1e3,
                  "cpu_ms": m.cpu_timers.get(k, 0.0) / pics * 1e3}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the main thread's host stages, no device")
    ap.add_argument("--stream", default="smoke_1080p_main_cabac_240f.h264",
                    help="a stream of h264decode_tpu_torch/data/")
    ap.add_argument("--frames", type=int, default=None, help="output frames to decode")
    args = ap.parse_args(argv)
    with open(os.path.join(DATA, args.stream), "rb") as f:
        data = f.read()
    print(json.dumps({"stream": args.stream, **host_stages(data, args.frames)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
