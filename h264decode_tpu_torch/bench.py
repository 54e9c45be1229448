"""Decode-throughput benchmark of the port: 1080p Main CABAC on one device.

    python -m h264decode_tpu_torch bench [--device cuda|cpu]

The counterpart of the JAX package's root bench.py, with its output: one
JSON line on stdout, {"metric", "value", "unit", "vs_baseline"}, under the
same metric names, and on stderr the per-stage timers and the end-to-end
rate with the device-to-host download. The metric is frames per second
decoded (residuals, MC, intra and deblocking), timed from the first byte to
the last frame computed on the device (each frame's sync(), then
torch.cuda.synchronize()), after one warm decode; the download of the
planes is timed after that fence. Every frame is then checked bit-exact
(per-plane MD5) against libavcodec. vs_baseline is against the 60 frames/s
target of BASELINE.json.

Configuration via the environment, as bench.py:
  BENCH_SIZE    1080p (default) | 720p | qcif
  BENCH_FRAMES  frames of the stream (default 8; 16 with BENCH_MESH)
  BENCH_CONTENT hard: bench.py's high-motion textured content at QP 24,
                High, 4 slices, ref=3, partitions=all, preset medium
                (data/make_smoke_streams.frames_1080p_hard, encode_hard);
                the per-chip metric takes the suffix _hard, as in bench.py
  BENCH_MESH    GxR: GopParallelDecoder over a G x R mesh (dist/), on a
                stream with an IDR every 4 frames; CUDA meshes take the
                visible devices, a CPU mesh repeats the CPU

The card's machine has no libx264, so the 1080p streams of 8 frames are
committed (data/smoke_1080p_main_cabac.h264, and for BENCH_CONTENT=hard
data/smoke_1080p_high_hard.h264), as is the default BENCH_MESH stream
(data/smoke_1080p_main_gop4.h264, 16 frames, IDR every 4); each is held to
its committed MD5s (data/smoke_md5.json). Any other size, frame count or
mesh stream is encoded here with x264 (golden/lavc.py; bench.py's default
content is data/make_smoke_streams.frames_1080p) and held to libavcodec's
decode; without libx264 that raises, naming the stream.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SIZES = {"1080p": (1080, 1920), "720p": (720, 1280), "qcif": (144, 176)}
MESH_GOP = 4  # frames per closed GOP of the BENCH_MESH stream
# (size, frames, gop, hard) -> committed stream
COMMITTED = {("1080p", 8, None, False): "smoke_1080p_main_cabac.h264",
             ("1080p", 8, None, True): "smoke_1080p_high_hard.h264",
             ("1080p", 16, MESH_GOP, False): "smoke_1080p_main_gop4.h264"}


def _md5s(planes) -> list[str]:
    return [hashlib.md5(np.ascontiguousarray(np.asarray(p)).tobytes()).hexdigest()
            for p in planes]


def hard() -> bool:
    return os.environ.get("BENCH_CONTENT", "") == "hard"


def stream(size: str, n_frames: int, gop: int | None) -> tuple[bytes, list]:
    """(Annex-B bytes, per-frame per-plane MD5s that libavcodec decodes) of
    the BENCH_CONTENT stream; gop: frames per closed GOP, or None for one
    GOP of max(4, n_frames) frames as bench.py."""
    name = COMMITTED.get((size, n_frames, gop, hard()))
    if name is not None:
        with open(os.path.join(DATA, name), "rb") as f:
            bs = f.read()
        with open(os.path.join(DATA, "smoke_md5.json")) as f:
            return bs, json.load(f)[name]["frames"]
    from .data.make_smoke_streams import encode_hard, frames_1080p, frames_1080p_hard
    from .golden import lavc

    h, w = SIZES[size]
    closed = f"keyint={gop}:min-keyint={gop}:scenecut=0" if gop else ""
    gop = gop or max(4, n_frames)
    try:
        if hard():
            bs = encode_hard(frames_1080p_hard(n_frames, h, w), gop, closed)
        else:
            bs = lavc.encode_x264(frames_1080p(n_frames, h, w), qp=28, profile="main",
                                  cabac=True, bframes=2, preset="fast", gop=gop,
                                  extra_x264=closed)
    except RuntimeError as exc:
        raise RuntimeError(
            f"bench: no committed stream for the {'hard' if hard() else 'default'} content at "
            f"{size}, {n_frames} frames, {gop} frames a GOP, and x264 cannot encode it "
            f"here: {exc}") from exc
    return bs, [_md5s(g.planes()) for g in lavc.decode_annexb(bs)]


def _fence(frames, device: torch.device):
    for f in frames:
        f.sync()
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check(frames, want, what: str):
    got = [_md5s(f.planes()) for f in frames]
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError(f"{what}: frames {bad} differ from libavcodec "
                             f"({len(got)} decoded, {len(want)} expected)")


def _line(metric: str, fps: float) -> None:
    print(json.dumps({"metric": metric, "value": round(fps, 4), "unit": "frames/s",
                      "vs_baseline": round(fps / 60.0, 5)}), flush=True)


def bench_mesh(size: str, n_frames: int, spec: str, device: str) -> int:
    """GopParallelDecoder over a G x R mesh (bench.py:104-163)."""
    from .dist.gop import GopParallelDecoder
    from .dist.mesh import make_mesh

    G, R = (int(v) for v in spec.lower().split("x"))
    n_dev = G * R if device == "cpu" else torch.cuda.device_count()
    metric = f"{size}_main_cabac_fps_mesh{G}x{R}"  # no _hard suffix here, as bench.py
    if G * R > n_dev:
        print(json.dumps({"metric": metric, "value": 0.0, "unit": "frames/s",
                          "vs_baseline": 0.0, "error": f"needs {G * R} devices, have {n_dev}"}))
        return 1
    mesh = make_mesh(G, R, devices=["cpu"] * (G * R) if device == "cpu" else None)
    bs, want = stream(size, n_frames, MESH_GOP)
    GopParallelDecoder(mesh).decode_stream(bs)  # warm
    t0 = time.perf_counter()
    frames = GopParallelDecoder(mesh).decode_stream(bs)  # host planes: nothing to fence
    dt = time.perf_counter() - t0
    _check(frames, want, f"mesh {G}x{R}")
    _line(metric, len(frames) / dt)
    print(f"# mesh {G}x{R}: {len(frames)} frames in {dt:.4f}s -> {len(frames) / dt:.4f} fps "
          "(bit-exact vs libavcodec)", file=sys.stderr)
    return 0


def main(device: str = "cuda") -> int:
    from .pipeline.gpu_pipeline import GpuDecoder
    from .utils.metrics import DecodeMetrics

    size = os.environ.get("BENCH_SIZE", "1080p")
    spec = os.environ.get("BENCH_MESH")
    n_frames = int(os.environ.get("BENCH_FRAMES", "16" if spec else "8"))
    if spec:
        return bench_mesh(size, n_frames, spec, device)
    bs, want = stream(size, n_frames, None)
    dev = torch.device(device)
    t_warm = time.perf_counter()
    with GpuDecoder(device=dev) as dec:
        _fence(dec.decode_stream(bs), dev)
    warm_s = time.perf_counter() - t_warm
    metrics = DecodeMetrics()
    with GpuDecoder(device=dev, metrics=metrics) as dec:
        t0 = time.perf_counter()
        frames = dec.decode_stream(bs)
        _fence(frames, dev)
        dt = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = [f.planes() for f in frames]  # device -> host, timed apart
    dl = time.perf_counter() - t1
    _check(frames, want, size)
    fps = len(frames) / dt
    _line(f"{size}_main_cabac_fps_per_chip" + ("_hard" if hard() else ""), fps)
    nbytes = sum(p.nbytes for fr in out for p in fr)
    print(f"# {len(frames)} frames decoded in {dt:.4f}s -> {fps:.4f} fps on {dev} "
          f"(bit-exact vs libavcodec); warm-up decode {warm_s:.2f}s; per-stage: "
          f"{json.dumps(metrics.summary())}", file=sys.stderr)
    print(f"# e2e incl. device->host download: {len(frames) / (dt + dl):.4f} fps (download "
          f"{dl:.4f}s for {len(frames)} frames, {nbytes / max(dl, 1e-9) / 1e6:.1f} MB/s)",
          file=sys.stderr)
    return 0
