#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (h264decode_tpu_torch) on one GPU.

    python3 chip_smoke.py [--phases kernels,main,serve,dist,probe]

Run from the repository root on a machine with a CUDA device. Phases (each
raises on failure, and the script then exits non-zero); without --phases
every phase runs, and step 1 always does:

1. Print the card's name and power limit (nvidia-smi), build the CUDA
   kernels (one nvcc per csrc/*.cu, started together) and the native
   entropy engine, and print the build time.
2. Kernels against their plain torch versions on the card, at 1080p
   geometry (68 x 120 MBs), in three instantiations: 4:2:0 8-bit, 4:2:2
   10-bit (16-line chroma MBs, uint16 deblock samples) and 8-bit 4:4:4
   (intra_luma and deblock_luma over the Y, Cb and Cr planes in one launch;
   Y takes the 4:2:0 phase's luma inputs). Seeded inputs
   cover every MB kind, all 9 Intra4x4/8x8 modes, all 4 Intra16x16 and
   chroma modes, random availability combinations, bS 0..4, QP 0 and 51,
   and samples over the whole range of the bit depth. Bit-exact (tolerance
   0: integer outputs). Race check by repetition: each kernel's call is
   captured in a CUDA graph and replayed 20 times from the reset inputs,
   every replay bit-exact against the plain output. Kernel times: CUDA
   events around one replay of that graph, median of 5 (the eager call's
   event time, which includes the host's enqueue gaps, is printed beside
   it); the 3-plane kernels are timed beside a graph of three single-plane
   calls. Plain versions: events around the one call whose output is
   compared (an intra call takes about 20 s a plane).
3. The main path: first the host's core counts (os.cpu_count() and the
   cores this process may run on), which bound how many pictures' entropy
   decodes run at once; then, stream by stream, through GpuDecoder (launch counters
   set to 0 just before, read just after; every kernel of the stream's
   format must have launched, each exactly one device kernel (a persistent
   row wavefront) per call, a 4:4:4 stream no chroma kernel at all, and the
   native entropy engine must have decoded) and through
   `python -m h264decode_tpu_torch decode`. GpuDecoder dispatches every
   frame by replaying the frame program of its signature, a CUDA graph of
   frame_step (pipeline/frame_program.py); the wrappers count their
   launches when the program is captured, and every replay adds that count
   again. The first decode of a stream captures the programs its geometry
   lacks; the checked decode after it must capture none and replay one
   program per frame. Every frame's per-plane MD5 must equal libavcodec's
   committed MD5s. Prints frames/s from the median of three decodes (timing
   fence: torch.cuda.synchronize()), the per-stage timers, the programs'
   keys, captures, capture seconds, replays and dispatch seconds per frame,
   and peak device memory (the capturing and the replaying decode, the
   RingSet's graph pool, and the largest transient of an eager frame_step
   call on the same frames); and for the 1080p streams and CIF High a
   torch.profiler trace of one more decode (device busy time, idle share,
   device activities and host launch calls per frame, top device kernels,
   and the device records of each expected kernel, which must not be
   zero). The streams: 1080p Main CABAC,
   CIF High (Intra8x8, weighted prediction, 4 slices), 1080p High 4:2:2
   10-bit (I/P/B, 8x8 transform), CIF High 10 (weighted prediction, 4
   slices), CIF monochrome, 1080p High 4:4:4 Predictive 8-bit (I/P/B, 8x8
   transform), CIF High 4:4:4 (the CIF High options and the JVT scaling
   lists) and 1080p High "hard" (bench.py's BENCH_CONTENT=hard content
   and recipe: QP 24, 4 slices, partitions=all, ref=3), traced too. Then
   `python -m h264decode_tpu_torch bench` with BENCH_CONTENT=hard, whose
   line must name 1080p_main_cabac_fps_per_chip_hard (it checks every
   frame against the committed MD5s itself).
4. `python -m h264decode_tpu_torch serve --port 0 --once` as a subprocess
   on the card, fed the 1080p 4:4:4 stream over TCP: its Y4M must match
   the committed MD5s; prints the wall time from connecting to its exit
   and the connection's program keys, captures, replays, dispatch seconds
   per frame and peak device memory.
5. The multi-device path (dist/) on meshes that repeat cuda:0. First the
   four kernels with their halo inputs (intra's row above MB row 0,
   deblocking's 4 rows above it, filtered and returned) at one band of a
   1x4 mesh at 1080p (17 x 120 MBs), held and timed as in step 2: the
   kernel table's *_halo rows. Then ShardedDecoder 1x1, 1x2 and 1x4 (halo
   mode) on the 1080p Main stream and 1x4 on its 4-slice, deblocking-off
   twin (aligned mode, checked), and GopParallelDecoder 2x1 and 2x2 on the
   16-frame 1080p Main stream with an IDR every 4 frames. Every frame runs
   through band programs (dist/sharded.py: CUDA graphs captured once per
   band and signature, replayed every frame, the four halo kernels inside).
   A first decode captures them; in the checked decode (launch counters
   set to 0 just before, read just after) every frame must match the
   committed MD5s, each kernel must have launched exactly where the eager
   step launched it (the *_halo launches where bands pass rows, none
   elsewhere), one device kernel per call, no wrapper may have entered its
   C entry (every launch came from a replay), nothing may be captured and
   every band program of every frame replayed. Prints the programs' keys,
   captures, capture seconds, replays, dispatch seconds per frame and graph
   pool bytes of both decodes, read from the ShardSets' own counts (so the
   gop slots' too), and frames/s beside GpuDecoder's on the same stream;
   the 1x1 and 1x4 halo runs get a torch.profiler trace (host launch calls
   a frame, under 100; device activities a frame; idle share; device
   records of each kernel, from replays alone). Then
   `python -m h264decode_tpu_torch decode --backend sharded --mesh 1x1`.
6. The stage-attribution probe (h264decode_tpu_torch/tools/perf_probe.py)
   on the 1080p Main, hard, High 4:2:2 10-bit and High 4:4:4 streams: every
   frame replayed on its own references through the nested prefixes of
   frame_step, each prefix captured in a CUDA graph (a capture that fails
   raises), the `full` prefix bit-exact against the decoder's packed frame,
   eager and replayed. The CUDA wrappers' counters, zeroed before each
   eager call, must show the format's intra kernels in `recon` of a frame
   with intra MBs and its deblocking kernels in `deblock` of a deblocked
   frame, one device kernel per call. Logs each stream's stage table
   (host ms, graph-replay device ms and device activities per frame, over
   I and inter frames), the capturing decode's program keys, captures,
   replays, dispatch seconds per frame and peak device memory (ring
   snapshots included), and the phase's time.

The line before the last is the kernel table as JSON (with the main-path,
serve and dist results of the phases that ran); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Raw kernel-build logs go to chiprun_out/chip_smoke_build.log.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "h264decode_tpu_torch", "data")
OUT = os.path.join(ROOT, "chiprun_out")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (fp32 table entry)
MB_H, MB_W = 68, 120  # 1920x1088 coded
REPLAYS = 20  # graph replays per kernel in the race check
# the wrappers, each one persistent launch per call
ROW_KERNELS = ("intra_luma", "intra_chroma", "deblock_luma", "deblock_chroma")
# a 4:4:4 stream runs Cb and Cr through the luma kernels (three planes a
# launch) and must launch the chroma kernels zero times
LUMA_KERNELS = ("intra_luma", "deblock_luma")
# the kernels' instantiations held against their plain versions:
# (ChromaArrayType, bit depth) -> suffix of the kernel table's row names
FORMATS = {(1, 8): "", (2, 10): "_422_10", (3, 8): "_444"}
# committed streams: (name, format suffix of the kernel rows its launches
# count for or None, whether to trace it)
STREAMS = (("smoke_1080p_main_cabac.h264", "", True),
           ("smoke_cif_high.h264", None, True),
           ("smoke_1080p_high422_10.h264", "_422_10", True),
           ("smoke_cif_high10.h264", None, False),
           ("smoke_cif_gray.h264", None, False),
           ("smoke_1080p_high444.h264", "_444", True),
           ("smoke_cif_high444.h264", None, False),
           ("smoke_1080p_high_hard.h264", None, True))
# the stream `bench` decodes with BENCH_CONTENT=hard, and its metric
HARD_STREAM = "smoke_1080p_high_hard.h264"
HARD_METRIC = "1080p_main_cabac_fps_per_chip_hard"
# the probe phase's streams and the timed graph replays of each prefix
PROBE_STREAMS = ("smoke_1080p_main_cabac.h264", HARD_STREAM, "smoke_1080p_high422_10.h264",
                 "smoke_1080p_high444.h264")
PROBE_REPLAYS = 5
# the stream the serve phase sends over TCP
SERVE_STREAM = "smoke_1080p_high444.h264"
# the dist phase: one band of a 1x4 mesh at 1080p for the halo kernel rows
BAND_H = MB_H // 4
# the wrappers' launches given halo rows (counted under their own names)
HALO_KERNELS = tuple(k + "_halo" for k in ROW_KERNELS)
# the dist phase's decodes on meshes that repeat cuda:0: (label, stream,
# mesh (G, R), decoder, mode of every frame)
DIST_RUNS = (
    ("sharded 1x1", "smoke_1080p_main_cabac.h264", (1, 1), "sharded", "halo"),
    ("sharded 1x2 halo", "smoke_1080p_main_cabac.h264", (1, 2), "sharded", "halo"),
    ("sharded 1x4 halo", "smoke_1080p_main_cabac.h264", (1, 4), "sharded", "halo"),
    ("sharded 1x4 aligned", "smoke_1080p_main_slices4_nodb.h264", (1, 4), "sharded", "aligned"),
    ("gop 2x1", "smoke_1080p_main_gop4.h264", (2, 1), "gop", "halo"),
    ("gop 2x2", "smoke_1080p_main_gop4.h264", (2, 2), "gop", "halo"),
)
# the run whose launches fill the kernel table's *_halo rows
HALO_RUN = "sharded 1x4 halo"
# the dist runs traced with torch.profiler
TRACED_DIST_RUNS = ("sharded 1x1", HALO_RUN)
PHASES = ("kernels", "main", "serve", "dist", "probe")


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, setup=None, runs: int = 5, warmup: int = 1) -> float:
    """Median time of fn() in ms between CUDA events recorded around the
    call (host enqueue gaps included); setup() (not timed) runs before each
    call."""
    import torch

    times = []
    for i in range(warmup + runs):
        if setup is not None:
            setup()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(a.elapsed_time(b))
    return statistics.median(times)


def capture(fn, reset):
    """fn()'s launches captured once in a CUDA graph (after reset())."""
    import torch

    g = torch.cuda.CUDAGraph()
    reset()
    torch.cuda.synchronize()
    with torch.cuda.graph(g):  # fn launches on the capture stream
        fn()
    return g


def graph_ms(g, reset, runs: int = 5) -> float:
    """Median device time in ms of one replay of graph g: the launches of
    one call (the scratch memset and one persistent kernel) run back to
    back, so the host's enqueue speed does not enter. reset() (not timed)
    restores the tensors in place before each replay."""
    return cuda_ms(g.replay, reset, runs=runs)


def replay_check(name: str, g, reset, outs, wants, n: int = REPLAYS) -> None:
    """Race check by repetition: replay g n times from the reset inputs and
    hold every replay's outputs to the plain outputs, bit for bit."""
    import torch

    for i in range(n):
        reset()
        g.replay()
        torch.cuda.synchronize()
        for o, w in zip(outs, wants):
            if not torch.equal(o, w):
                raise RuntimeError(f"{name}: graph replay {i} of {n} differs from the "
                                   f"plain version")


def program_figures(counters: dict, timers: dict, frames: int) -> dict:
    """The frame programs' figures of one decode from its DecodeMetrics
    counters and timers (unrounded): distinct keys, graph captures and
    their seconds (the warm call and the capture), replays, and the
    dispatch timer (upload, slot write and replay) per frame."""
    return dict(keys=counters.get("program_keys", 0),
                captures=counters.get("graph_captures", 0),
                capture_s=timers.get("graph_capture", 0.0),
                replays=counters.get("graph_replays", 0),
                dispatch_s_per_frame=timers.get("dispatch", 0.0) / max(frames, 1))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def intra_inputs(dev, seed=1, ch_h=8, bd=8, mb_h=MB_H):
    import torch

    rng = np.random.default_rng(seed)
    n = mb_h * MB_W
    H, W = 16 * mb_h, 16 * MB_W
    Hc, sh = ch_h * mb_h, bd - 8
    kind = rng.integers(0, 4, n).astype(np.int32)  # every kind, ~3/4 intra
    modes4 = rng.integers(0, 9, (n, 16)).astype(np.int32)  # all 9 modes
    i16 = rng.integers(0, 4, n).astype(np.int32)
    cm = rng.integers(0, 4, n).astype(np.int32)
    av = rng.random((4, n)) < 0.5  # all 16 availability combinations
    top, r = 256 << sh, 60 << sh  # samples over 0 .. (1 << bd) - 1
    arrays = dict(
        y=rng.integers(0, top, (H, W)), cb=rng.integers(0, top, (Hc, W // 2)),
        cr=rng.integers(0, top, (Hc, W // 2)), ry=rng.integers(-r, r, (H, W)),
        rcb=rng.integers(-r, r, (Hc, W // 2)),
        rcr=rng.integers(-r, r, (Hc, W // 2)),
    )
    t = {k: torch.as_tensor(v.astype(np.int32), device=dev) for k, v in arrays.items()}
    for k, v in dict(kind=kind, modes4=modes4, i16=i16, cm=cm).items():
        t[k] = torch.as_tensor(v, device=dev)
    for i, k in enumerate(("avl", "avt", "avtr", "avtl")):
        t[k] = torch.as_tensor(av[i], device=dev)
    return t


def deblock_inputs(dev, seed=2, ch_h=8, bd=8, mb_h=MB_H, top_edge=False):
    """Planes and edge parameters; top_edge: also bS 0..4 on MB row 0's top
    edge, which filters across a band boundary against a halo."""
    import torch

    from h264decode_tpu_torch.kernels.deblock_prep_dev import deblock_prep_device

    rng = np.random.default_rng(seed)
    n = mb_h * MB_W
    H4, W4 = 4 * mb_h, 4 * MB_W
    qp = rng.integers(0, 52, n)
    qp[rng.random(n) < 0.1] = 0
    qp[rng.random(n) < 0.1] = 51
    T = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    prep = deblock_prep_device(
        T(rng.integers(0, 8, n).astype(np.int32)), T(qp.astype(np.int32)),
        T(rng.random(n) < 0.4), T((np.arange(n) >= n // 2).astype(np.int32)),
        T(rng.integers(0, 3, n).astype(np.int32)),
        T((2 * rng.integers(-6, 7, n)).astype(np.int32)),
        T((2 * rng.integers(-6, 7, n)).astype(np.int32)),
        T(((rng.random((H4, W4)) < 0.3) * rng.integers(1, 9, (H4, W4))).astype(np.int32)),
        T(np.zeros((n, 2, 4), np.int32)),
        T(rng.integers(-12, 12, (2, H4, W4, 2)).astype(np.int32)),
        (int(rng.integers(-12, 13)), int(rng.integers(-12, 13))), mb_h, MB_W,
        slot_cells=T(rng.integers(-1, 3, (2, H4, W4)).astype(np.int32)),
        chroma_all_h_edges=ch_h == 16,
    )
    keys = ("bs_v", "bs_h", "bs_hc") if ch_h == 16 else ("bs_v", "bs_h")
    if top_edge:
        for k in keys[1:]:
            prep[k][0] = T(rng.integers(0, 5, W4).astype(np.int32))
    for k in keys:
        if set(torch.unique(prep[k]).tolist()) != {0, 1, 2, 3, 4}:
            raise RuntimeError(f"deblock inputs: {k} does not cover bS 0..4")
    shapes = ((16 * mb_h, 16 * MB_W), (ch_h * mb_h, 8 * MB_W), (ch_h * mb_h, 8 * MB_W))
    if bd == 8:  # low-contrast planes so the filters fire
        planes = [torch.as_tensor(np.clip(128 + rng.integers(-12, 13, s), 0, 255)
                                  .astype(np.uint8), device=dev) for s in shapes]
    else:
        # a smooth field over the whole range (clipped at 0 and mx) with
        # low-contrast noise, so the filters fire across MB edges too;
        # int16 planes hold the uint16 samples
        mx, sh = (1 << bd) - 1, bd - 8
        planes = []
        for h, w in shapes:
            yy, xx = np.mgrid[0:h, 0:w]
            field = (mx + 1) / 2 * (1 + 1.1 * np.sin(xx / (w / 7.0)) * np.cos(yy / (h / 5.0)))
            a = np.clip(field + rng.integers(-(12 << sh), (12 << sh) + 1, (h, w)), 0, mx)
            planes.append(torch.as_tensor(a.astype(np.int16), device=dev))
    return planes, prep


def intra_rows(t: dict, mb_h: int, ch_h: int, bd: int, suffix: str, fmt_name: str,
               top=None) -> dict:
    """intra_luma and intra_chroma on inputs t (mb_h x MB_W MBs) against the
    plain version, REPLAYS graph replays bit-exact; top: the rows above MB
    row 0 (y, cb, cr) or None. Returns the kernel table's two rows."""
    import torch

    from h264decode_tpu_torch.kernels import intra_cuda
    from h264decode_tpu_torch.kernels.intra import intra_wavefront

    mid, mx = 1 << (bd - 1), (1 << bd) - 1
    n = mb_h * MB_W
    args = (t["y"], t["cb"], t["cr"], t["ry"], t["rcb"], t["rcr"], t["kind"], t["modes4"],
            t["i16"], t["cm"], t["avl"], t["avt"], t["avtr"], t["avtl"], mb_h, MB_W,
            ch_h, mid, mx)
    # ~20 s a call at 1080p: time the one call whose output is compared
    box = []
    ms_plain = cuda_ms(lambda: box.append(intra_wavefront(*args, top=top)), runs=1, warmup=0)
    plain = box[0]
    params = intra_cuda.pack_params(t["kind"], t["modes4"], t["i16"], t["cm"], t["avl"],
                                    t["avt"], t["avtr"], t["avtl"])
    work = {k: t[k].clone() for k in ("y", "cb", "cr")}

    def reset_intra():
        for k in ("y", "cb", "cr"):
            work[k].copy_(t[k])

    top_l, top_c = (None, None) if top is None else (top[0], top[1:])
    run_l = lambda: intra_cuda.intra_luma(work["y"], t["ry"], params, mb_h, MB_W,  # noqa: E731
                                          mid, mx, top_l)
    run_c = lambda: intra_cuda.intra_chroma(work["cb"], work["cr"], t["rcb"],  # noqa: E731
                                            t["rcr"], params, mb_h, MB_W, ch_h, mid, mx, top_c)
    run_l()
    run_c()
    torch.cuda.synchronize()
    err_l = int((work["y"] - plain[0]).abs().max())
    err_c = max(int((work["cb"] - plain[1]).abs().max()),
                int((work["cr"] - plain[2]).abs().max()))
    g_l, g_c = capture(run_l, reset_intra), capture(run_c, reset_intra)
    replay_check("intra_luma" + suffix, g_l, reset_intra, [work["y"]], plain[:1])
    replay_check("intra_chroma" + suffix, g_c, reset_intra, [work["cb"], work["cr"]],
                 plain[1:])
    ms_l, ms_c = graph_ms(g_l, reset_intra), graph_ms(g_c, reset_intra)
    eager_l, eager_c = cuda_ms(run_l, reset_intra), cuda_ms(run_c, reset_intra)
    n_intra = int((t["kind"] > 0).sum())
    # bytes this data needs: every MB's params row is read; an intra MB reads
    # its residual and neighbour strips and writes its samples (int32); a
    # given top row is read once
    b_l = n * 4 * 20 + n_intra * 4 * (256 * 2 + 16 + 25) + (0 if top is None else 4 * 16 * MB_W)
    b_c = (n * 4 * 20 + n_intra * 4 * 2 * (8 * ch_h * 2 + ch_h + 9)
           + (0 if top is None else 4 * 2 * 8 * MB_W))
    n_i4 = int((t["kind"] == 1).sum())
    n_i8 = int((t["kind"] == 2).sum())
    n_i16 = int((t["kind"] == 3).sum())
    # ~ops: a 4x4 sample ~20, an 8x8 sample ~60 (with reference filtering),
    # a 16x16 or chroma sample ~12, + residual add and clip (3 each)
    ops_l = 256 * (23 * n_i4 + 63 * n_i8 + 15 * n_i16)
    ops_c = 2 * 8 * ch_h * 15 * n_intra
    res = {}
    for name, err, ms, nb, ops, src in (
        ("intra_luma", err_l, ms_l, b_l, ops_l, "intra_pallas.py:440"),
        ("intra_chroma", err_c, ms_c, b_c, ops_c, "intra_pallas.py:590"),
    ):
        bms, by = bound(nb, ops)
        res[name + suffix] = dict(
            name=name + suffix, kernel=name, format=fmt_name, route="cuda",
            source="h264decode_tpu_torch/csrc/intra.cu",
            replaces=f"h264decode_tpu/kernels/{src}", max_abs_err=err, ms=ms,
            plain_ms=ms_plain, bound_ms=bms, bound_by=by, library_ms=None)
    log(f"intra {fmt_name}: max_abs_err luma {err_l} chroma {err_c}; kernel ms (graph "
        f"replay) luma {ms_l} chroma {ms_c}; eager call (events around the enqueue) luma "
        f"{eager_l} chroma {eager_c}; plain (both) {ms_plain} ms; "
        f"MBs I4 {n_i4} I8 {n_i8} I16 {n_i16} of {n}; {REPLAYS} graph replays of each "
        f"bit-exact")
    return res


def deblock_rows(planes, prep: dict, mb_h: int, ch_h: int, bd: int, suffix: str,
                 fmt_name: str, halo=None) -> dict:
    """deblock_luma and deblock_chroma on planes and prep (mb_h x MB_W MBs)
    against the plain version, REPLAYS graph replays bit-exact; halo: the 4
    rows above MB row 0 (y, cb, cr), filtered and compared too, or None.
    Returns the kernel table's two rows."""
    import torch

    from h264decode_tpu_torch.kernels import deblock_cuda
    from h264decode_tpu_torch.kernels.deblock import deblock_frame as deblock_plain

    bd_scale, mx = 1 << (bd - 8), (1 << bd) - 1
    sb = 1 if bd == 8 else 2  # bytes per deblock sample
    n = mb_h * MB_W
    fmt = (ch_h, bd_scale, mx)
    inputs = dict(zip(("y", "cb", "cr"), planes))
    if halo is not None:
        inputs.update(zip(("hy", "hcb", "hcr"), halo))
    box = []  # ~5 s a call at 1080p: time the one call whose output is compared
    ms_plain = cuda_ms(lambda: box.append(deblock_plain(*planes, prep, mb_h, MB_W, *fmt,
                                                        halo=halo)), runs=1, warmup=0)
    plain = box[0] if halo is None else (*box[0][0], *box[0][1])
    want = dict(zip(inputs, plain))
    dw = {k: v.clone() for k, v in inputs.items()}

    def reset_db():
        for k, v in inputs.items():
            dw[k].copy_(v)

    outs_l = ["y"] + ([] if halo is None else ["hy"])
    outs_c = ["cb", "cr"] + ([] if halo is None else ["hcb", "hcr"])
    halo_c = None if halo is None else (dw["hcb"], dw["hcr"])
    run_l = lambda: deblock_cuda.deblock_luma(dw["y"], prep, mb_h, MB_W,  # noqa: E731
                                              bd_scale, mx, dw.get("hy"))
    run_c = lambda: deblock_cuda.deblock_chroma(dw["cb"], dw["cr"], prep,  # noqa: E731
                                                mb_h, MB_W, *fmt, halo=halo_c)
    run_l()
    run_c()
    torch.cuda.synchronize()
    i32 = torch.int32

    def err(keys):
        return max(int((dw[k].to(i32) - want[k].to(i32)).abs().max()) for k in keys)

    err_l, err_c = err(outs_l), err(outs_c)
    changed = {k: int((want[k] != v).sum()) for k, v in inputs.items()}
    if 0 in changed.values():
        raise RuntimeError(f"deblock inputs: the plain filter left a plane or halo unchanged "
                           f"({changed} samples changed)")
    g_l, g_c = capture(run_l, reset_db), capture(run_c, reset_db)
    replay_check("deblock_luma" + suffix, g_l, reset_db, [dw[k] for k in outs_l],
                 [want[k] for k in outs_l])
    replay_check("deblock_chroma" + suffix, g_c, reset_db, [dw[k] for k in outs_c],
                 [want[k] for k in outs_c])
    ms_l, ms_c = graph_ms(g_l, reset_db), graph_ms(g_c, reset_db)
    eager_l, eager_c = cuda_ms(run_l, reset_db), cuda_ms(run_c, reset_db)
    bs_c = prep["bs_hc"] if ch_h == 16 else prep["bs_h"]
    mb_any = ((prep["bs_v"] > 0) | (prep["bs_h"] > 0) | (bs_c > 0)
              ).reshape(mb_h, 4, MB_W, 4).any(3).any(1)
    n_act = int(mb_any.sum())
    # bytes: every MB reads its 16 bS pairs; an active MB reads its
    # thresholds and its samples (plus the strips left and above) and writes
    # its samples; sb bytes per sample, chroma tiles of 4 + ch_h lines; a
    # halo's rows are read and the changed ones written back
    b_l = n * 16 * 4 * 2 + n_act * (16 * 4 * 4 + (20 * 20 + 256) * sb)
    b_c = n * 16 * 4 * 2 + n_act * 2 * (16 * 4 * 4 + (12 * (4 + ch_h) + 8 * ch_h) * sb)
    if halo is not None:
        b_l += (4 + 3) * 16 * MB_W * sb
        b_c += 2 * (2 + 1) * 8 * MB_W * sb
    ops_l = n_act * 8 * 16 * 40  # 8 edges x 16 lines x ~40 ops
    # 2 vertical edges x ch_h lines + (2 or 4) horizontal edges x 8 columns
    ops_c = n_act * 2 * (2 * ch_h + (ch_h // 4 if ch_h == 16 else 2) * 8) * 20
    res = {}
    for name, e, ms, nb, ops, src in (
        ("deblock_luma", err_l, ms_l, b_l, ops_l, "deblock_pallas.py:211"),
        ("deblock_chroma", err_c, ms_c, b_c, ops_c, "deblock_pallas.py:295"),
    ):
        bms, by = bound(nb, ops)
        res[name + suffix] = dict(
            name=name + suffix, kernel=name, format=fmt_name, route="cuda",
            source="h264decode_tpu_torch/csrc/deblock.cu",
            replaces=f"h264decode_tpu/kernels/{src}", max_abs_err=e, ms=ms,
            plain_ms=ms_plain, bound_ms=bms, bound_by=by, library_ms=None)
    log(f"deblock {fmt_name}: max_abs_err luma {err_l} chroma {err_c}; kernel ms (graph "
        f"replay) luma {ms_l} chroma {ms_c}; eager call (events around the enqueue) luma "
        f"{eager_l} chroma {eager_c}; plain (both) {ms_plain} ms; active MBs {n_act} of "
        f"{n}; samples changed by the filter {changed}; {REPLAYS} graph replays of each "
        f"bit-exact")
    return res


def kernel_phase(dev, cat: int = 1, bd: int = 8) -> dict:
    """The four kernels' instantiation for ChromaArrayType cat and bit
    depth bd against their plain versions at 1080p geometry; returns the
    kernel table's rows, keyed by row name (kernel name + format suffix),
    and the inputs the 4:4:4 phase reuses."""
    suffix = FORMATS[(cat, bd)]
    ch_h = 16 if cat == 2 else 8
    fmt_name = f"4:2:{'2' if cat == 2 else '0'} {bd}-bit"
    t = intra_inputs(dev, ch_h=ch_h, bd=bd)
    res = intra_rows(t, MB_H, ch_h, bd, suffix, fmt_name)
    planes, prep = deblock_inputs(dev, ch_h=ch_h, bd=bd)
    res.update(deblock_rows(planes, prep, MB_H, ch_h, bd, suffix, fmt_name))
    check_exact(res)
    return res, dict(intra=t, deblock=(planes[0], prep))


def check_exact(rows: dict) -> None:
    bad = {k: v["max_abs_err"] for k, v in rows.items() if v["max_abs_err"] != 0}
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")


def planes_phase(dev, base: dict) -> dict:
    """The 8-bit 4:4:4 instantiation, intra_luma and deblock_luma over the
    Y, Cb and Cr planes in one launch each, against their plain per-plane
    versions at 1080p geometry. Y takes the 4:2:0 phase's luma inputs
    (`base`), and Cb and Cr planes of their own; the plain version runs
    once over all three planes, and that call is timed and compared. In the
    same run, one 3-plane graph is timed against a graph of three
    single-plane calls; both are replayed REPLAYS times bit-exact. Returns
    the kernel table's two rows."""
    import torch

    from h264decode_tpu_torch.kernels import deblock_cuda, intra_cuda

    suffix, fmt_name = FORMATS[(3, 8)], "4:4:4 8-bit (Y, Cb, Cr)"
    rng = np.random.default_rng(3)
    n, H, W = MB_H * MB_W, 16 * MB_H, 16 * MB_W
    res = {}

    def own(lo, hi, dtype):  # Cb and Cr planes of their own
        return torch.as_tensor(rng.integers(lo, hi, (2, H, W)).astype(dtype), device=dev)

    def compare(name, run3, run1x3, work, reset, want):
        """(max_abs_err, 3-plane graph ms, three-calls graph ms)."""
        reset()
        run3()
        torch.cuda.synchronize()
        err = int((work.to(torch.int32) - want.to(torch.int32)).abs().max())
        g3, g1 = capture(run3, reset), capture(run1x3, reset)
        replay_check(name + suffix, g3, reset, [work], [want])
        replay_check(name + suffix + " (three single-plane calls)", g1, reset, [work], [want])
        return err, graph_ms(g3, reset), graph_ms(g1, reset)

    # ---- intra
    t = base["intra"]
    planes = torch.cat([t["y"][None], own(0, 256, np.int32)])
    resid = torch.cat([t["ry"][None], own(-60, 60, np.int32)])
    modes = (t["kind"], t["modes4"], t["i16"], t["avl"], t["avt"], t["avtr"], t["avtl"])
    box = []  # ~20 s a plane: time the one call whose output is compared
    plain_i = cuda_ms(lambda: box.append(intra_cuda.intra_planes_plain(
        planes, resid, *modes, MB_H, MB_W)), runs=1, warmup=0)
    want = box[0]
    params = intra_cuda.pack_params(t["kind"], t["modes4"], t["i16"], torch.zeros_like(t["i16"]),
                                    *modes[3:])
    work = planes.clone()
    err_i, ms_i, ms_i3 = compare(
        "intra_luma",
        lambda: intra_cuda.intra_luma(work, resid, params, MB_H, MB_W),
        lambda: [intra_cuda.intra_luma(work[k], resid[k], params, MB_H, MB_W) for k in range(3)],
        work, lambda: work.copy_(planes), want)
    n_intra = int((t["kind"] > 0).sum())
    n_kind = [int((t["kind"] == k).sum()) for k in (1, 2, 3)]
    # as the 4:2:0 row, with the per-plane work three times: the params
    # table is read once
    b_i = n * 4 * 20 + 3 * n_intra * 4 * (256 * 2 + 16 + 25)
    ops_i = 3 * 256 * (23 * n_kind[0] + 63 * n_kind[1] + 15 * n_kind[2])

    # ---- deblock
    y0, prep = base["deblock"]
    prep3 = deblock_cuda.prep_444(prep)
    preps = [deblock_cuda.plane_prep(prep3, k) for k in range(3)]
    planes = torch.cat([y0[None], own(116, 141, np.uint8)])
    box = []  # ~5 s a plane: time the one call whose output is compared
    plain_d = cuda_ms(lambda: box.append(deblock_cuda.deblock_planes_plain(
        planes, prep3, MB_H, MB_W)), runs=1, warmup=0)
    want = box[0]
    changed = [int((a != b).sum()) for a, b in zip(want, planes)]
    if 0 in changed:
        raise RuntimeError(f"deblock 4:4:4 inputs: a plane left unchanged ({changed})")
    work = planes.clone()
    err_d, ms_d, ms_d3 = compare(
        "deblock_luma",
        lambda: deblock_cuda.deblock_luma(work, prep3, MB_H, MB_W),
        lambda: [deblock_cuda.deblock_luma(work[k], preps[k], MB_H, MB_W) for k in range(3)],
        work, lambda: work.copy_(planes), want)
    mb_any = ((prep["bs_v"] > 0) | (prep["bs_h"] > 0)).reshape(MB_H, 4, MB_W, 4).any(3).any(1)
    n_act = int(mb_any.sum())
    b_d = n * 16 * 4 * 2 + 3 * n_act * (16 * 4 * 4 + 20 * 20 + 256)
    ops_d = 3 * n_act * 8 * 16 * 40
    for name, err, ms, ms3, nb, ops, src, cu, pms in (
        ("intra_luma", err_i, ms_i, ms_i3, b_i, ops_i, "intra_pallas.py:440", "intra.cu",
         plain_i),
        ("deblock_luma", err_d, ms_d, ms_d3, b_d, ops_d, "deblock_pallas.py:211", "deblock.cu",
         plain_d),
    ):
        bms, by = bound(nb, ops)
        res[name + suffix] = dict(
            name=name + suffix, kernel=name, format=fmt_name, route="cuda",
            source=f"h264decode_tpu_torch/csrc/{cu}",
            replaces=f"h264decode_tpu/kernels/{src}", max_abs_err=err, ms=ms,
            three_single_plane_calls_ms=ms3, plain_ms=pms, bound_ms=bms, bound_by=by,
            library_ms=None)
    log(f"4:4:4 (3 planes in one launch): max_abs_err intra {err_i} deblock {err_d}; graph "
        f"ms intra {ms_i} (three single-plane calls {ms_i3}), deblock {ms_d} (three calls "
        f"{ms_d3}); plain (one call over the three planes) intra {plain_i} ms, deblock "
        f"{plain_d} ms; active deblock MBs {n_act} of {n}; samples changed "
        f"by the filter (y, cb, cr) {changed}; {REPLAYS} graph replays of each bit-exact")
    check_exact(res)
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def md5s(planes) -> list[str]:
    return [hashlib.md5(np.ascontiguousarray(np.asarray(p)).tobytes()).hexdigest()
            for p in planes]


def y4m_md5s(path: str, want: dict) -> list[list[str]]:
    """Per-frame, per-plane MD5s of a Y4M file, split by the fixed frame
    size that the stream's geometry, bit depth (2-byte samples above 8) and
    chroma format (full-height chroma for 4:2:2, full-size for 4:4:4) give:
    the 6 bytes "FRAME\\n" can occur inside 16-bit sample data."""
    W, H = want["width"], want["height"]
    bps = 2 if want["bit_depth"] > 8 else 1
    Hc = H if want["chroma"] in ("422", "444") else (H + 1) // 2
    Wc = W if want["chroma"] == "444" else (W + 1) // 2
    sizes = (W * H * bps, Wc * Hc * bps, Wc * Hc * bps)
    with open(path, "rb") as f:
        raw = f.read()
    pos = raw.index(b"\n") + 1
    out = []
    while pos < len(raw):
        if raw[pos : pos + 6] != b"FRAME\n":
            raise RuntimeError(f"{path}: no FRAME header at byte {pos}")
        pos += 6
        out.append([hashlib.md5(raw[pos + sum(sizes[:i]) : pos + sum(sizes[: i + 1])])
                    .hexdigest() for i in range(3)])
        pos += sum(sizes)
    if pos != len(raw):
        raise RuntimeError(f"{path}: {len(raw) - pos} bytes past the last whole frame")
    return out


def decode_timed(dev, bs: bytes, metrics=None):
    """Decode bs through a fresh GpuDecoder; returns (frames, wall seconds,
    the RingSet it used), fenced by torch.cuda.synchronize() after every
    frame's output copy."""
    import torch

    from h264decode_tpu_torch.pipeline.gpu_pipeline import GpuDecoder

    with GpuDecoder(device=dev, metrics=metrics) as dec:
        t0 = time.perf_counter()
        frames = dec.decode_stream(bs)
        for fr in frames:
            fr.sync()
        torch.cuda.synchronize()
        return frames, time.perf_counter() - t0, dec._rings


def busy_seconds(events) -> float:
    """Length of the union of the device intervals (us -> s)."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6


def trace(dev, bs: bytes, name: str, wall_unprofiled: float, kernel_names,
          decode=None) -> dict:
    """One decode under torch.profiler (CPU + CUDA), through GpuDecoder or
    decode() -> (frames, wall seconds): device busy time (the
    union of kernel and memcpy intervals), the idle share against the
    unprofiled wall time of the same stream (profiling slows the host, so
    the profiled wall would inflate it), device activities and host launch
    calls (the CUDA runtime calls that put work on the device, a graph
    launch counting one) per frame, the largest device kernels by time,
    and the device records of each wrapper's kernel (<wrapper>_rows): the
    profiler drops records now and then, so a count is only held to be
    non-zero."""
    import torch

    from h264decode_tpu_torch.tools.perf_probe import LAUNCH_CALLS

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        frames, wall = decode() if decode is not None else decode_timed(dev, bs)[:2]
    events = prof.events()
    dev_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        raise RuntimeError(f"{name}: the profiler recorded no device activity")
    calls = LAUNCH_CALLS | {"cudaGraphLaunch"}
    host_calls = sum(e.device_type == torch.autograd.DeviceType.CPU and e.name in calls
                     for e in events)
    records = {k: sum(f"{k}_rows" in e.name for e in dev_events) for k in kernel_names}
    unseen = [k for k, v in records.items() if v == 0]
    if unseen:
        raise RuntimeError(f"{name}: the trace has no device record of the kernels {unseen} "
                           f"(records {records})")
    by_name: dict[str, list] = {}
    for e in dev_events:
        rec = by_name.setdefault(e.name[:100], [0.0, 0])
        rec[0] += e.time_range.end - e.time_range.start
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    busy = busy_seconds(dev_events)
    return {
        "stream": name, "frames": len(frames), "device_busy_s": busy,
        "wall_s_profiled": wall, "wall_s_unprofiled": wall_unprofiled,
        "device_idle_share": 1.0 - busy / wall_unprofiled,
        "device_idle_share_profiled": 1.0 - busy / wall,
        "device_events_per_frame": len(dev_events) / len(frames),
        "host_launch_calls_per_frame": host_calls / len(frames),
        "kernel_device_records": records,
        "device_ms_by_name": {k: {"ms": v[0] / 1e3, "count": v[1]} for k, v in top},
    }


def eager_memory(dev, bs: bytes, name: str) -> int:
    """The largest device memory one eager frame_step call allocates beyond
    what is allocated before it, over the frames of bs (the frames' inputs
    and rings kept by perf_probe.capture); every eager call's output must
    equal the replayed program's."""
    import torch

    from h264decode_tpu_torch.pipeline import gpu_pipeline as gp
    from h264decode_tpu_torch.tools import perf_probe

    entries = perf_probe.capture(bs, dev)
    peak = 0
    for i, e in enumerate(entries):
        ring_y, ring_c = e["ring_y"].clone(), e["ring_c"].clone()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = gp.frame_step(e["wire"], ring_y, ring_c, e["dyn"], e["mb_h"], e["mb_w"],
                            e["flags"], e["slot"])
        torch.cuda.synchronize(dev)
        peak = max(peak, torch.cuda.max_memory_allocated(dev) - base)
        if not torch.equal(out, e["packed"]):
            raise RuntimeError(f"{name} frame {i}: eager frame_step differs from the replayed "
                               f"frame program")
        del out, ring_y, ring_c
    return peak


def pool_bytes(ps) -> int:
    """Device bytes the caching allocator holds in the graph pools of a
    RingSet or ShardSet (its programs' outputs and scratch)."""
    import torch

    pools = {tuple(p) for p in ps.pools.values()}
    if not pools:  # a set of CPU devices
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id") or ()) in pools)


def main_path(dev, name: str, want: dict, traced: bool = True) -> dict:
    """Decode a committed stream through GpuDecoder (launch counters set to
    0 just before, read just after) and the CLI; every kernel of the
    stream's format must have launched, one device kernel per call, and a
    4:4:4 stream must have launched no chroma kernel. The first decode
    captures the programs the stream's geometry lacks; the checked decode
    must capture none and replay one program per frame."""
    import torch

    from h264decode_tpu_torch.entropy import native
    from h264decode_tpu_torch.kernels import _build
    from h264decode_tpu_torch.utils.metrics import DecodeMetrics

    with open(os.path.join(DATA, name), "rb") as f:
        bs = f.read()

    def peak_of(metrics):  # (decode, device bytes allocated at peak beyond the start)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        res = decode_timed(dev, bs, metrics)
        return res, torch.cuda.max_memory_allocated(dev) - base

    # first-call costs (allocator, tables) and the captures
    cold = DecodeMetrics()
    _, peak_cold = peak_of(cold)
    metrics = DecodeMetrics()
    _build.launches.clear()
    _build.device_kernels.clear()
    native.calls.clear()
    (frames, dt, rings), peak_warm = peak_of(metrics)
    kernel_names = LUMA_KERNELS if want["chroma"] == "444" else ROW_KERNELS
    launches = {k: _build.launches[k] for k in kernel_names}
    kernels = {k: _build.device_kernels[k] for k in kernel_names}
    absent = {k: _build.launches[k] for k in ROW_KERNELS if k not in kernel_names}
    native_slices = native.calls["decode_slice"]
    got = [md5s(fr.planes()) for fr in frames]
    if got != want["frames"]:
        bad = [i for i, (g, w) in enumerate(zip(got, want["frames"])) if g != w]
        raise RuntimeError(f"{name}: frames {bad} differ from libavcodec "
                           f"({len(got)} decoded, {len(want['frames'])} expected)")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"{name}: kernels never launched on the main path: {missing}")
    if any(absent.values()):
        raise RuntimeError(f"{name}: kernels of another format launched: {absent}")
    many = {k: kernels[k] / launches[k] for k in kernel_names if kernels[k] != launches[k]}
    if many:
        raise RuntimeError(f"{name}: persistent kernels launched other than once per call "
                           f"(device kernels per call): {many}")
    if native._lib is None or native_slices == 0:
        raise RuntimeError(f"{name}: the native entropy engine did not decode")
    progs = {"capturing decode": program_figures(cold.counters, cold.timers, len(frames)),
             "checked decode": program_figures(metrics.counters, metrics.timers, len(frames))}
    warm = progs["checked decode"]
    if warm["captures"] or warm["replays"] != len(frames) or \
            warm["keys"] != progs["capturing decode"]["keys"]:
        raise RuntimeError(f"{name}: with the programs captured, a decode of {len(frames)} frames "
                           f"gave {warm} (after {progs['capturing decode']})")
    memory = {"peak_capturing_decode": peak_cold, "peak_replaying_decode": peak_warm,
              "graph_pool": pool_bytes(rings), "eager_frame_step_peak": eager_memory(dev, bs, name)}
    # two more unprofiled decodes; frames/s is taken from the median wall
    walls = [dt] + [decode_timed(dev, bs)[1] for _ in range(2)]
    wall = statistics.median(walls)
    fps = len(frames) / wall
    log(f"{name}: {len(frames)} frames bit-exact vs libavcodec MD5s; walls {walls} s, "
        f"median -> {fps} frames/s (fence: torch.cuda.synchronize); wrapper calls (counted "
        f"at capture, added per replay) {launches}; device kernels they launched {kernels}; "
        f"other kernels' calls {absent}; native entropy slices {native_slices}")
    log(f"{name}: frame programs {json.dumps(progs)}; device memory bytes {json.dumps(memory)}")
    log(f"{name}: stage timers {json.dumps(metrics.summary())}")
    if traced:
        log(f"{name}: trace {json.dumps(trace(dev, bs, name, wall, kernel_names))}")
    # the CLI entry point, as a user would call it
    os.makedirs(OUT, exist_ok=True)
    y4m = os.path.join(OUT, name.replace(".h264", ".y4m"))
    res = subprocess.run(
        [sys.executable, "-m", "h264decode_tpu_torch", "decode", os.path.join(DATA, name),
         y4m, "--metrics"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    if res.returncode != 0:
        raise RuntimeError(f"CLI decode of {name} failed:\n{res.stdout}\n{res.stderr}")
    if y4m_md5s(y4m, want) != want["frames"]:
        raise RuntimeError(f"CLI decode of {name}: frames differ from libavcodec")
    os.remove(y4m)
    log(f"{name}: CLI decode bit-exact ({res.stdout.splitlines()[0]})")
    return dict(launches=launches, kernels=kernels, fps=fps, frames=len(frames),
                programs=progs, memory=memory)


def bench_hard() -> dict:
    """`python -m h264decode_tpu_torch bench` with BENCH_CONTENT=hard on the
    card: the committed hard stream, every frame checked against its MD5s by
    the bench itself; returns its JSON line."""
    env = dict(os.environ, BENCH_CONTENT="hard", BENCH_SIZE="1080p", BENCH_FRAMES="8")
    env.pop("BENCH_MESH", None)
    res = subprocess.run([sys.executable, "-m", "h264decode_tpu_torch", "bench"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"bench (BENCH_CONTENT=hard) failed:\n{res.stdout}\n{res.stderr}")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    rec = json.loads(lines[-1]) if lines else {}
    if len(lines) != 1 or rec.get("metric") != HARD_METRIC:
        raise RuntimeError(f"bench (BENCH_CONTENT=hard): expected one {HARD_METRIC} line, got "
                           f"{res.stdout!r}")
    log(f"bench BENCH_CONTENT=hard: {lines[0]}")
    for line in res.stderr.splitlines():
        if line.startswith("#"):
            log(f"bench BENCH_CONTENT=hard {line}")
    return rec


def serve_phase(name: str, want: dict) -> dict:
    """`python -m h264decode_tpu_torch serve --port 0 --once` on the card,
    fed the committed stream over one TCP connection: its Y4M must match
    the committed MD5s. Returns the wall seconds from connecting to the
    server's exit (the server's startup, before it listens, excluded), and
    the connection's frame-program figures and peak device memory from the
    line the server prints for it."""
    import select
    import socket

    with open(os.path.join(DATA, name), "rb") as f:
        bs = f.read()
    out_dir = os.path.join(OUT, "serve")
    os.makedirs(out_dir, exist_ok=True)
    y4m = os.path.join(out_dir, "stream_0.y4m")
    if os.path.exists(y4m):
        os.remove(y4m)
    # the server's stderr goes to a file, so that however much it writes it
    # never blocks on a full pipe; it is read back on failure
    err_path = os.path.join(out_dir, "serve_stderr.log")

    def err_text() -> str:
        with open(err_path) as f:
            return f.read()

    with open(err_path, "w") as err_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "h264decode_tpu_torch", "serve", "--port", "0", "--once",
             "--out-dir", out_dir],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=err_f, text=True)
    try:
        if not select.select([proc.stdout], [], [], 300)[0]:
            raise RuntimeError(f"serve: no 'listening on' line within 300 s:\n{err_text()}")
        line = proc.stdout.readline()
        if "listening on" not in line:
            raise RuntimeError(f"serve: unexpected first line {line!r}:\n{err_text()}")
        port = int(line.split("listening on ")[1].split(";")[0].rsplit(":", 1)[1])
        t0 = time.perf_counter()
        with socket.create_connection(("127.0.0.1", port)) as conn:
            conn.sendall(bs)
        out = proc.communicate(timeout=600)[0]
        wall = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"serve exited {proc.returncode}:\n{out}\n{err_text()}")
    if y4m_md5s(y4m, want) != want["frames"]:
        raise RuntimeError(f"serve of {name}: frames differ from libavcodec")
    os.remove(y4m)
    conn = [ln for ln in out.splitlines() if ln.startswith("[conn 0]")]
    if len(conn) != 1:
        raise RuntimeError(f"serve: expected one [conn 0] line, got {out!r}")
    stats = json.loads(conn[0].split("; ", 1)[1])
    frames = len(want["frames"])
    progs = program_figures(stats["counters"], stats["timers"], frames)
    if progs["replays"] != frames:
        raise RuntimeError(f"serve of {name}: {progs['replays']} program replays for {frames} "
                           f"frames")
    log(f"serve (port {port}, --once) of {name}: {frames} frames bit-exact vs libavcodec MD5s; "
        f"{wall} s from connect to exit; frame programs {json.dumps(progs)}; peak device "
        f"memory {stats['peak_device_bytes']} bytes ({out.strip()})")
    return {"stream": name, "wall_s": wall, "programs": progs,
            "peak_device_bytes": stats["peak_device_bytes"]}


# ---------------------------------------------------------------------------
# phase 5: the multi-device path (dist/) on one card
# ---------------------------------------------------------------------------


def halo_phase(dev) -> dict:
    """The four kernels with their halo inputs (the row above MB row 0 for
    intra, the 4 rows above it for deblocking, filtered and returned) at the
    geometry of one band of a 1x4 mesh at 1080p (BAND_H x MB_W MBs), 4:2:0
    8-bit, against their plain versions: seeded top and halo rows, bS 0..4
    on MB row 0's top edge. Returns the kernel table's four *_halo rows."""
    import torch

    rng = np.random.default_rng(6)
    W, Wc = 16 * MB_W, 8 * MB_W
    fmt_name = f"4:2:0 8-bit, one band of four ({BAND_H}x{MB_W} MBs) with the rows above"
    t = intra_inputs(dev, seed=4, mb_h=BAND_H)
    top = [torch.as_tensor(rng.integers(0, 256, w).astype(np.int32), device=dev)
           for w in (W, Wc, Wc)]
    res = intra_rows(t, BAND_H, 8, 8, "_halo", fmt_name, top)
    planes, prep = deblock_inputs(dev, seed=5, mb_h=BAND_H, top_edge=True)
    halo = [torch.as_tensor(np.clip(128 + rng.integers(-12, 13, (4, w)), 0, 255)
                            .astype(np.uint8), device=dev) for w in (W, Wc, Wc)]
    res.update(deblock_rows(planes, prep, BAND_H, 8, 8, "_halo", fmt_name, halo))
    check_exact(res)
    return res


@contextlib.contextmanager
def wrapper_entry_calls():
    """Inside, count the wrappers' calls into their kernels' C entries
    (_build.launch), by wrapper name: a replayed graph makes none, so a
    decode that counts launches (added per replay) and no entry calls ran
    its kernels inside graphs."""
    from h264decode_tpu_torch.kernels import _build

    calls: Counter = Counter()
    orig = _build.launch

    def counted(name, *args):
        calls[name] += 1
        return orig(name, *args)

    _build.launch = counted
    try:
        yield calls
    finally:
        _build.launch = orig


def shard_sets() -> dict:
    """Every idle ShardSet (dist/sharded.py's process-wide cache; a closed
    decoder returns its set there) by id: (set, its own counters, timers,
    timer calls, frames run by each of its steps)."""
    from h264decode_tpu_torch.dist import sharded

    return {id(s): (s, Counter(s.metrics.counters), Counter(s.metrics.timers),
                    Counter(s.metrics.timer_calls), {k: st.frames for k, st in s.steps.items()})
            for sets in sharded._idle.values() for s in sets}


def shard_programs(before: dict, after: dict, frames: int) -> dict:
    """The band programs' figures of one decode, from the ShardSets it used
    (their own counts, after against before; a set used dispatched frames):
    the keys whose programs ran, captures, capture seconds, replays,
    dispatch seconds per frame and the bytes of the sets' graph pools."""
    counters, timers, keys, used = Counter(), Counter(), set(), []
    for i, (s, c, t, calls, steps) in after.items():
        _, c0, t0, calls0, steps0 = before.get(i, (None, Counter(), Counter(), Counter(), {}))
        if calls["dispatch"] != calls0["dispatch"]:
            used.append(s)
            counters.update(c - c0)
            timers.update({k: v - t0[k] for k, v in t.items()})
            keys |= {k for k, n in steps.items() if n != steps0.get(k, 0)}
    figs = program_figures(counters, timers, frames)
    figs["keys"] = len(keys)
    figs["sets"] = len(used)
    figs["graph_pool_bytes"] = sum(pool_bytes(s) for s in used)
    return figs


def dist_run(dev, label: str, name: str, shape: tuple, kind: str, mode, want: dict) -> dict:
    """Decode a committed stream through ShardedDecoder or GopParallelDecoder
    on a mesh that repeats `dev`: a decode that captures the band programs,
    then the checked decode (launch counters set to 0 just before, read just
    after): every frame against the committed MD5s, the frames' mode, each
    kernel launched exactly where the eager step launched it (band 0 of a
    halo frame without halo rows, every later band with them as *_halo, an
    aligned frame's bands without), one device kernel per call, all of them
    inside graph replays (no wrapper entered its C entry), no capture and
    every band program of every frame replayed. Prints the programs'
    figures of both decodes (read from the ShardSets' own counts, so the gop
    slots' too). frames/s from the median wall of three decodes, each timed
    to the last frame's host planes. The 1x1 and 1x4 halo runs are traced."""
    from h264decode_tpu_torch.dist.decoder import ShardedDecoder
    from h264decode_tpu_torch.dist.gop import GopParallelDecoder
    from h264decode_tpu_torch.dist.mesh import make_mesh
    from h264decode_tpu_torch.kernels import _build
    from h264decode_tpu_torch.utils.metrics import DecodeMetrics

    G, R = shape
    mesh = make_mesh(G, R, devices=[dev] * (G * R))
    with open(os.path.join(DATA, name), "rb") as f:
        bs = f.read()

    def decode(metrics=None):
        dec = (ShardedDecoder(mesh, metrics=metrics) if kind == "sharded"
               else GopParallelDecoder(mesh))
        t0 = time.perf_counter()
        frames = dec.decode_stream(bs)  # host planes: every frame is done on the card
        wall = time.perf_counter() - t0
        if kind == "sharded":
            dec.close()  # gop slots close their decoders themselves
        return dec, frames, wall

    n = len(want["frames"])
    s0 = shard_sets()
    decode()  # the captures and first-call costs (allocator, tables)
    s1 = shard_sets()
    _build.launches.clear()
    _build.device_kernels.clear()
    metrics = DecodeMetrics()  # a ShardedDecoder's stage timers (gop slots take none)
    with wrapper_entry_calls() as entries:
        dec, frames, wall = decode(metrics)
    names = ROW_KERNELS + HALO_KERNELS
    launches = {k: _build.launches[k] for k in names}
    kernels = {k: _build.device_kernels[k] for k in names}
    progs = {"capturing decode": shard_programs(s0, s1, n),
             "checked decode": shard_programs(s1, shard_sets(), n)}
    got = [md5s(fr.planes()) for fr in frames]
    if got != want["frames"]:
        bad = [i for i, (g, w) in enumerate(zip(got, want["frames"])) if g != w]
        raise RuntimeError(f"{label}: frames {bad} differ from libavcodec "
                           f"({len(got)} decoded, {n} expected)")
    if dict(dec.modes) != {mode: len(frames)}:
        raise RuntimeError(f"{label}: frames took the modes {dict(dec.modes)}, not {mode}")
    halo = mode == "halo"
    expect = {k: n if halo else n * R for k in ROW_KERNELS}
    expect.update({k: n * (R - 1) if halo else 0 for k in HALO_KERNELS})
    if launches != expect or kernels != expect:
        raise RuntimeError(f"{label}: wrapper calls {launches} and device kernels {kernels}; "
                           f"the eager step launched {expect} of each")
    per_frame = 2 * R if halo else R  # band programs a frame
    warm = progs["checked decode"]
    if warm["captures"] or warm["replays"] != per_frame * n or sum(entries.values()):
        raise RuntimeError(f"{label}: with the programs captured, a decode of {n} frames gave "
                           f"{warm} and wrapper entry calls {dict(entries)}")
    walls = [wall] + [decode()[2] for _ in range(2)]
    fps = len(frames) / statistics.median(walls)
    log(f"{label} ({name}): {len(frames)} frames bit-exact vs libavcodec MD5s; walls {walls} s, "
        f"median -> {fps} frames/s; wrapper calls (counted at capture, added per replay) "
        f"{launches}; device kernels {kernels}; wrapper entry calls 0; band programs "
        f"{json.dumps(progs)}")
    if kind == "sharded":
        log(f"{label}: stage timers {json.dumps(metrics.summary())}")
    res = dict(run=label, stream=name, mesh=f"{G}x{R}", frames=len(frames), fps=fps,
               walls_s=walls, launches=launches, programs=progs)
    if label in TRACED_DIST_RUNS:
        with wrapper_entry_calls() as entries:
            rec = trace(dev, bs, label, statistics.median(walls), ROW_KERNELS,
                        decode=lambda: decode()[1:])
        # the kernels' device records came from graph replays alone
        rec["wrapper_entry_calls"] = sum(entries.values())
        if rec["wrapper_entry_calls"] or rec["host_launch_calls_per_frame"] >= 100:
            raise RuntimeError(f"{label}: {rec['host_launch_calls_per_frame']} host launch calls "
                               f"a frame, wrapper entry calls {dict(entries)}")
        log(f"{label}: trace {json.dumps(rec)}")
        res["trace"] = rec
    return res


def dist_phase(dev, want: dict, kernels: dict) -> list:
    """ShardedDecoder (1x1, 1x2 and 1x4 halo, 1x4 aligned) and GopParallelDecoder
    (2x1, 2x2) on meshes that repeat cuda:0, each beside GpuDecoder on the
    same stream (median of three decodes after a warm one), and the CLI's
    sharded backend on a 1x1 mesh of the card. The 1x4 halo run's launches
    fill the *_halo rows of the kernel table."""
    runs = [dist_run(dev, *r, want[r[1]]) for r in DIST_RUNS]
    single = {}
    for name in dict.fromkeys(r["stream"] for r in runs):
        with open(os.path.join(DATA, name), "rb") as f:
            bs = f.read()
        decode_timed(dev, bs)  # first-call costs
        walls = [decode_timed(dev, bs)[1] for _ in range(3)]
        single[name] = len(want[name]["frames"]) / statistics.median(walls)
        log(f"GpuDecoder on {name}: walls {walls} s -> {single[name]} frames/s")
    for r in runs:
        r["gpu_decoder_fps"] = single[r["stream"]]
        r["fps_over_gpu_decoder"] = r["fps"] / single[r["stream"]]
        if r["run"] == HALO_RUN:
            for k in HALO_KERNELS:
                kernels[k]["launches"] = r["launches"][k]
                kernels[k]["launch_stream"] = f"{r['stream']} (ShardedDecoder {r['mesh']})"
                # dist_run held it: counted at capture, added per replay, no
                # wrapper entered its kernel's C entry in the checked decode
                kernels[k]["in_graph"] = True
    # the CLI entry point with the sharded backend: a 1x1 mesh of the card
    name = DIST_RUNS[0][1]
    os.makedirs(OUT, exist_ok=True)
    y4m = os.path.join(OUT, "sharded_" + name.replace(".h264", ".y4m"))
    res = subprocess.run(
        [sys.executable, "-m", "h264decode_tpu_torch", "decode", os.path.join(DATA, name), y4m,
         "--backend", "sharded", "--mesh", "1x1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    if res.returncode != 0:
        raise RuntimeError(f"CLI sharded decode of {name} failed:\n{res.stdout}\n{res.stderr}")
    if y4m_md5s(y4m, want[name]) != want[name]["frames"]:
        raise RuntimeError(f"CLI sharded decode of {name}: frames differ from libavcodec")
    os.remove(y4m)
    log(f"{name}: CLI decode --backend sharded --mesh 1x1 bit-exact "
        f"({res.stdout.splitlines()[0]})")
    return runs


# ---------------------------------------------------------------------------
# phase 6: stage attribution of the frame program
# ---------------------------------------------------------------------------


def probe_launches(name: str, rec: dict, cat: int) -> dict:
    """Hold the probe's per-prefix wrapper counters (zeroed before each
    eager call): `recon` of a frame with intra MBs launched the format's
    intra kernels and `deblock` of a deblocked frame its deblocking kernels,
    each once and as one device kernel; no prefix launched a kernel of
    another format. Returns {prefix: frames checked}."""
    intra = ("intra_luma",) if cat == 3 else ("intra_luma", "intra_chroma")
    deblock = ("deblock_luma",) if cat == 3 else ("deblock_luma", "deblock_chroma")
    checked = {"recon": 0, "deblock": 0}
    for row in rec["rows"]:
        in_recon = intra if row["has_intra"] else ()
        in_deblock = in_recon + (deblock if row["deblocked"] else ())
        for p, want in (("recon", in_recon), ("deblock", in_deblock)):
            got = row["prefixes"][p]
            expect = {k: 1 for k in want}
            if got["launches"] != expect or got["device_kernels"] != expect:
                raise RuntimeError(
                    f"{name} frame {row['frame']} prefix {p}: wrapper calls "
                    f"{got['launches']}, device kernels {got['device_kernels']}; "
                    f"expected {expect} for each")
            checked[p] += bool(want)
    if not checked["recon"] or not checked["deblock"]:
        raise RuntimeError(f"{name}: no frame ran the intra or deblocking kernels: {checked}")
    return checked


def probe_phase(dev) -> list:
    """The stage-attribution probe on PROBE_STREAMS (each prefix of every
    frame captured in a CUDA graph and replayed PROBE_REPLAYS times; `full`
    bit-exact, eager and replayed, or the probe raises); the wrappers'
    counters held per prefix. Writes each stream's JSON record to
    chiprun_out/probe_<stream>.json and returns the per-frame stage sums."""
    import torch

    from h264decode_tpu_torch.tools import perf_probe
    from h264decode_tpu_torch.utils.metrics import DecodeMetrics

    out = []
    for name in PROBE_STREAMS:
        t0 = time.time()
        with open(os.path.join(DATA, name), "rb") as f:
            bs = f.read()
        metrics = DecodeMetrics()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        rec = perf_probe.probe_stream(bs, name, dev, replays=PROBE_REPLAYS, metrics=metrics)
        peak = torch.cuda.max_memory_allocated(dev) - base
        progs = program_figures(metrics.counters, metrics.timers, rec["frames"])
        checked = probe_launches(name, rec, rec["format"]["cat"])
        with open(os.path.join(OUT, "probe_" + name.replace(".h264", ".json")), "w") as f:
            json.dump(rec, f)
        log(perf_probe.table(rec))
        log(f"{name}: probe {time.time() - t0:.1f} s; every full replay bit-exact (eager and "
            f"graph); every prefix captured; wrapper launches held in {checked} frames; the "
            f"capturing decode's frame programs {json.dumps(progs)}; peak device memory "
            f"{peak} bytes (ring snapshots included)")
        out.append({"stream": name, "frames": rec["frames"], "seconds": rec["seconds"],
                    "ring_snapshot_bytes": rec["ring_snapshot_bytes"], "sums": rec["sums"],
                    "programs": progs, "peak_device_bytes": peak})
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="smoke test of the port on one GPU")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)} (default: all)")
    phases = ap.parse_args(argv).phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from h264decode_tpu_torch.entropy import native
    from h264decode_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
        f"phases {phases}")
    t0 = time.time()
    secs, logs = _build.build_all()
    t1 = time.time()
    native._load()
    log(f"build: CUDA kernels {secs:.1f} s ({', '.join(_build.sources())}), native "
        f"entropy engine {time.time() - t1:.1f} s")
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "chip_smoke_build.log"), "w") as f:
        for k, v in logs.items():
            f.write(f"== {k}\n{v}\n")
    for k, v in logs.items():
        for line in v.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {k}: {line.strip()}")
    with open(os.path.join(DATA, "smoke_md5.json")) as f:
        want = json.load(f)

    kernels, base, table = {}, {}, {}
    if "kernels" in phases:
        for cat, bd in FORMATS:
            if cat == 3:  # takes the 4:2:0 8-bit phase's luma inputs
                kernels.update(planes_phase(dev, base[(1, 8)]))
            else:
                rows, base[(cat, bd)] = kernel_phase(dev, cat, bd)
                kernels.update(rows)
        log(f"kernel phases done at {time.time() - t0:.1f} s")
    if "main" in phases:
        # the cores the pictures' entropy tasks and slice calls share
        cores = {"cpu_count": os.cpu_count(), "sched_getaffinity": len(os.sched_getaffinity(0))}
        log(f"host cores: os.cpu_count() {cores['cpu_count']}, "
            f"len(os.sched_getaffinity(0)) {cores['sched_getaffinity']}")
        table["host_cores"] = cores
        paths = {}
        for name, suffix, traced in STREAMS:
            mp = paths[name] = main_path(dev, name, want[name], traced)
            if suffix is None or not kernels:
                continue
            # the launches of the format's main-path stream fill its rows
            for k in mp["launches"]:
                row = kernels[k + suffix]
                row["launches"] = mp["launches"][k]
                row["launch_stream"] = name
                row["inner_launches_per_call"] = mp["kernels"][k] / mp["launches"][k]
        table["main_path"] = [{"stream": k, "frames_per_s": v["fps"], "frames": v["frames"],
                               "programs": v["programs"], "memory_bytes": v["memory"]}
                              for k, v in paths.items()]
        table["bench_hard"] = bench_hard()
        log(f"main path done at {time.time() - t0:.1f} s")
    if "serve" in phases:
        table["serve"] = serve_phase(SERVE_STREAM, want[SERVE_STREAM])
    if "dist" in phases:
        t_dist = time.time()
        kernels.update(halo_phase(dev))
        table["dist"] = dist_phase(dev, want, kernels)
        log(f"dist phase {time.time() - t_dist:.1f} s")
    if "probe" in phases:
        t_probe = time.time()
        table["probe"] = probe_phase(dev)
        log(f"probe phase {time.time() - t_probe:.1f} s")
    log(f"setup+run {time.time() - t0:.1f} s")
    log(json.dumps({"kernels": list(kernels.values()), **table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
