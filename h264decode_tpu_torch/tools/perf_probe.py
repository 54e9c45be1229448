"""Stage attribution of the frame program, frame by frame.

    python -m h264decode_tpu_torch.tools.perf_probe [--stream NAME ...]
        [--frames N] [--device cuda|cpu] [--replays N]

Counterpart of the JAX package's tools/perf_probe.py. It decodes a stream
with GpuDecoder while a wrapper around the decoder's per-frame entry
(pipeline/frame_program.RingSet.dispatch, which replays the frame's
captured program on the card) keeps, for every frame, the call's inputs
(the wire, the per-(SPS, PPS) tables, geometry, flags, ring slot), copies
of the DPB rings taken before the call and the packed frame it returned.
Each frame is then replayed on its own references through nested
prefixes of frame_step, each made of the functions frame_step itself
runs:

  prep          _prepare_inp: the wire unpacked and widened
  residual      + the residual transforms (_residual_planes, or
                  _residual_planes_444 for 4:4:4)
  base          + MC, weights and PCM (_frame_core / _frame_core_444 with
                  has_intra=False)
  recon         + the intra kernels (the frame's own has_intra)
  deblock_prep  + bS and thresholds (_deblock_prep)
  deblock       + the deblocking kernels (_deblock_core / _deblock_core_444)
  full          frame_step itself: + the half-pel ring update and the pack

A frame without deblocking runs deblock_prep and deblock as recon. The
stages are the differences of consecutive prefixes: unpack, transform,
mc_weights_pcm, intra, deblock_prep, deblock_kernels, ring_pack.

For every prefix and frame it reports
  host_ms    perf_counter around an eager call, before the fence: the time
             the host takes to enqueue the prefix; the least of --replays
             calls (on the card after a warm one), the garbage collector off,
             as timeit takes it (interference only adds);
  device_ms  CUDA events around one replay of a CUDA graph of the prefix,
             median of --replays (the graph holds the launches of one call,
             so they run back to back and the host's pace does not enter);
  kernels    the device activities (kernels, memsets, copies) of one eager
             call, as the main path's trace counts them: its CUDA runtime
             launch calls in torch.profiler's record of the call (each row
             also says how many device activities the profiler recorded
             for the frame's calls); on the CPU, the torch operators the
             call dispatches;
  launches   the CUDA wrappers' calls and device kernels in the last eager
             call (kernels/_build.launches and device_kernels, zeroed before
             it).
Every replay of `full`, eager and graph, must equal the decoder's packed
frame bit for bit, or the probe raises. On a CUDA device a prefix that a
CUDA graph cannot capture raises, naming the frame and prefix. On the CPU
(--device cpu) no graph exists: device_ms is null and the line says so.

Output: one JSON line per stream on stdout (per-frame rows, stage sums over
I frames and over inter frames) and a readable stage table on stderr.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import convert
from ..kernels import _build
from ..pipeline import frame_program
from ..pipeline import gpu_pipeline as gp

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
PREFIXES = ("prep", "residual", "base", "recon", "deblock_prep", "deblock", "full")
# stage -> (prefix before it or None, its prefix)
STAGES = {
    "unpack": (None, "prep"),
    "transform": ("prep", "residual"),
    "mc_weights_pcm": ("residual", "base"),
    "intra": ("base", "recon"),
    "deblock_prep": ("recon", "deblock_prep"),
    "deblock_kernels": ("deblock_prep", "deblock"),
    "ring_pack": ("deblock", "full"),
}
METRICS = ("host_ms", "device_ms", "kernels")


def capture(bs: bytes, device, max_frames: int | None = None,
            metrics=None) -> list[dict]:
    """Decode bs with GpuDecoder on `device` (metrics: its DecodeMetrics or
    None), keeping the inputs, the rings before the call and the packed
    output of the first max_frames frames that reach the frame program (all
    when None), in decode order. Pictures that decode on the host oracle do
    not reach it and have no entry."""
    entries: list[dict] = []
    orig = frame_program.RingSet.dispatch

    def spy(rs, step, key, wire, dyn, mb_h, mb_w, flags, slot, m=None):
        if max_frames is not None and len(entries) >= max_frames:
            return orig(rs, step, key, wire, dyn, mb_h, mb_w, flags, slot, m)
        e = dict(wire=convert.wire_from_numpy(wire, {}, rs.device)[0], dyn=dict(dyn),
                 mb_h=mb_h, mb_w=mb_w, flags=tuple(flags), slot=slot,
                 ring_y=rs.ring_y.clone(), ring_c=rs.ring_c.clone())
        out = orig(rs, step, key, wire, dyn, mb_h, mb_w, flags, slot, m)
        e["packed"] = out.clone()  # a replay's output is rewritten by the next
        entries.append(e)
        return out

    frame_program.RingSet.dispatch = spy  # looked up at every frame
    try:
        with gp.GpuDecoder(device=device, metrics=metrics) as dec:
            for fr in dec.decode_stream(bs):
                fr.sync()
    finally:
        frame_program.RingSet.dispatch = orig
    return entries


def run_prefix(name: str, e: dict, ring_y: torch.Tensor, ring_c: torch.Tensor):
    """Prefix `name` of frame_step on captured entry e, reading (and, for
    `full`, updating) the rings given."""
    wire, dyn, mb_h, mb_w, flags = e["wire"], e["dyn"], e["mb_h"], e["mb_w"], e["flags"]
    has_l8, has_pcm, apply_db, _, has_intra, need_s2, cat, bd = flags
    if name == "full":
        return gp.frame_step(wire, ring_y, ring_c, dyn, mb_h, mb_w, flags, e["slot"])
    inp = gp._prepare_inp(wire, dyn, ring_y, ring_c, mb_h, mb_w, flags)
    if name == "prep":
        return inp
    if name == "residual":
        if cat == 3:
            return gp._residual_planes_444(inp, mb_h, mb_w, has_l8)
        return gp._residual_planes(inp, mb_h, mb_w, has_l8, cat, bd)
    intra = has_intra and name != "base"
    if cat == 3:
        planes = gp._frame_core_444(inp, mb_h, mb_w, has_l8, has_pcm, intra, need_s2)
    else:
        planes = gp._frame_core(inp, mb_h, mb_w, has_l8, has_pcm, intra, need_s2, cat, bd)
    if name in ("base", "recon") or not apply_db:
        return planes
    if name == "deblock_prep":
        return planes, gp._deblock_prep(inp, mb_h, mb_w, cat)
    if cat == 3:
        return gp._deblock_core_444(planes, inp, mb_h, mb_w)
    return gp._deblock_core(planes, inp, mb_h, mb_w, cat, bd)


def _fence(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _graph_ms(fn, reset, replays: int, what: str) -> tuple[float, object]:
    """(median ms of one replay of a CUDA graph of fn(), between CUDA events,
    over `replays` replays after a warm one; the graph's output). reset()
    (not timed) restores the rings before the capture and every replay."""
    g = torch.cuda.CUDAGraph()
    reset()
    torch.cuda.synchronize()
    try:
        with torch.cuda.graph(g):
            out = fn()
    except Exception as exc:
        raise RuntimeError(f"{what}: a CUDA graph cannot capture this prefix (a host "
                           f"synchronisation inside it?): {exc}") from exc
    times = []
    for i in range(replays + 1):
        reset()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        if i:
            times.append(a.elapsed_time(b))
    return statistics.median(times), (g, out)


def _check_full(out: torch.Tensor, want: torch.Tensor, what: str):
    if out.shape != want.shape or not torch.equal(out, want):
        raise RuntimeError(f"{what}: the replay differs from the decoder's packed frame")


# the CUDA runtime calls that put one activity on the device each
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy", "cudaMemset", "cudaMemcpy2DAsync",
))


def _device_activities(prof, labels: list[str]) -> tuple[dict, int, int]:
    """(label -> the device activities launched inside the record_function
    range of that label, launch calls in the session, device activities the
    profiler recorded in it). The launches are counted by their CUDA runtime
    calls on the host's clock: the device's timestamps, converted to that
    clock, drift by more than the gap between two calls, and the profiler
    drops device records now and then; the runtime calls are exact."""
    evs = prof.profiler.kineto_results.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges = {e.name(): (e.start_ns(), e.end_ns()) for e in evs
              if e.device_type() == cpu and e.name() in labels}
    calls = np.sort(np.array([e.start_ns() for e in evs
                              if e.device_type() == cpu and e.name() in LAUNCH_CALLS], np.int64))
    seen = sum(e.device_type() == cuda and not e.name().startswith("probe/") for e in evs)
    counts = {label: int(np.searchsorted(calls, ranges[label][1], side="right")
                         - np.searchsorted(calls, ranges[label][0]))
              for label in labels}
    return counts, len(calls), seen


class _OpCount(TorchDispatchMode):
    """Counts the torch operators dispatched to a backend (the kernels of
    a CPU call; nested calls inside an operator are not seen)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _rings(e: dict):
    """Fresh rings holding frame e's references, and reset(), which restores
    them (a `full` call updates its ring slot in place)."""
    ring_y, ring_c = e["ring_y"].clone(), e["ring_c"].clone()

    def reset():
        ring_y.copy_(e["ring_y"])
        ring_c.copy_(e["ring_c"])

    return ring_y, ring_c, reset


def _kernel_counts(entries: list[dict], device: torch.device) -> tuple[dict, list]:
    """((frame, prefix) -> the kernels of one more eager call of each; per
    frame on the card, (launch calls, device activities recorded) of its
    profiler session). On the card a profiler session per frame, each call
    in a range of its own; on the CPU each call under an operator count."""
    counts, sessions = {}, []
    for i, e in enumerate(entries):
        ring_y, ring_c, reset = _rings(e)
        if device.type != "cuda":
            for p in PREFIXES:
                reset()
                with _OpCount() as ops:
                    run_prefix(p, e, ring_y, ring_c)
                counts[(i, p)] = ops.n
            continue
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for p in PREFIXES:
                reset()
                _fence(device)
                with torch.profiler.record_function(f"probe/{p}"):
                    run_prefix(p, e, ring_y, ring_c)
                    _fence(device)
        by_label, calls, seen = _device_activities(prof, [f"probe/{p}" for p in PREFIXES])
        sessions.append((calls, seen))
        for label, n in by_label.items():
            counts[(i, label.split("/")[1])] = n
    return counts, sessions


def probe_entries(entries: list[dict], device, replays: int = 5, what: str = "") -> list[dict]:
    """Replay every captured frame through every prefix; returns one row a
    frame: {frame, intra_only, has_intra, deblocked, prefixes: {name: {host_ms,
    device_ms, kernels, launches, device_kernels}}}."""
    device = torch.device(device)
    rows = []
    for i, e in enumerate(entries):
        ring_y, ring_c, reset = _rings(e)
        flags = e["flags"]
        row = dict(frame=i, intra_only=bool((((e["wire"]["flags8"] >> 2) & 1) == 1).all()),
                   has_intra=bool(flags[4]), deblocked=bool(flags[2]), prefixes={})
        for p in PREFIXES:
            tag = f"{what} frame {i} prefix {p}"

            def fn(p=p, e=e):
                return run_prefix(p, e, ring_y, ring_c)

            # on the card a warm call first: a graph capture empties the
            # allocator's cache, and the next call would time its cudaMallocs
            warm = int(device.type == "cuda")
            times = []
            for _ in range(replays + warm):
                reset()
                _fence(device)
                _build.launches.clear()
                _build.device_kernels.clear()
                gc.disable()  # as timeit: no collection inside the timed call
                try:
                    t0 = time.perf_counter()
                    out = fn()
                    times.append((time.perf_counter() - t0) * 1e3)
                finally:
                    gc.enable()
                _fence(device)
                if p == "full":
                    _check_full(out, e["packed"], tag + " (eager)")
                del out
            rec = dict(host_ms=min(times[warm:]), device_ms=None, kernels=None,
                       launches=dict(_build.launches), device_kernels=dict(_build.device_kernels))
            if device.type == "cuda":
                rec["device_ms"], (g, out) = _graph_ms(fn, reset, replays, tag)
                if p == "full":
                    _check_full(out, e["packed"], tag + " (graph replay)")
                del g, out
            row["prefixes"][p] = rec
        rows.append(row)
    counts, sessions = _kernel_counts(entries, device)
    for (i, p), n in counts.items():
        rows[i]["prefixes"][p]["kernels"] = n
    for row, (calls, seen) in zip(rows, sessions):
        row["profiler"] = {"launch_calls": calls, "device_activities_recorded": seen}
    for row in rows:  # each prefix runs what the one before it runs, and more
        counts = [row["prefixes"][p]["kernels"] for p in PREFIXES]
        row["kernels_nested"] = counts == sorted(counts)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def stage_sums(rows: list[dict]) -> dict:
    """{"I": ..., "inter": ...} -> frames and, per stage (and per prefix
    under "prefix:<name>"), each metric summed over those frames (device_ms
    None on the CPU)."""
    out = {}
    for group, pick in (("I", True), ("inter", False)):
        sel = [r for r in rows if r["intra_only"] == pick]
        res = {"frames": len(sel)}

        def total(get):
            vals = [get(r) for r in sel]
            return None if any(v is None for v in vals) else float(sum(vals))

        for m in METRICS:
            for s, (a, b) in STAGES.items():
                res.setdefault(s, {})[m] = total(
                    lambda r, a=a, b=b, m=m: None if r["prefixes"][b][m] is None else
                    r["prefixes"][b][m] - (0 if a is None else r["prefixes"][a][m]))
            for p in PREFIXES:
                res.setdefault("prefix:" + p, {})[m] = total(lambda r, p=p, m=m:
                                                             r["prefixes"][p][m])
        out[group] = res
    return out


def probe_stream(bs: bytes, name: str, device="cuda", max_frames: int | None = None,
                 replays: int = 5, metrics=None) -> dict:
    """Capture, replay and attribute one stream (metrics: the capturing
    decoder's DecodeMetrics or None); returns the JSON record."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    entries = capture(bs, device, max_frames, metrics)
    if not entries:
        raise RuntimeError(f"{name}: no frame reached the frame program")
    snap = sum(e["ring_y"].nbytes + e["ring_c"].nbytes for e in entries)
    rows = probe_entries(entries, device, replays, name)
    return {
        "stream": name, "device": str(device), "frames": len(rows),
        "geometry_mbs": [entries[0]["mb_h"], entries[0]["mb_w"]],
        "format": {"cat": entries[0]["flags"][6], "bd": entries[0]["flags"][7]},
        "ring_snapshot_bytes": snap, "replays": replays,
        "device_ms": ("CUDA-graph replay, median" if device.type == "cuda" else
                      "not measured on the CPU: no CUDA graph; host_ms and kernels only"),
        "kernels": ("device activities (kernels, memsets, copies)" if device.type == "cuda"
                    else "torch operators dispatched (the CPU has no device kernels)"),
        "rows": rows, "sums": stage_sums(rows), "seconds": time.perf_counter() - t0,
    }


def table(rec: dict) -> str:
    """The stage table of one record: per frame, host ms, device ms and
    kernels, over I frames and over inter frames."""
    lines = [f"{rec['stream']} on {rec['device']}: {rec['frames']} frames, "
             f"ring snapshots {rec['ring_snapshot_bytes'] / 1e6:.1f} MB, "
             f"{rec['seconds']:.1f} s"]
    head = f"  {'stage':17s}"
    for g in ("I", "inter"):
        head += f" | {g + ' host ms':>13s} {'device ms':>10s} {'kernels':>8s}"
    lines.append(head)
    for key in [*STAGES, "prefix:full"]:
        line = f"  {key:17s}"
        for g in ("I", "inter"):
            s = rec["sums"][g]
            n = max(s["frames"], 1)
            v = s[key]
            dev = "-" if v["device_ms"] is None else f"{v['device_ms'] / n:.4f}"
            line += f" | {v['host_ms'] / n:13.4f} {dev:>10s} {v['kernels'] / n:8.1f}"
        lines.append(line)
    lines.append("  (per frame; I frames: " + str(rec["sums"]["I"]["frames"]) + ", inter: "
                 + str(rec["sums"]["inter"]["frames"]) + ")")
    bad = [r["frame"] for r in rec["rows"] if not r["kernels_nested"]]
    if bad:
        lines.append(f"  kernels of frames {bad} fall from one prefix to the next: "
                     "the counts of those frames are not exact")
    short = {r["frame"]: r["profiler"] for r in rec["rows"]
             if "profiler" in r and r["profiler"]["launch_calls"]
             != r["profiler"]["device_activities_recorded"]}
    if short:
        lines.append(f"  the profiler's device record differs from the launch calls in "
                     f"frames {short} (the kernels column counts the calls)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="stage attribution of the frame program")
    ap.add_argument("--stream", action="append",
                    help="a committed stream of h264decode_tpu_torch/data/ or a path "
                         "(repeatable; default smoke_1080p_main_cabac.h264)")
    ap.add_argument("--frames", type=int, default=None, help="frames to probe (default all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--replays", type=int, default=5,
                    help="timed eager calls and graph replays of each prefix (default 5)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("perf_probe: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    for s in args.stream or ["smoke_1080p_main_cabac.h264"]:
        path = s if os.path.exists(s) else os.path.join(DATA, s)
        with open(path, "rb") as f:
            bs = f.read()
        rec = probe_stream(bs, os.path.basename(path), args.device, args.frames, args.replays)
        print(table(rec), file=sys.stderr)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
