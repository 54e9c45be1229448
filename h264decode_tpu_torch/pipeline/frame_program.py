"""frame_step as one device program per stream geometry.

Counterpart of the JAX package's `jax.jit` of frame_step
(h264decode_tpu/pipeline/tpu_pipeline.py:626, static mb_h, mb_w, n_refs and
flags) and of its compilation cache. JAX traces frame_step again when a
static argument, or the shape or dtype of a wire array, changes;
`signature` is that cache key here. On a CUDA device the program of a key
is frame_step captured once in a torch.cuda.CUDAGraph and replayed for
every later frame of that key: one graph launch where an eager call issues
about 1300 from Python. The ring slot travels as data (a 0-d int64 tensor
written before the replay), as JAX reads wire["slot_idx"], so one program
serves every slot.

A graph bakes in the address of everything it reads and writes: the DPB
rings, the scaling-list tables (`dyn`), its static wire buffer, slot and
output. So the rings and their programs live together in a RingSet, one
per (device, ring geometry) in use. A decoder checks one out when it meets
a stream geometry and returns it when it closes; the module keeps at most
one idle RingSet per (device, ring geometry), so that a later decoder of a
seen geometry replays without capturing, as a JAX process compiles once
per stream geometry.

On the CPU the same objects run frame_step eagerly on their static
buffers, with no graph.

The mechanism is not frame_step's own: a Program captures and replays any
callable, and a ProgramSet holds the pools, capture streams and failure of
programs that share static buffers. The row-band sharded step's band
programs (dist/sharded.py) are Programs in a ProgramSet of their own.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import traceback
from collections import deque

import numpy as np
import torch

from .. import convert
from ..kernels import _build
from ..utils.metrics import DecodeMetrics


def signature(wire: dict, dyn: dict, mb_h: int, mb_w: int, flags: tuple) -> tuple:
    """The cache key of a frame program: what makes JAX trace frame_step
    again. The static arguments (mb_h, mb_w, flags); for every wire array,
    in order, its key, shape and dtype (the wire's layout, which also says
    whether the frame is weighted, how many slices its weight tables hold
    and how wide their reference lists are); the identity of the
    per-(SPS, PPS) tables in `dyn`, whose addresses a graph keeps; and
    dyn["qp_offsets"], Python ints that frame_step computes with. The ring
    geometry (JAX's static n_refs) is the RingSet's own."""
    return ((mb_h, mb_w), tuple(flags),
            tuple((k, tuple(v.shape), str(v.dtype)) for k, v in wire.items()),
            tuple((k, id(v)) for k, v in dyn.items() if torch.is_tensor(v)),
            tuple(dyn["qp_offsets"]))


def _refused_call(exc: BaseException) -> str:
    """Where a capture failed: the innermost frame of exc's traceback outside
    torch's own files (the call into the operator that refused), as
    file:line (source line)."""
    torch_dir = os.path.dirname(torch.__file__)
    ours = [f for f in traceback.extract_tb(exc.__traceback__)
            if not f.filename.startswith(torch_dir)]
    if not ours:
        return "a call inside torch"
    f = ours[-1]
    return f"{os.path.basename(f.filename)}:{f.lineno} ({f.line})"


# captures run one at a time in the process: each begins with a device-wide
# synchronize, which should not meet another thread's capture in progress;
# they are rare (once per key and set)
_capture_lock = threading.Lock()


class Program:
    """One captured callable: on a CUDA device its graph, its static output
    and the wrapper launches its capture recorded; on the CPU none of these
    (run calls the callable). `what` names the program in errors."""

    what = "program"

    def __init__(self, key: tuple, what: str | None = None):
        self.key = key
        if what is not None:
            self.what = what
        self.graph = None
        self.out = None
        self.counts = None

    def capture(self, fn, pool, side) -> None:
        """One eager warm call of fn() on the side stream (it builds and
        loads the kernels and copies the constant tables to the device,
        which a capture may not do), then the capture of fn() on it into the
        pool. A capture that fails raises, naming the key and the call that
        the capture refused."""
        device = side.device
        cur = torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()
        cur.wait_stream(side)
        g = torch.cuda.CUDAGraph()
        failure = out = None
        # thread_local: other threads (a _PackedFrame waiting on its event,
        # another decoder's worker, serve's handlers, gop slots) keep using
        # the card while this one captures
        with _capture_lock, torch.cuda.stream(side), _build.counted_apart() as counts:
            torch.cuda.synchronize(device)
            g.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            except Exception as exc:  # the capture is invalid: end it, then raise
                failure = exc
            try:
                g.capture_end()
            except RuntimeError as exc:
                failure = failure or exc
        cur.wait_stream(side)
        if failure is not None:
            raise RuntimeError(f"{self.what} {self.key}: the CUDA graph capture failed at "
                               f"{_refused_call(failure)}: {failure}") from failure
        self.graph, self.out, self.counts = g, out, counts

    def run(self, fn):
        """fn()'s output: the graph replayed (the static output, rewritten
        by the next replay), or on the CPU fn() called (new tensors)."""
        if self.graph is None:
            return fn()
        self.graph.replay()
        # the wrappers' launches ran once more: counted at capture, added
        # per replay
        _build.add_counts(*self.counts)
        return self.out


class FrameProgram(Program):
    """frame_step for one signature: a static wire buffer (the typed views
    of its arrays make the program's wire) and a static slot."""

    what = "frame program"

    def __init__(self, key: tuple, layout: list, nbytes: int, dyn: dict, device):
        super().__init__(key)
        # held: the signature names these tables by identity, so no other
        # table may take their id while the program lives
        self.dyn = dyn
        self.wire_buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.wire = convert.unpack_wire(self.wire_buf, layout)
        self.slot = torch.zeros((), dtype=torch.int64, device=device)

    def load(self, host: torch.Tensor, slot: int) -> None:
        """Copy a packed wire (pinned on a CUDA device) into the static
        buffer and write the slot, both on the current stream."""
        self.wire_buf.copy_(host, non_blocking=True)
        self.slot.fill_(slot)

    def call(self, step, ring_y, ring_c, mb_h, mb_w, flags):
        """frame_step on the static buffers, as a callable of no argument
        (the warm call, the capture and, on the CPU, every frame). The
        warm call writes the frame's ring slot as the replays do."""
        return lambda: step(self.wire, ring_y, ring_c, self.dyn, mb_h, mb_w, flags, self.slot)


def _timer(metrics, name: str):
    return contextlib.nullcontext() if metrics is None else metrics.timer(name)


class ProgramSet:
    """Programs captured against static buffers of their own, on `devices`
    (one or more torch.devices): a graph pool and a capture stream per
    distinct CUDA device, and the failure of a capture. One decoder uses a
    set at a time (checkout / checkin). `metrics` counts the set's own
    captures and replays and times them, whichever decoder ran them."""

    def __init__(self, devices):
        # every program of the set on a device captures into one pool: they
        # replay one after another on one stream, and each holds its static
        # inputs and outputs for its life, so a replay writes no memory that
        # a live tensor of another program holds; all else it writes is
        # scratch, written before it is read. One capture stream, because
        # the allocator reuses a freed block only on the stream it was used on
        cuda = list(dict.fromkeys(d for d in devices if d.type == "cuda"))
        self.pools = {d: torch.cuda.graph_pool_handle() for d in cuda}
        self.streams = {d: torch.cuda.Stream(d) for d in cuda}
        self.metrics = DecodeMetrics()
        # the error of a failed capture: the allocator is left recording
        # into the pool, so the set captures no more and is not reused
        self.failure = None

    def check(self) -> None:
        """Raise the failure of an earlier capture, if any."""
        if self.failure is not None:
            raise RuntimeError(f"an earlier capture of this decoder's programs failed: "
                               f"{self.failure}") from self.failure

    def capture(self, prog: Program, fn, device: torch.device, metrics=None) -> None:
        """Capture prog from fn on device into the set's pool and stream
        there; a failure is recorded, then raised. Counts `graph_captures`
        and times `graph_capture` (the warm call and the capture)."""
        t0 = time.time()
        try:
            prog.capture(fn, self.pools[device], self.streams[device])
        except RuntimeError as exc:
            self.failure = exc
            raise
        self.add_time("graph_capture", time.time() - t0, metrics)
        self.count("graph_captures", metrics)

    def add_time(self, name: str, seconds: float, metrics=None) -> None:
        self.metrics.add_time(name, seconds)
        if metrics is not None:
            metrics.add_time(name, seconds)

    def count(self, name: str, metrics=None, n: int = 1) -> None:
        self.metrics.count(name, n)
        if metrics is not None:
            metrics.count(name, n)


class RingSet(ProgramSet):
    """The DPB rings of one (device, ring geometry) and the frame programs
    captured against them. geom = (luma ring shape, chroma ring shape,
    sample dtype), as GpuDecoder._ring_geom_of gives it."""

    def __init__(self, device: torch.device, geom: tuple):
        super().__init__([device])
        luma, chroma, dt = geom
        self.device = device
        self.geom = geom
        # no reset at checkout: a decoder writes every reference picture
        # into its slot before a frame reads it (frame_step or
        # GpuDecoder._insert_host_refs), and the slots no reference names
        # (-1) are masked out of the prediction
        self.ring_y = torch.zeros(luma, dtype=dt, device=device)
        self.ring_c = torch.zeros(chroma, dtype=dt, device=device)
        self.programs: dict[tuple, FrameProgram] = {}
        self._tables: dict[tuple, dict] = {}
        self._staging: deque = deque()  # (copy-done event, pinned buffer)

    def tables(self, tabs: dict) -> dict:
        """The device copies of a set of per-(SPS, PPS) scaling-list tables
        (numpy), one per content: equal tables of any decoder of this set
        are the same tensors, so their frames' signatures agree."""
        key = tuple((k, v.dtype.str, v.shape, v.tobytes())
                    for k, v in ((k, np.asarray(v)) for k, v in tabs.items()))
        hit = self._tables.get(key)
        if hit is None:
            hit = self._tables[key] = convert.dyn_to_torch(tabs, self.device)
        return hit

    def _stage(self, wire: dict) -> tuple[torch.Tensor, list]:
        """The wire packed into one host buffer (pinned on a CUDA device)."""
        total, layout = convert.wire_layout(wire)
        cuda = self.device.type == "cuda"
        if cuda:
            while self._staging and self._staging[0][0].query():
                self._staging.popleft()
        host = torch.empty(max(total, 8), dtype=torch.uint8, pin_memory=cuda)
        convert.pack_wire(wire, host.numpy())
        return host, layout

    def dispatch(self, step, key: tuple, wire: dict, dyn: dict, mb_h: int, mb_w: int,
                 flags: tuple, slot: int, metrics=None) -> torch.Tensor:
        """Run frame `wire` (numpy arrays) through the program of `key`
        (signature(wire, dyn, mb_h, mb_w, flags)), capturing it first if
        this set has none; step is frame_step. Returns the packed output on
        the device. On a CUDA device the upload, the slot write, the replay
        and the caller's device-to-host copy of the output all run on the
        current stream: stream order alone keeps a later frame's upload or
        replay from overwriting a buffer that an earlier copy still reads.
        metrics: `graph_captures`, `graph_replays`, the `graph_capture`
        timer (the warm call and the capture) and the `dispatch` timer (the
        upload, slot write and replay, or the eager call on the CPU)."""
        self.check()
        host, layout = self._stage(wire)
        prog = self.programs.get(key)
        new = prog is None
        if new:
            prog = FrameProgram(key, layout, host.numel(), dyn, self.device)
        fn = prog.call(step, self.ring_y, self.ring_c, mb_h, mb_w, flags)
        if new:
            if self.device.type == "cuda":
                prog.load(host, slot)
                self.capture(prog, fn, self.device, metrics)
            self.programs[key] = prog
        with _timer(metrics, "dispatch"):
            prog.load(host, slot)
            out = prog.run(fn)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._staging.append((ev, host))  # kept until its copy has run
            self.count("graph_replays", metrics)
        return out


# (device, ring geometry) -> the idle RingSet of that key. Process-wide, as
# the JAX package's compilation cache is: a decoder made per stream (serve's
# per connection, bench's and chip_smoke's per decode) finds the programs
# an earlier one captured
_idle: dict = {}
_idle_lock = threading.Lock()


def checkout(device: torch.device, geom: tuple) -> RingSet:
    """The idle RingSet of (device, geom), or a new one: a decoder open at
    the same time as another of the same geometry gets a set of its own."""
    with _idle_lock:
        rs = _idle.pop((device, geom), None)
    return rs if rs is not None else RingSet(device, geom)


def checkin(rs: RingSet) -> None:
    """Return a RingSet that its decoder no longer uses; the cache keeps at
    most one idle set per (device, geometry) and lets any other go, and a
    set whose capture failed."""
    if rs.failure is not None:
        return
    with _idle_lock:
        _idle.setdefault((rs.device, rs.geom), rs)
