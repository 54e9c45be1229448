"""Row-band sharded reconstruction of one frame over a mesh row, as device
programs.

Counterpart of h264decode_tpu/dist/sharded.py. The frame's macroblock rows
are cut into R bands, band r on device mesh.row(g)[r]:

- Residual transforms, (weighted) motion compensation and PCM placement
  are exactly row-parallel for any stream: each band runs the single-device
  program's `_base_planes` (pipeline/gpu_pipeline.py) on its own rows.
- Reference pictures reach every device of the row whole (the JAX step
  all-gathers their row shards), and each device builds the half-pel MC
  planes of the whole references once.

Then intra prediction and deblocking, in one of two modes chosen per frame
(dist/decoder.py):

aligned (halo=False)
    Band-local intra and deblocking, every band independent. Exact when
    every band boundary is a slice boundary that deblocking does not cross,
    so nothing predicts or filters across it.

halo (halo=True)
    Exact for any stream. The bands run intra then deblocking one after
    another, from the top band down. Band i predicts its MB row 0 from the
    unfiltered bottom row of band i-1 (the `top` input of the intra
    kernels), keeps its own unfiltered bottom row for band i+1, deblocks
    with band i-1's filtered bottom 4 rows as the rows above (the `halo`
    input of the deblock kernels), and pastes the rows that its top edges
    modified (3 luma, 1 chroma) back into band i-1. The JAX step runs every
    band in every step as SPMD and masks the inactive bands' kind and bS
    grids to zero; here band 0 simply runs the kernels without halo rows.

Programs. JAX compiles the step once per jit signature (`jax.jit` of its
shard_map); `signature` is that cache key here. A ShardSet (one mesh row
and frame geometry) holds a ShardStep per signature: static buffers for
every band's inputs and, on a CUDA device, the band programs, each captured
once in a CUDA graph (pipeline/frame_program.Program) and replayed for
every later frame of its signature:

- aligned: one program per band (residuals, MC, PCM, intra, deblocking);
- halo: a base program per band (residuals, MC, PCM), all replayed first,
  so that bands on distinct cards overlap as the SPMD program's parallel
  stages do; then a recon program per band (intra, deblocking), replayed
  from the top band down.

A frame's inputs (dist/decoder.py's build_inputs, host arrays) are cut into
bands on the host and packed, band by band, into one pinned buffer each
(convert.pack_wire, the replicated and weight tables included), which one
copy moves into the band's static device buffer; the programs widen the
narrow arrays to int32 themselves. The whole-frame raw references take one
copy into a static buffer on each distinct device of the row, whose first
program builds the MC planes that the other programs there read. The rows
that cross bands in halo mode move between replays, by copies between
static buffers, never inside a graph: a graph is captured on one device's
stream, and a band's neighbour may be on another card.

On the CPU the same objects call the band functions eagerly on their
static buffers, with no graph. Every step returns host uint8 planes.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import convert
from ..kernels import mc as mc_k
from ..kernels.deblock import LPAD
from ..kernels.deblock_cuda import deblock_frame
from ..kernels.deblock_prep_dev import _part_to_cells, expand_slot_mv
from ..kernels.intra_cuda import intra_frame
from ..pipeline import frame_program
from ..pipeline.frame_program import Program, ProgramSet
from ..pipeline.gpu_pipeline import _base_planes

# per-(SPS, PPS) scaling tables: the same on every band
REPLICATED = ("ls4_y", "ls8_y", "ls4_c")

# per-slice weighted-prediction tables: per gop slot, the same on every band
WEIGHT_KEYS = (
    "w_tab", "o_tab", "wc_tab", "oc_tab", "lwd_tab",
    "pw0", "pw1", "pwc0", "pwc1",
)

# arrays whose rows lie on axis 1 (axis 0: reference slot or chroma
# component); every other per-frame array has its MBs, cells or pixel rows
# on axis 0, in raster order
_ROW_AXIS1 = ("ref_luma_raw", "ref_cb_raw", "ref_cr_raw",
              "db_ca_v", "db_cb_v", "db_ca_h", "db_cb_h")
_REFS = ("ref_luma_raw", "ref_cb_raw", "ref_cr_raw")
# what the recon program reads of the band's inputs, besides the db_* grids
_INTRA_KEYS = ("kind", "modes4", "i16mode", "cmode", "avl", "avt", "avtr", "avtl")


def on_device(dev: torch.device):
    """Make `dev` the current CUDA device (kernels launch on the current
    device's streams); nothing for a CPU device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def signature(inp: dict, devices, mb_h: int, mb_w: int, apply_deblock: bool,
              qp_offsets, halo: bool, has_pcm: bool) -> tuple:
    """The cache key of a step's programs: what makes JAX trace its sharded
    step again. The static arguments of make_sharded_step (the row's
    devices, mb_h, mb_w, apply_deblock, qp_offsets, halo, has_pcm) and, for
    every input array in order, its key, shape and dtype: the reference
    count (JAX's static n_refs), the weight tables' slice and list widths,
    and whether PCM planes and deblock grids are present."""
    return (tuple(devices), (mb_h, mb_w), bool(apply_deblock),
            tuple(int(q) for q in qp_offsets), bool(halo), bool(has_pcm),
            tuple((k, tuple(np.shape(v)), str(np.asarray(v).dtype)) for k, v in inp.items()))


def _band_rows(a: np.ndarray, r: int, n_row: int, axis: int) -> np.ndarray:
    n = a.shape[axis] // n_row
    return a[(slice(None),) * axis + (slice(r * n, (r + 1) * n),)]


def _band_inputs(inp: dict, r: int, n_row: int) -> dict:
    """Band r's host arrays: its rows of every per-frame array, and the
    replicated and weight tables whole; the references travel apart."""
    return {k: v if k in REPLICATED or k in WEIGHT_KEYS
            else _band_rows(v, r, n_row, 1 if k in _ROW_AXIS1 else 0)
            for k, v in inp.items() if k not in _REFS}


def _widen(loc: dict, keys=None) -> dict:
    """The band's arrays (those of `keys` and the db_* grids, default all)
    as the stages read them: integers widened to int32 before any
    arithmetic; booleans stay."""
    return {k: v if v.dtype == torch.bool else v.to(torch.int32)
            for k, v in loc.items() if keys is None or k in keys or k.startswith("db_")}


def _rings(refs: dict):
    """The MC planes of the whole references on one device: half-pel
    stacks [n_refs, 4, Hp, Wp] and padded (Cb, Cr) [n_refs, 2, Hpc, Wpc]."""
    ry, rcb, rcr = (refs[k] for k in _REFS)
    return (torch.stack([mc_k.half_pel_planes(p) for p in ry]),
            torch.stack([torch.stack([mc_k.chroma_pad(b), mc_k.chroma_pad(c)])
                         for b, c in zip(rcb, rcr)]))


def _band_base(loc: dict, ring, row0: int, mb_hl: int, mb_w: int, qp_offsets,
               has_pcm: bool):
    """The band's residual, MC and PCM stages: _base_planes on the band's
    rows, with the compact per-MB motion expanded to cells."""
    band = dict(loc)
    band["qp_offsets"] = qp_offsets
    # band-local MVs gather from the whole references: shift the vertical
    # component by the band origin (quarter-pel luma; chroma MC reads the
    # same value as 1/8-pel of half as many rows, so one shift is exact for
    # both planes)
    mv = loc["mv_parts"].clone()
    mv[..., 1] += 4 * row0
    band["slot_cells"], band["mv_cells"] = expand_slot_mv(
        loc["slot_parts"], mv, loc["is_intra"], mb_hl, mb_w)
    rp = loc["ridx_parts"]
    band["ridx_cells"] = torch.stack([_part_to_cells(rp[:, lst], mb_hl, mb_w) for lst in range(2)])
    band["ref_luma"], band["ref_chroma"] = ring
    # build_inputs always sends luma8_ac (zeros without 8x8 transforms)
    return _base_planes(band, mb_hl, mb_w, has_l8=True, has_pcm=has_pcm)


def _recon(base, loc: dict, mb_hl: int, mb_w: int, apply_deblock: bool, top=None,
           halo=None):
    """Intra (with the row above MB row 0, or none) and deblocking (with the
    4 filtered rows above, or none). Returns the band's uint8 (y, cb, cr),
    its unfiltered bottom rows (int32) and, with halo, the halo rows as
    the boundary edges left them (else None)."""
    y, cb, cr = intra_frame(*base, loc["kind"], loc["modes4"], loc["i16mode"], loc["cmode"],
                            loc["avl"], loc["avt"], loc["avtr"], loc["avtl"], mb_hl, mb_w,
                            top=top)
    # intra predicts from UNFILTERED neighbours (8.3.1): the pre-deblock
    # bottom row goes to the band below
    bottom = tuple(a[-1].clone() for a in (y, cb, cr))
    p = tuple(a.to(torch.uint8) for a in (y, cb, cr))
    up = None
    if apply_deblock:
        prep = {k[3:]: v for k, v in loc.items() if k.startswith("db_")}
        if halo is None:
            p = deblock_frame(*p, prep, mb_hl, mb_w)
        else:
            p, up = deblock_frame(*p, prep, mb_hl, mb_w, halo=halo)
    return p, bottom, up


class ShardStep:
    """The static buffers and band programs of one signature on one mesh
    row. `programs` maps (stage, band) to its Program: ("band", r) in
    aligned mode, ("base", r) and ("recon", r) in halo mode."""

    def __init__(self, key: tuple, inp: dict, devices, mb_h: int, mb_w: int,
                 apply_deblock: bool, qp_offsets, halo: bool, has_pcm: bool):
        n_row = len(devices)
        assert mb_h % n_row == 0, "mb_h must divide by row shards"
        self.key = key
        self.devices = tuple(devices)
        self.mb_hl, self.mb_w = mb_h // n_row, mb_w
        self.apply_deblock, self.qp_offsets = apply_deblock, tuple(qp_offsets)
        self.halo, self.has_pcm = halo, has_pcm
        self.programs: dict[tuple, Program] = {}
        self.frames = 0  # frames run
        # per band: (host staging buffer, static device buffer, typed views)
        self.bands = [self._buffers(_band_inputs(inp, r, n_row), dev)
                      for r, dev in enumerate(self.devices)]
        # the whole-frame raw references: one host buffer, one static
        # buffer on each distinct device
        refs = {k: inp[k] for k in _REFS}
        cuda = any(d.type == "cuda" for d in self.devices)
        self.refs_host = self._host(refs, cuda)
        self.refs = {d: self._buffers(refs, d, self.refs_host) for d in dict.fromkeys(devices)}
        # halo mode, bands 1..R-1: the rows above MB row 0, written between
        # replays (intra's unfiltered row, int32; deblocking's 4 filtered
        # rows, uint8)
        W, Wc = 16 * mb_w, 8 * mb_w
        self.top = [None] + [tuple(torch.zeros(w, dtype=torch.int32, device=d) for w in (W, Wc, Wc))
                             for d in self.devices[1:]]
        self.above = [None] + [tuple(torch.zeros((LPAD, w), dtype=torch.uint8, device=d)
                                     for w in (W, Wc, Wc)) for d in self.devices[1:]]

    @staticmethod
    def _host(arrays: dict, pinned: bool) -> torch.Tensor:
        total, _ = convert.wire_layout(arrays)
        return torch.empty(max(total, 8), dtype=torch.uint8, pin_memory=pinned)

    def _buffers(self, arrays: dict, dev: torch.device, host=None):
        if host is None:
            host = self._host(arrays, dev.type == "cuda")
        _, layout = convert.wire_layout(arrays)
        buf = torch.empty(host.numel(), dtype=torch.uint8, device=dev)
        return host, buf, convert.unpack_wire(buf, layout)

    def load(self, inp: dict) -> None:
        """Pack each band's arrays and the references into their host
        buffers and copy each into its static device buffer (one copy a
        band, one a distinct device), on the current streams. The previous
        step ended with its planes on the host, so no copy of it still
        reads a host buffer."""
        n_row = len(self.devices)
        for r, (host, buf, _) in enumerate(self.bands):
            convert.pack_wire(_band_inputs(inp, r, n_row), host.numpy())
            buf.copy_(host, non_blocking=True)
        convert.pack_wire({k: inp[k] for k in _REFS}, self.refs_host.numpy())
        for host, buf, _ in self.refs.values():
            buf.copy_(host, non_blocking=True)

    def _run(self, ps: ProgramSet, stage: str, r: int, fn, metrics):
        """Band r's program of `stage` run (captured first on a CUDA device
        if this step has none); returns its output."""
        dev = self.devices[r]
        prog = self.programs.get((stage, r))
        if prog is None:
            prog = Program(self.key, f"sharded program ({stage!r}, band {r})")
            if dev.type == "cuda":
                ps.capture(prog, fn, dev, metrics)
            self.programs[(stage, r)] = prog
        out = prog.run(fn)
        if dev.type == "cuda":
            ps.count("graph_replays", metrics)
        return out

    def _first(self, ps: ProgramSet, stage: str, r: int, rings: dict, fn, metrics):
        """Band r's program of its first stage (fn(band arrays, MC planes,
        band origin row)): the device's first program builds the MC planes
        of the references, later ones read them. Returns fn's output."""
        dev = self.devices[r]
        first = dev not in rings
        views = self.bands[r][2]

        def call():
            ring = _rings(self.refs[dev][2]) if first else rings[dev]
            return ring, fn(_widen(views), ring, 16 * r * self.mb_hl)

        with on_device(dev):
            ring, out = self._run(ps, stage, r, call, metrics)
        rings.setdefault(dev, ring)
        return out

    def run(self, ps: ProgramSet, inp: dict, metrics=None):
        """One frame: load, then every band program in order with the rows
        between bands moved between replays; returns the host planes."""
        mb_hl, mb_w, db = self.mb_hl, self.mb_w, self.apply_deblock
        self.frames += 1
        t0, cap0 = time.time(), ps.metrics.timers["graph_capture"]
        self.load(inp)
        rings = {}

        def base(loc, ring, row0):
            return _band_base(loc, ring, row0, mb_hl, mb_w, self.qp_offsets, self.has_pcm)

        def band(loc, ring, row0):
            return _recon(base(loc, ring, row0), loc, mb_hl, mb_w, db)[0]

        if not self.halo:
            outs = [self._first(ps, "band", r, rings, band, metrics)
                    for r in range(len(self.devices))]
        else:
            bases = [self._first(ps, "base", r, rings, base, metrics)
                     for r in range(len(self.devices))]
            outs, bottom = [], None
            for r, dev in enumerate(self.devices):
                with on_device(dev):
                    top = above = None
                    if r:  # the rows of band r-1 that band r reads
                        top, above = self.top[r], self.above[r] if db else None
                        for t, s in zip(top, bottom):
                            t.copy_(s)
                        if db:
                            for t, s in zip(above, outs[r - 1]):
                                t.copy_(s[-LPAD:])
                    views = self.bands[r][2]
                    p, bottom, up = self._run(
                        ps, "recon", r, lambda: _recon(
                            bases[r], _widen(views, _INTRA_KEYS), mb_hl, mb_w, db, top, above),
                        metrics)
                    if up is not None:
                        # the boundary edges modified up to 3 luma rows and 1
                        # chroma row of the band above: paste them back there
                        y, cb, cr = outs[r - 1]
                        y[-3:].copy_(up[0][1:])
                        cb[-1:].copy_(up[1][-1:])
                        cr[-1:].copy_(up[2][-1:])
                outs.append(p)
        # the captures (timed apart) excluded
        ps.add_time("dispatch", time.time() - t0 - (ps.metrics.timers["graph_capture"] - cap0),
                    metrics)
        t0 = time.time()
        planes = tuple(np.concatenate([p[c].cpu().numpy() for p in outs]) for c in range(3))
        ps.add_time("download", time.time() - t0, metrics)
        return planes


class ShardSet(ProgramSet):
    """The band programs of one mesh row (`devices`) and frame geometry
    (mb_h, mb_w), one ShardStep per signature. One decoder uses a set at a
    time (checkout / checkin)."""

    def __init__(self, devices, geom: tuple):
        super().__init__(devices)
        self.devices = tuple(devices)
        self.geom = geom
        self.steps: dict[tuple, ShardStep] = {}

    def step(self, key: tuple, inp: dict, mb_h: int, mb_w: int, apply_deblock: bool,
             qp_offsets, halo: bool, has_pcm: bool, metrics=None):
        """Run one frame's host arrays `inp` (dist/decoder.py's
        build_inputs: per-MB arrays [nMB, ...], cell grids [H4, W4], PCM
        planes [H, W], raw references [n_refs, H, W], deblock grids "db_*",
        scaling and weight tables) through the programs of `key` (signature
        of the same arguments), capturing them first if this set has none.
        Returns the host planes (y [H, W], cb, cr [H/2, W/2]) uint8.
        metrics (and the set's own): `graph_captures`, `graph_replays`, the
        `graph_capture` timer (warm call and capture), the `dispatch` timer
        (packing, copies and replays, captures excluded) and the `download`
        timer (the planes to the host)."""
        self.check()
        st = self.steps.get(key)
        if st is None:
            st = self.steps[key] = ShardStep(key, inp, self.devices, mb_h, mb_w, apply_deblock,
                                             qp_offsets, halo, has_pcm)
        return st.run(self, inp, metrics)


# (row devices, frame geometry) -> the idle ShardSets of that key: as many
# as were open at once (gop slots of one card and geometry), so that a later
# decode of the same mesh replays without capturing. Process-wide, as the
# JAX package's compilation cache is
_idle: dict = {}


def checkout(devices, geom: tuple) -> ShardSet:
    """An idle ShardSet of (devices, geom), or a new one: a decoder open at
    the same time as another of the same row and geometry gets a set of its
    own."""
    with frame_program._idle_lock:
        idle = _idle.get((tuple(devices), geom))
        ss = idle.pop() if idle else None
    return ss if ss is not None else ShardSet(devices, geom)


def checkin(ss: ShardSet) -> None:
    """Return a ShardSet that its decoder no longer uses; one whose capture
    failed is let go."""
    if ss.failure is not None:
        return
    with frame_program._idle_lock:
        _idle.setdefault((ss.devices, ss.geom), []).append(ss)
