"""Row-band sharded reconstruction of one frame over a mesh row.

Counterpart of h264decode_tpu/dist/sharded.py. The frame's macroblock rows
are cut into R bands, band r on device mesh.row(g)[r]:

- Residual transforms, (weighted) motion compensation and PCM placement
  are exactly row-parallel for any stream: each band runs the single-device
  program's `_base_planes` (pipeline/gpu_pipeline.py) on its own rows.
- Reference pictures are all-gathered over the row axis: every band's rows
  of the raw references are copied to every band's device and concatenated,
  and each device builds the half-pel MC planes of the whole references
  (once per distinct device).

Then intra prediction and deblocking, in one of two modes chosen per stream
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
    modified (3 luma, 1 chroma) back into band i-1. Each move is a
    Tensor.to(device) of the receiving band. The JAX step runs every band in
    every step as SPMD and masks the inactive bands' kind and bS grids to
    zero; this host loop simply launches nothing for them.

Every step reads its inputs as host arrays (one frame of one gop slot,
dist/decoder.py's build_inputs) and returns host uint8 planes.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..kernels import mc as mc_k
from ..kernels.deblock import LPAD
from ..kernels.deblock_cuda import deblock_frame
from ..kernels.deblock_prep_dev import _part_to_cells, expand_slot_mv
from ..kernels.intra_cuda import intra_frame
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


def on_device(dev: torch.device):
    """Make `dev` the current CUDA device (kernels launch on the current
    device's streams); nothing for a CPU device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _band_rows(a: np.ndarray, r: int, n_row: int, axis: int) -> np.ndarray:
    n = a.shape[axis] // n_row
    return a[(slice(None),) * axis + (slice(r * n, (r + 1) * n),)]


def _upload(key: str, a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One array to `dev` in its narrow dtype, widened there: integers to
    int32 before any arithmetic; booleans and the uint8 references stay."""
    t = torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    if t.dtype == torch.bool or key in _REFS:
        return t
    return t.to(torch.int32)


def _band_base(loc: dict, ring, row0: int, mb_hl: int, mb_w: int, qp_offsets,
               has_pcm: bool):
    """The band's residual, MC and PCM stages: _base_planes on the band's
    rows, with the compact per-MB motion expanded to cells."""
    band = dict(loc)
    band["qp_offsets"] = qp_offsets
    # band-local MVs gather from the full (gathered) references: shift the
    # vertical component by the band origin (quarter-pel luma; chroma MC
    # reads the same value as 1/8-pel of half as many rows, so one shift is
    # exact for both planes)
    mv = loc["mv_parts"].clone()
    mv[..., 1] += 4 * row0
    band["slot_cells"], band["mv_cells"] = expand_slot_mv(
        loc["slot_parts"], mv, loc["is_intra"], mb_hl, mb_w)
    rp = loc["ridx_parts"]
    band["ridx_cells"] = torch.stack([_part_to_cells(rp[:, lst], mb_hl, mb_w) for lst in range(2)])
    band["ref_luma"], band["ref_chroma"] = ring
    # build_inputs always sends luma8_ac (zeros without 8x8 transforms)
    return _base_planes(band, mb_hl, mb_w, has_l8=True, has_pcm=has_pcm)


def _intra(base, loc: dict, mb_hl: int, mb_w: int, top=None):
    return intra_frame(*base, loc["kind"], loc["modes4"], loc["i16mode"], loc["cmode"],
                       loc["avl"], loc["avt"], loc["avtr"], loc["avtl"], mb_hl, mb_w, top=top)


def _prep(loc: dict) -> dict:
    return {k[3:]: v for k, v in loc.items() if k.startswith("db_")}


def make_sharded_step(mesh, mb_h: int, mb_w: int, apply_deblock: bool = True,
                      qp_offsets=(0, 0), halo: bool = False, has_pcm: bool = False):
    """The decode step of one frame over the R bands of a mesh row.

    step(inp, g=0) takes one frame's host arrays (dist/decoder.py's
    build_inputs: per-MB arrays [nMB, ...], cell grids [H4, W4], PCM planes
    [H, W], raw references [n_refs, H, W], deblock grids "db_*", scaling and
    weight tables) and runs it on gop slot g's bands; it returns the host
    planes (y [H, W], cb, cr [H/2, W/2]) uint8."""
    n_row = mesh.shape["row"]
    assert mb_h % n_row == 0, "mb_h must divide by row shards"
    mb_hl = mb_h // n_row

    def step(inp: dict, g: int = 0):
        devs = mesh.row(g)
        locs = []
        for r, dev in enumerate(devs):
            loc = {}
            for k, v in inp.items():
                if k not in REPLICATED and k not in WEIGHT_KEYS:
                    v = _band_rows(v, r, n_row, 1 if k in _ROW_AXIS1 else 0)
                loc[k] = _upload(k, v, dev)
            locs.append(loc)
        # ---- DPB exchange: every band's reference rows to every device
        rings = {}
        for dev in devs:
            if dev in rings:
                continue
            with on_device(dev):
                ry, rcb, rcr = (torch.cat([loc[k].to(dev) for loc in locs], dim=1)
                                for k in _REFS)
                rings[dev] = (
                    torch.stack([mc_k.half_pel_planes(p) for p in ry]),
                    torch.stack([torch.stack([mc_k.chroma_pad(b), mc_k.chroma_pad(c)])
                                 for b, c in zip(rcb, rcr)]),
                )
        bases = []
        for r, dev in enumerate(devs):
            with on_device(dev):
                bases.append(_band_base(locs[r], rings[dev], r * mb_hl * 16, mb_hl, mb_w,
                                        qp_offsets, has_pcm))
        if halo:
            planes = _halo_bands(devs, locs, bases, mb_hl, mb_w, apply_deblock)
        else:
            planes = []
            for r, dev in enumerate(devs):
                with on_device(dev):
                    p = tuple(a.to(torch.uint8) for a in _intra(bases[r], locs[r], mb_hl, mb_w))
                    if apply_deblock:
                        p = deblock_frame(*p, _prep(locs[r]), mb_hl, mb_w)
                    planes.append(p)
        return tuple(np.concatenate([p[c].cpu().numpy() for p in planes]) for c in range(3))

    return step


def _halo_bands(devs, locs, bases, mb_hl: int, mb_w: int, apply_deblock: bool):
    """Intra and deblocking band after band, top down, with the halo rows
    moved between neighbouring bands' devices. Returns each band's uint8
    (y, cb, cr)."""
    out = []
    ih = dh = None  # band 0 has no band above: its top row and halo stay out
    for i, dev in enumerate(devs):
        with on_device(dev):
            y, cb, cr = _intra(bases[i], locs[i], mb_hl, mb_w, top=ih)
            # intra predicts from UNFILTERED neighbours (8.3.1): keep the
            # pre-deblock bottom row for the band below
            ih_send = (y[-1], cb[-1], cr[-1])
            p = [a.to(torch.uint8) for a in (y, cb, cr)]
            if apply_deblock:
                if dh is None:
                    p = list(deblock_frame(*p, _prep(locs[i]), mb_hl, mb_w))
                else:
                    p, (uy, ucb, ucr) = deblock_frame(*p, _prep(locs[i]), mb_hl, mb_w, halo=dh)
                    p = list(p)
                    # the boundary edges modified up to 3 luma rows and 1
                    # chroma row of the band above: paste them back there
                    above, up_dev = out[i - 1], devs[i - 1]
                    above[0][-3:] = uy[1:].to(up_dev)
                    above[1][-1:] = ucb[-1:].to(up_dev)
                    above[2][-1:] = ucr[-1:].to(up_dev)
            out.append(p)
            if i + 1 < len(devs):
                nxt = devs[i + 1]
                ih = tuple(t.to(nxt) for t in ih_send)
                if apply_deblock:
                    dh = tuple(t[-LPAD:].to(nxt) for t in p)
    return out
