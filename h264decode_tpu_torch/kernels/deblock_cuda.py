"""Deblocking on the GPU: wrappers of the CUDA kernels in csrc/deblock.cu.

Counterpart of h264decode_tpu/kernels/deblock_pallas.py (4:2:0 8-bit) and of
the XLA wavefront the JAX package runs for 4:2:2 and high bit depths.
`deblock_frame` keeps the contract of the plain version,
kernels/deblock.py::deblock_frame, format arguments included: chroma MB
height ch_h (8 or 16), bd_scale = 1 << (bd - 8) and mx = (1 << bd) - 1. The
planes are uint8 at 8 bits and int16 above (the kernels read the same bits
as uint16). `deblock_planes` is the 8-bit 4:4:4 counterpart: Y, Cb and Cr
through the luma filter (chromaStyleFilteringFlag = 0), each plane with its
own thresholds, in one launch of the luma kernel. The luma and chroma
wrappers and deblock_frame take an optional `halo`, the filtered rows above
MB row 0 (row-band sharding, dist/), as the plain version does. A CUDA
tensor goes to the hand-written kernels and nothing else; a CPU tensor
takes the plain version, because the kernels do not run on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .deblock import ALPHA_T, BETA_T, TC0_T
from .deblock import deblock_frame as deblock_frame_plain
from .device_tables import device_table
from .mc import sample_dtype

# alpha[52] | beta[52] | tc0[52][3], the layout csrc/deblock.cu reads
TABLES = np.concatenate([ALPHA_T, BETA_T, TC0_T.reshape(-1)]).astype(np.int32)

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("deblock")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.deblock_luma.argtypes = [vp] * 10 + [ci] * 6 + [vp, vp]
        lib.deblock_luma.restype = ci
        lib.deblock_chroma.argtypes = [vp] * 12 + [ci] * 6 + [vp, vp]
        lib.deblock_chroma.restype = ci
        _lib = lib
    return _lib


def _sample_format(bd_scale: int, mx: int) -> tuple[torch.dtype, int]:
    """(plane dtype, bytes per sample) for a bit depth of 8..14 given as
    bd_scale = 1 << (bd - 8) and mx = (1 << bd) - 1; raises otherwise."""
    bd = (mx + 1).bit_length() - 1
    if not (8 <= bd <= 14 and mx == (1 << bd) - 1 and bd_scale == 1 << (bd - 8)):
        raise ValueError(f"deblock: unsupported sample format bd_scale={bd_scale} mx={mx} "
                         "(need bit depth 8..14)")
    dt = sample_dtype(mx)
    return dt, 1 if dt == torch.uint8 else 2


def _check_plane(t: torch.Tensor, shape, dt: torch.dtype, line: int, name: str, kernel: str):
    """A plane whose sample rows the kernel moves `line` samples at a time:
    it must start on a boundary of that many bytes."""
    _build.check_tensor(t, shape, dt, name)
    nbytes = line * t.element_size()
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: the {kernel} deblock kernel needs a {nbytes}-byte-aligned "
                         f"plane of {t.dtype}")


def deblock_luma(y: torch.Tensor, prep: dict, mb_h: int, mb_w: int, bd_scale: int = 1,
                 mx: int = 255, halo: torch.Tensor | None = None) -> None:
    """Filter luma plane y [H, W] in place, or the P planes y [P, H, W] that
    share prep's bS grids, each with its own indexA / indexB grid (prep's
    ia_* / ib_* then [P, H4, W4]; 4:4:4's Y, Cb and Cr): uint8 at 8 bits,
    int16 above (one launch: a persistent row wavefront over every plane's
    rows; sample rows are read and written 16 samples at a time, so y must
    start on a 16-byte boundary at uint8 and a 32-byte one at int16).
    halo: the 4 filtered rows above MB row 0, [4, W] ([P, 4, W]) of y's
    dtype and alignment, filtered in place with MB row 0's top edges; None
    leaves those edges alone. A hand-off between rows that stalls for
    seconds traps in the kernel (csrc/wavefront.cuh); a trap is a sticky
    CUDA error, so every later CUDA call of the process fails."""
    dt, nb = _sample_format(bd_scale, mx)
    H4, W4 = 4 * mb_h, 4 * mb_w
    planes = 1 if y.dim() == 2 else y.shape[0]
    lead = () if y.dim() == 2 else (planes,)
    _check_plane(y, lead + (16 * mb_h, 16 * mb_w), dt, 16, "y", "luma")
    if halo is not None:
        _check_plane(halo, lead + (4, 16 * mb_w), dt, 16, "halo", "luma")
    for n in ("bs_v", "bs_h"):
        _build.check_tensor(prep[n], (H4, W4), torch.int32, n)
    for n in ("ia_v", "ib_v", "ia_h", "ib_h"):
        _build.check_tensor(prep[n], lead + (H4, W4), torch.int32, n)
    names = ("bs_v", "bs_h", "ia_v", "ib_v", "ia_h", "ib_h")
    # ticket counter + one progress count per plane and MB row, per call so
    # that concurrent calls never share it; the C entry zeroes it on the
    # stream
    sync = torch.empty(1 + planes * mb_h, dtype=torch.int32, device=y.device)
    name = "deblock_luma" if halo is None else "deblock_luma_halo"
    tabs = device_table(TABLES, y.device)
    _build.launch(name, _load().deblock_luma, y.data_ptr(),
                  *(prep[n].data_ptr() for n in names), tabs.data_ptr(),
                  _build.ptr(halo), sync.data_ptr(), planes, mb_h, mb_w, nb, bd_scale, mx,
                  torch.cuda.current_stream(y.device).cuda_stream)


def deblock_chroma(cb: torch.Tensor, cr: torch.Tensor, prep: dict, mb_h: int,
                   mb_w: int, ch_h: int = 8, bd_scale: int = 1, mx: int = 255,
                   halo=None) -> None:
    """Filter chroma planes cb/cr [mb_h * ch_h, Wc] in place (ch_h 8 for
    4:2:0, 16 for 4:2:2, which reads prep's bs_hc; uint8 at 8 bits, int16
    above; one launch: a persistent row wavefront; its sample rows are read
    and written 8 samples at a time, so cb and cr must start on an 8-byte
    boundary at uint8 and a 16-byte one at int16). halo: (hcb, hcr), the 4
    filtered rows above MB row 0 of each, [4, Wc], filtered in place with
    MB row 0's top edges; None leaves those edges alone. A hand-off between
    rows that stalls for seconds traps in the kernel (csrc/wavefront.cuh); a
    trap is a sticky CUDA error, so every later CUDA call of the process
    fails."""
    dt, nb = _sample_format(bd_scale, mx)
    if ch_h not in (8, 16):
        raise ValueError(f"deblock: chroma MB height {ch_h} is not 8 (4:2:0) or 16 (4:2:2)")
    for t, n in ((cb, "cb"), (cr, "cr")):
        _check_plane(t, (ch_h * mb_h, 8 * mb_w), dt, 8, n, "chroma")
    name = "deblock_chroma" if halo is None else "deblock_chroma_halo"
    halo = (None, None) if halo is None else halo
    for t, n in zip(halo, ("halo_cb", "halo_cr")):
        if t is not None:
            _check_plane(t, (4, 8 * mb_w), dt, 8, n, "chroma")
    bs_hc = "bs_hc" if ch_h == 16 else "bs_h"
    for n in ("bs_v", bs_hc):
        _build.check_tensor(prep[n], (4 * mb_h, 4 * mb_w), torch.int32, n)
    names = ("ca_v", "cb_v", "ca_h", "cb_h")
    for n in names:
        _build.check_tensor(prep[n], (2, 4 * mb_h, 4 * mb_w), torch.int32, n)
    sync = torch.empty(mb_h + 1, dtype=torch.int32, device=cb.device)
    tabs = device_table(TABLES, cb.device)
    _build.launch(name, _load().deblock_chroma, cb.data_ptr(), cr.data_ptr(),
                  prep["bs_v"].data_ptr(), prep[bs_hc].data_ptr(),
                  *(prep[n].data_ptr() for n in names), tabs.data_ptr(),
                  _build.ptr(halo[0]), _build.ptr(halo[1]), sync.data_ptr(), mb_h, mb_w, ch_h,
                  nb, bd_scale, mx, torch.cuda.current_stream(cb.device).cuda_stream)


def deblock_frame(y, cb, cr, prep: dict, mb_h: int, mb_w: int, ch_h: int = 8,
                  bd_scale: int = 1, mx: int = 255, halo=None):
    """Drop-in for kernels.deblock.deblock_frame: returns new filtered
    (y, cb, cr) in the sample dtype of mx (uint8, or int16 above 8 bits);
    with halo (hy [4, W], hcb [4, Wc], hcr [4, Wc]), ((y, cb, cr), halo')
    as the plain version returns them."""
    if not y.is_cuda:
        return deblock_frame_plain(y, cb, cr, prep, mb_h, mb_w, ch_h, bd_scale, mx, halo)
    dt = sample_dtype(mx)
    y = y.to(dt, copy=True).contiguous()
    cb = cb.to(dt, copy=True).contiguous()
    cr = cr.to(dt, copy=True).contiguous()
    if halo is not None:
        halo = tuple(h.to(dt, copy=True).contiguous() for h in halo)
    deblock_luma(y, prep, mb_h, mb_w, bd_scale, mx, None if halo is None else halo[0])
    deblock_chroma(cb, cr, prep, mb_h, mb_w, ch_h, bd_scale, mx,
                   None if halo is None else halo[1:])
    return (y, cb, cr) if halo is None else ((y, cb, cr), halo)


# each luma threshold grid of a prep -> the chroma grid [2, H4, W4] that
# holds Cb's and Cr's luma-style thresholds in 8-bit 4:4:4
_THRESH_444 = {"ia_v": "ca_v", "ib_v": "cb_v", "ia_h": "ca_h", "ib_h": "cb_h"}


def prep_444(prep: dict) -> dict:
    """The edge parameters of an 8-bit 4:4:4 frame's Y, Cb and Cr from one
    deblock_prep_device output (made with the PPS's chroma QP offsets): bS
    shared, ia_* / ib_* stacked to [3, H4, W4] from Y's ia_* / ib_* and Cb's
    and Cr's chroma thresholds ca_* / cb_*, which are the luma-style indexA
    / indexB of their QPc (Table 8-15 of QPY + offset), what the JAX
    package derives per plane from each plane's QP grid with offsets (0, 0)
    (tpu_pipeline.py:463-496)."""
    return {**prep, **{k: torch.cat([prep[k][None], prep[c]]) for k, c in _THRESH_444.items()}}


def plane_prep(prep: dict, p: int) -> dict:
    """Plane p's single-plane prep of a prep whose ia_* / ib_* are
    [P, H4, W4] (views, no copies)."""
    return {**prep, **{k: prep[k][p] for k in _THRESH_444}}


def deblock_planes_plain(planes, prep: dict, mb_h: int, mb_w: int) -> torch.Tensor:
    """The plain version of deblock_planes: deblock_frame once per plane
    with dummy 4:2:0 chroma, keeping its luma output, as the JAX package's
    4:4:4 path computes it (tpu_pipeline.py:487-496)."""
    dummy = torch.zeros((8 * mb_h, 8 * mb_w), dtype=torch.uint8, device=planes.device)
    return torch.stack([deblock_frame_plain(pl, dummy, dummy, plane_prep(prep, p), mb_h, mb_w)[0]
                        for p, pl in enumerate(planes)])


def deblock_planes(planes, prep: dict, mb_h: int, mb_w: int) -> torch.Tensor:
    """8-bit 4:4:4 deblocking (chromaStyleFilteringFlag = 0: Cb and Cr take
    the luma filter): planes [P, H, W] uint8 (4:4:4's Y, Cb, Cr) and a prep
    whose bS grids they share and whose ia_* / ib_* are [P, H4, W4], one per
    plane (prep_444) -> new filtered uint8 [P, H, W]. On a CUDA tensor, one
    launch of the luma kernel over the P planes."""
    if not planes.is_cuda:
        return deblock_planes_plain(planes, prep, mb_h, mb_w)
    out = planes.to(torch.uint8, copy=True).contiguous()
    deblock_luma(out, prep, mb_h, mb_w)
    return out
