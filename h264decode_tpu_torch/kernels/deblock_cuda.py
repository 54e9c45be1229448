"""Deblocking on the GPU: wrappers of the CUDA kernels in csrc/deblock.cu.

Counterpart of h264decode_tpu/kernels/deblock_pallas.py (4:2:0 8-bit) and of
the XLA wavefront the JAX package runs for 4:2:2 and high bit depths.
`deblock_frame` keeps the contract of the plain version,
kernels/deblock.py::deblock_frame, format arguments included: chroma MB
height ch_h (8 or 16), bd_scale = 1 << (bd - 8) and mx = (1 << bd) - 1. The
planes are uint8 at 8 bits and int16 above (the kernels read the same bits
as uint16). A CUDA tensor goes to the hand-written kernels and nothing
else; a CPU tensor takes the plain version, because the kernels do not run
on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .deblock import ALPHA_T, BETA_T, TC0_T
from .deblock import deblock_frame as deblock_frame_plain
from .mc import sample_dtype

# alpha[52] | beta[52] | tc0[52][3], the layout csrc/deblock.cu reads
TABLES = np.concatenate([ALPHA_T, BETA_T, TC0_T.reshape(-1)]).astype(np.int32)

_lib = None
_tabs: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("deblock")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.deblock_luma.argtypes = [vp] * 9 + [ci] * 5 + [vp, vp]
        lib.deblock_luma.restype = ci
        lib.deblock_chroma.argtypes = [vp] * 10 + [ci] * 6 + [vp, vp]
        lib.deblock_chroma.restype = ci
        _lib = lib
    return _lib


def _tables(dev: torch.device) -> torch.Tensor:
    t = _tabs.get(dev)
    if t is None:
        t = _tabs[dev] = torch.as_tensor(TABLES, device=dev)
    return t


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
                 mx: int = 255) -> None:
    """Filter luma plane y [H, W] in place: uint8 at 8 bits, int16 above
    (one launch: a persistent row wavefront; its sample rows are read and
    written 16 samples at a time, so y must start on a 16-byte boundary at
    uint8 and a 32-byte one at int16). A hand-off between rows that stalls
    for seconds traps in the kernel (csrc/wavefront.cuh); a trap is a
    sticky CUDA error, so every later CUDA call of the process fails."""
    dt, nb = _sample_format(bd_scale, mx)
    _check_plane(y, (16 * mb_h, 16 * mb_w), dt, 16, "y", "luma")
    names = ("bs_v", "bs_h", "ia_v", "ib_v", "ia_h", "ib_h")
    for n in names:
        _build.check_tensor(prep[n], (4 * mb_h, 4 * mb_w), torch.int32, n)
    # ticket counter + one progress count per MB row, per call so that
    # concurrent calls never share it; the C entry zeroes it on the stream
    sync = torch.empty(mb_h + 1, dtype=torch.int32, device=y.device)
    _build.launch("deblock_luma", _load().deblock_luma, y.data_ptr(),
                  *(prep[n].data_ptr() for n in names), _tables(y.device).data_ptr(),
                  sync.data_ptr(), mb_h, mb_w, nb, bd_scale, mx,
                  torch.cuda.current_stream(y.device).cuda_stream)


def deblock_chroma(cb: torch.Tensor, cr: torch.Tensor, prep: dict, mb_h: int,
                   mb_w: int, ch_h: int = 8, bd_scale: int = 1, mx: int = 255) -> None:
    """Filter chroma planes cb/cr [mb_h * ch_h, Wc] in place (ch_h 8 for
    4:2:0, 16 for 4:2:2, which reads prep's bs_hc; uint8 at 8 bits, int16
    above; one launch: a persistent row wavefront; its sample rows are read
    and written 8 samples at a time, so cb and cr must start on an 8-byte
    boundary at uint8 and a 16-byte one at int16). A hand-off between rows
    that stalls for seconds traps in the kernel (csrc/wavefront.cuh); a trap
    is a sticky CUDA error, so every later CUDA call of the process fails."""
    dt, nb = _sample_format(bd_scale, mx)
    if ch_h not in (8, 16):
        raise ValueError(f"deblock: chroma MB height {ch_h} is not 8 (4:2:0) or 16 (4:2:2)")
    for t, n in ((cb, "cb"), (cr, "cr")):
        _check_plane(t, (ch_h * mb_h, 8 * mb_w), dt, 8, n, "chroma")
    bs_hc = "bs_hc" if ch_h == 16 else "bs_h"
    for n in ("bs_v", bs_hc):
        _build.check_tensor(prep[n], (4 * mb_h, 4 * mb_w), torch.int32, n)
    names = ("ca_v", "cb_v", "ca_h", "cb_h")
    for n in names:
        _build.check_tensor(prep[n], (2, 4 * mb_h, 4 * mb_w), torch.int32, n)
    sync = torch.empty(mb_h + 1, dtype=torch.int32, device=cb.device)
    _build.launch("deblock_chroma", _load().deblock_chroma, cb.data_ptr(), cr.data_ptr(),
                  prep["bs_v"].data_ptr(), prep[bs_hc].data_ptr(),
                  *(prep[n].data_ptr() for n in names), _tables(cb.device).data_ptr(),
                  sync.data_ptr(), mb_h, mb_w, ch_h, nb, bd_scale, mx,
                  torch.cuda.current_stream(cb.device).cuda_stream)


def deblock_frame(y, cb, cr, prep: dict, mb_h: int, mb_w: int, ch_h: int = 8,
                  bd_scale: int = 1, mx: int = 255):
    """Drop-in for kernels.deblock.deblock_frame: returns new filtered
    (y, cb, cr) in the sample dtype of mx (uint8, or int16 above 8 bits)."""
    if not y.is_cuda:
        return deblock_frame_plain(y, cb, cr, prep, mb_h, mb_w, ch_h, bd_scale, mx)
    dt = sample_dtype(mx)
    y = y.to(dt, copy=True).contiguous()
    cb = cb.to(dt, copy=True).contiguous()
    cr = cr.to(dt, copy=True).contiguous()
    deblock_luma(y, prep, mb_h, mb_w, bd_scale, mx)
    deblock_chroma(cb, cr, prep, mb_h, mb_w, ch_h, bd_scale, mx)
    return y, cb, cr
