"""Deblocking on the GPU: wrappers of the CUDA kernels in csrc/deblock.cu.

Counterpart of h264decode_tpu/kernels/deblock_pallas.py. `deblock_frame`
keeps the contract of the plain version, kernels/deblock.py::deblock_frame.
A CUDA tensor goes to the hand-written kernels and nothing else; a CPU
tensor takes the plain version, because the kernels do not run on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .deblock import ALPHA_T, BETA_T, TC0_T
from .deblock import deblock_frame as deblock_frame_plain

# alpha[52] | beta[52] | tc0[52][3], the layout csrc/deblock.cu reads
TABLES = np.concatenate([ALPHA_T, BETA_T, TC0_T.reshape(-1)]).astype(np.int32)

_lib = None
_tabs: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("deblock")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.deblock_luma.argtypes = [vp] * 9 + [ci, ci, vp, vp]
        lib.deblock_luma.restype = ci
        lib.deblock_chroma.argtypes = [vp] * 10 + [ci, ci, vp, vp]
        lib.deblock_chroma.restype = ci
        _lib = lib
    return _lib


def _tables(dev: torch.device) -> torch.Tensor:
    t = _tabs.get(dev)
    if t is None:
        t = _tabs[dev] = torch.as_tensor(TABLES, device=dev)
    return t


def deblock_luma(y: torch.Tensor, prep: dict, mb_h: int, mb_w: int) -> None:
    """Filter luma plane y [H, W] uint8 in place (one launch: a persistent
    row wavefront; its sample rows are read and written 16 bytes at a time,
    so y must start on a 16-byte boundary). A hand-off between rows that
    stalls for seconds traps in the kernel (csrc/wavefront.cuh); a trap is a
    sticky CUDA error, so every later CUDA call of the process fails."""
    _build.check_tensor(y, (16 * mb_h, 16 * mb_w), torch.uint8, "y")
    if y.data_ptr() % 16:
        raise ValueError("y: the luma deblock kernel needs a 16-byte-aligned plane")
    names = ("bs_v", "bs_h", "ia_v", "ib_v", "ia_h", "ib_h")
    for n in names:
        _build.check_tensor(prep[n], (4 * mb_h, 4 * mb_w), torch.int32, n)
    # ticket counter + one progress count per MB row, per call so that
    # concurrent calls never share it; the C entry zeroes it on the stream
    sync = torch.empty(mb_h + 1, dtype=torch.int32, device=y.device)
    _build.launch("deblock_luma", _load().deblock_luma, y.data_ptr(),
                  *(prep[n].data_ptr() for n in names), _tables(y.device).data_ptr(),
                  sync.data_ptr(), mb_h, mb_w,
                  torch.cuda.current_stream(y.device).cuda_stream)


def deblock_chroma(cb: torch.Tensor, cr: torch.Tensor, prep: dict, mb_h: int,
                   mb_w: int) -> None:
    """Filter 4:2:0 chroma planes cb/cr [Hc, Wc] uint8 in place (one launch:
    a persistent row wavefront; its sample rows are read and written 8
    bytes at a time, so cb and cr must start on an 8-byte boundary). A
    hand-off between rows that stalls for seconds traps in the kernel
    (csrc/wavefront.cuh); a trap is a sticky CUDA error, so every later CUDA
    call of the process fails."""
    for t, n in ((cb, "cb"), (cr, "cr")):
        _build.check_tensor(t, (8 * mb_h, 8 * mb_w), torch.uint8, n)
        if t.data_ptr() % 8:
            raise ValueError(f"{n}: the chroma deblock kernel needs an 8-byte-aligned plane")
    for n in ("bs_v", "bs_h"):
        _build.check_tensor(prep[n], (4 * mb_h, 4 * mb_w), torch.int32, n)
    names = ("ca_v", "cb_v", "ca_h", "cb_h")
    for n in names:
        _build.check_tensor(prep[n], (2, 4 * mb_h, 4 * mb_w), torch.int32, n)
    sync = torch.empty(mb_h + 1, dtype=torch.int32, device=cb.device)
    _build.launch("deblock_chroma", _load().deblock_chroma, cb.data_ptr(), cr.data_ptr(),
                  prep["bs_v"].data_ptr(), prep["bs_h"].data_ptr(),
                  *(prep[n].data_ptr() for n in names), _tables(cb.device).data_ptr(),
                  sync.data_ptr(), mb_h, mb_w, torch.cuda.current_stream(cb.device).cuda_stream)


def deblock_frame(y, cb, cr, prep: dict, mb_h: int, mb_w: int):
    """Drop-in for kernels.deblock.deblock_frame: returns new filtered uint8
    (y, cb, cr)."""
    if not y.is_cuda:
        return deblock_frame_plain(y, cb, cr, prep, mb_h, mb_w)
    y = y.to(torch.uint8, copy=True).contiguous()
    cb = cb.to(torch.uint8, copy=True).contiguous()
    cr = cr.to(torch.uint8, copy=True).contiguous()
    deblock_luma(y, prep, mb_h, mb_w)
    deblock_chroma(cb, cr, prep, mb_h, mb_w)
    return y, cb, cr
