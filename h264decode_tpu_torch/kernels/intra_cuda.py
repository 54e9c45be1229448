"""Intra prediction on the GPU: wrappers of the CUDA kernels in csrc/intra.cu.

Counterpart of h264decode_tpu/kernels/intra_pallas.py (4:2:0 8-bit) and of
the XLA wavefront the JAX package runs for 4:2:2 and high bit depths.
`intra_frame` keeps intra_wavefront's contract (kernels/intra.py), format
arguments included: chroma MB height ch_h (8 or 16), DC fallback mid and
Clip1 ceiling mx. `intra_planes` is the 8-bit 4:4:4 counterpart: Y, Cb and
Cr through the luma process, in one launch of the luma kernel. Each takes
an optional `top`, the row above MB row 0 (row-band sharding, dist/), as
intra_wavefront does. A CUDA tensor goes to the hand-written kernels and
nothing else; a CPU tensor takes the plain version, because the kernels do
not run on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .intra import intra_wavefront

NPARAM = 20  # per-MB int32 params: kind, i16mode, cmode, avail bits, modes4[16]

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("intra")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.intra_luma.argtypes = [vp] * 5 + [ci] * 5 + [vp, vp]
        lib.intra_luma.restype = ci
        lib.intra_chroma.argtypes = [vp] * 8 + [ci] * 5 + [vp, vp]
        lib.intra_chroma.restype = ci
        _lib = lib
    return _lib


def pack_params(kind, modes4, i16mode, cmode, avl, avt, avtr, avtl) -> torch.Tensor:
    """Per-MB kernel parameters [nMB, 20] int32: kind, i16mode, cmode,
    availability bits (1 left, 2 top, 4 top-right, 8 top-left), modes4."""
    i32 = torch.int32
    av = (avl.to(i32) | (avt.to(i32) << 1) | (avtr.to(i32) << 2)
          | (avtl.to(i32) << 3))
    cols = [kind.to(i32), i16mode.to(i32), cmode.to(i32), av]
    return torch.cat([torch.stack(cols, 1), modes4.to(i32).reshape(-1, 16)], 1).contiguous()


def _check(t: torch.Tensor, shape, name: str):
    _build.check_tensor(t, shape, torch.int32, name)


def _check_format(mid: int, mx: int, ch_h: int = 8):
    """Raise unless (mid, mx) is (1 << (bd-1), (1 << bd) - 1) for a bit
    depth bd of 8..14 and ch_h is 8 (4:2:0) or 16 (4:2:2)."""
    bd = (mx + 1).bit_length() - 1
    if not (8 <= bd <= 14 and mx == (1 << bd) - 1 and mid == 1 << (bd - 1)):
        raise ValueError(f"intra: unsupported sample format mid={mid} mx={mx} "
                         "(need bit depth 8..14)")
    if ch_h not in (8, 16):
        raise ValueError(f"intra: chroma MB height {ch_h} is not 8 (4:2:0) or 16 (4:2:2)")


def intra_luma(y: torch.Tensor, ry: torch.Tensor, params: torch.Tensor,
               mb_h: int, mb_w: int, mid: int = 128, mx: int = 255,
               top: torch.Tensor | None = None) -> None:
    """Reconstruct the intra MBs of luma plane y [H, W] int32, or of the P
    planes y [P, H, W] that share one params table (4:4:4's Y, Cb and Cr),
    in place with residuals ry of y's shape (one launch: a persistent row
    wavefront over every plane's rows, csrc/wavefront.cuh). top: the row
    above MB row 0, int32 [W] ([P, W]), or None (it reads as 0). A hand-off
    between rows that stalls for seconds traps in the kernel; a trap is a
    sticky CUDA error, so every later CUDA call of the process fails."""
    H, W = 16 * mb_h, 16 * mb_w
    _check_format(mid, mx)
    planes = 1 if y.dim() == 2 else y.shape[0]
    shape = (H, W) if y.dim() == 2 else (planes, H, W)
    _check(y, shape, "y")
    _check(ry, shape, "resid_y")
    _check(params, (mb_h * mb_w, NPARAM), "params")
    if top is not None:
        _check(top, shape[:-2] + (W,), "top")
    # ticket counter + one progress count per plane and MB row, per call so
    # that concurrent calls never share it; the C entry zeroes it on the
    # stream
    sync = torch.empty(1 + planes * mb_h, dtype=torch.int32, device=y.device)
    name = "intra_luma" if top is None else "intra_luma_halo"
    _build.launch(name, _load().intra_luma, y.data_ptr(), ry.data_ptr(), params.data_ptr(),
                  _build.ptr(top), sync.data_ptr(), planes, mb_h, mb_w, mid, mx,
                  torch.cuda.current_stream(y.device).cuda_stream)


def intra_chroma(cb: torch.Tensor, cr: torch.Tensor, rcb: torch.Tensor,
                 rcr: torch.Tensor, params: torch.Tensor, mb_h: int, mb_w: int,
                 ch_h: int = 8, mid: int = 128, mx: int = 255, top=None) -> None:
    """Reconstruct the intra MBs of chroma planes cb/cr [mb_h * ch_h, Wc]
    int32 in place (one launch: a persistent row wavefront,
    csrc/wavefront.cuh). top: (cb_row, cr_row), the int32 [Wc] rows above
    MB row 0, or None (they read as 0). A hand-off between rows that stalls
    for seconds traps in the kernel; a trap is a sticky CUDA error, so every
    later CUDA call of the process fails."""
    _check_format(mid, mx, ch_h)
    Hc, Wc = ch_h * mb_h, 8 * mb_w
    for t, n in ((cb, "cb"), (cr, "cr"), (rcb, "resid_cb"), (rcr, "resid_cr")):
        _check(t, (Hc, Wc), n)
    _check(params, (mb_h * mb_w, NPARAM), "params")
    name = "intra_chroma" if top is None else "intra_chroma_halo"
    top = (None, None) if top is None else top
    for t, n in zip(top, ("top_cb", "top_cr")):
        if t is not None:
            _check(t, (Wc,), n)
    sync = torch.empty(mb_h + 1, dtype=torch.int32, device=cb.device)
    _build.launch(name, _load().intra_chroma, cb.data_ptr(), cr.data_ptr(),
                  rcb.data_ptr(), rcr.data_ptr(), params.data_ptr(), _build.ptr(top[0]),
                  _build.ptr(top[1]), sync.data_ptr(), mb_h, mb_w, ch_h, mid, mx,
                  torch.cuda.current_stream(cb.device).cuda_stream)


def intra_frame(y, cb, cr, resid_y, resid_cb, resid_cr, kind, modes4, i16mode,
                cmode, avl, avt, avtr, avtl, mb_h: int, mb_w: int, ch_h: int = 8,
                mid: int = 128, mx: int = 255, top=None):
    """Drop-in for kernels.intra.intra_wavefront: returns new int32
    (y, cb, cr) with every intra MB reconstructed; top: optional
    (y_row [W], cb_row [Wc], cr_row [Wc]), the row above MB row 0."""
    if not y.is_cuda:
        return intra_wavefront(y, cb, cr, resid_y, resid_cb, resid_cr, kind, modes4,
                               i16mode, cmode, avl, avt, avtr, avtl, mb_h, mb_w,
                               ch_h, mid, mx, top)
    i32 = torch.int32
    params = pack_params(kind, modes4, i16mode, cmode, avl, avt, avtr, avtl)
    y = y.to(i32, copy=True).contiguous()
    cb = cb.to(i32, copy=True).contiguous()
    cr = cr.to(i32, copy=True).contiguous()
    if top is not None:
        top = [t.to(i32).contiguous() for t in top]
    intra_luma(y, resid_y.to(i32).contiguous(), params, mb_h, mb_w, mid, mx,
               None if top is None else top[0])
    intra_chroma(cb, cr, resid_cb.to(i32).contiguous(), resid_cr.to(i32).contiguous(),
                 params, mb_h, mb_w, ch_h, mid, mx, None if top is None else top[1:])
    return y, cb, cr


def intra_planes_plain(planes, resid, kind, modes4, i16mode, avl, avt, avtr, avtl,
                       mb_h: int, mb_w: int) -> torch.Tensor:
    """The plain version of intra_planes: intra_wavefront once per plane
    with dummy 4:2:0 chroma and chroma mode 0, keeping its luma output, as
    the JAX package's 4:4:4 path computes it (tpu_pipeline.py:447-459)."""
    dummy = torch.zeros((8 * mb_h, 8 * mb_w), dtype=torch.int32, device=planes.device)
    cmode = torch.zeros_like(i16mode)
    return torch.stack([
        intra_wavefront(p, dummy, dummy, r, dummy, dummy, kind, modes4, i16mode, cmode,
                        avl, avt, avtr, avtl, mb_h, mb_w)[0]
        for p, r in zip(planes, resid)
    ])


def intra_planes(planes, resid, kind, modes4, i16mode, avl, avt, avtr, avtl,
                 mb_h: int, mb_w: int) -> torch.Tensor:
    """8-bit 4:4:4 intra (spec 8.3.4.5: Cb and Cr take the luma process with
    the MB's luma modes): planes and resid [3, H, W] (Y, Cb, Cr) -> new
    int32 [3, H, W] with every intra MB reconstructed. On a CUDA tensor, one
    launch of the luma kernel over the three planes."""
    if not planes.is_cuda:
        return intra_planes_plain(planes, resid, kind, modes4, i16mode, avl, avt, avtr, avtl,
                                  mb_h, mb_w)
    i32 = torch.int32
    params = pack_params(kind, modes4, i16mode, torch.zeros_like(i16mode), avl, avt, avtr,
                         avtl)
    out = planes.to(i32, copy=True).contiguous()
    intra_luma(out, resid.to(i32).contiguous(), params, mb_h, mb_w)
    return out
