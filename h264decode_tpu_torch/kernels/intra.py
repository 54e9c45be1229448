"""Intra prediction (spec 8.3): the plain torch version of the intra kernels.

Counterpart of h264decode_tpu/kernels/intra.py::intra_wavefront, and the
plain version that kernels/intra_cuda.py is held against. Intra prediction
is the one sequentially dependent stage of the pixel pipeline; macroblocks
on the 2:1 anti-diagonal d = mbx + 2*mby are independent (their left, top,
top-right and top-left neighbours lie on earlier diagonals), so the loop
walks the diagonals and, inside one step, the 16 z-order sub-blocks,
vectorised across every MB on the diagonal: gather neighbour strips ->
compute all prediction modes -> select -> add the residual -> scatter.

Inter and I_PCM macroblocks are pre-placed in the planes by the caller; only
intra MBs are written. Samples outside the picture read as 0 (the planes
are zero-padded), as in the JAX version. The format enters as the chroma MB
height ch_h (8 for 4:2:0, 16 for 4:2:2), the DC fallback mid = 1 << (bd-1)
and the Clip1 ceiling mx = (1 << bd) - 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tensors.frame_tensors import LUMA_BLK_XY

PAD = 8  # plane padding so neighbour gathers never go negative

_ZX = np.array([bx for bx, by in LUMA_BLK_XY])
_ZY = np.array([by for bx, by in LUMA_BLK_XY])
_ZIDX = np.zeros((4, 4), np.int64)
for _z, (_bx, _by) in enumerate(LUMA_BLK_XY):
    _ZIDX[_by, _bx] = _z

_YY4, _XX4 = np.mgrid[0:4, 0:4]
_YY8, _XX8 = np.mgrid[0:8, 0:8]

# MB kind codes
K_NONE, K_I4, K_I8, K_I16 = 0, 1, 2, 3

# is z-block (bx+1, by-1) decoded before z-block (bx, by)? (top-right
# availability inside the MB)
TR_DECODED = np.zeros(16, bool)
for _k, (_bx, _by) in enumerate(LUMA_BLK_XY):
    if _bx < 3 and _by > 0:
        TR_DECODED[_k] = _ZIDX[_by - 1, _bx + 1] < _k


def _g(v: torch.Tensor, idx) -> torch.Tensor:
    """v[:, idx] for a numpy index array (any shape)."""
    return v[:, torch.as_tensor(np.asarray(idx, np.int64), device=v.device)]


def _w(cond, a, b):
    """torch.where with a numpy/bool condition broadcast over the slots."""
    if isinstance(cond, np.ndarray):
        cond = torch.as_tensor(cond, device=a.device if torch.is_tensor(a) else b.device)
    return torch.where(cond, a, b)


def _c(v: torch.Tensor) -> torch.Tensor:
    """[s] -> [s, 1, 1] for broadcasting against per-pixel grids."""
    return v[:, None, None]


def _dc3(have_l, have_t, both, only_t, only_l, mid):
    return torch.where(
        have_l & have_t, both,
        torch.where(have_t, only_t, torch.where(have_l, only_l, torch.full_like(both, mid))),
    )


def intra4x4_modes(t, l, m, have_l, have_t, mid=128):
    """All nine spec 8.3.1.2 predictions. t: [s, 8] (top + top-right, already
    substituted), l: [s, 4], m: [s]. Returns [s, 9, 4, 4] int32."""
    s = t.shape[0]
    T = torch.cat([m[:, None], t], dim=1)  # T[0]=m, T[i]=t[i-1]
    L = torch.cat([m[:, None], l], dim=1)
    t9 = torch.cat([t, t[:, 7:8]], dim=1)
    y4, x4 = _YY4, _XX4
    p_v = t[:, None, 0:4].expand(s, 4, 4)
    p_h = l[:, :, None].expand(s, 4, 4)
    sum_t = t[:, :4].sum(1)
    sum_l = l.sum(1)
    dc = _dc3(have_l, have_t, (sum_t + sum_l + 4) >> 3, (sum_t + 2) >> 2,
              (sum_l + 2) >> 2, mid)
    p_dc = _c(dc).expand(s, 4, 4)
    K = x4 + y4
    p_ddl = (_g(t9, K) + 2 * _g(t9, K + 1) + _g(t9, np.minimum(K + 2, 8)) + 2) >> 2
    ku = np.clip(x4 - y4, 1, 3)
    kl = np.clip(y4 - x4, 1, 3)
    up = (_g(T, ku - 1) + 2 * _g(T, ku) + _g(T, ku + 1) + 2) >> 2
    lo = (_g(L, kl - 1) + 2 * _g(L, kl) + _g(L, kl + 1) + 2) >> 2
    diag = (T[:, 1] + 2 * T[:, 0] + L[:, 1] + 2) >> 2
    p_ddr = _w(x4 > y4, up, _w(x4 < y4, lo, _c(diag).expand(s, 4, 4)))
    # VR (8.3.1.2.6)
    zvr = 2 * x4 - y4
    kvc = np.clip(x4 - (y4 >> 1), 0, 3)
    even = (_g(T, kvc) + _g(T, kvc + 1) + 1) >> 1
    odd = (_g(T, np.clip(kvc - 1, 0, 3)) + 2 * _g(T, kvc) + _g(T, kvc + 1) + 2) >> 2
    vrm1 = (L[:, 1] + 2 * T[:, 0] + T[:, 1] + 2) >> 2
    klow = np.clip(y4 - 1, 0, 3)
    low = (_g(L, klow + 1) + 2 * _g(L, np.clip(klow, 0, 4))
           + _g(L, np.clip(klow - 1, 0, 4)) + 2) >> 2
    p_vr = _w((zvr >= 0) & (zvr % 2 == 0), even,
              _w(zvr >= 0, odd, _w(zvr == -1, _c(vrm1).expand(s, 4, 4), low)))
    # HD (8.3.1.2.7): mirror of VR
    zhd = 2 * y4 - x4
    khc = np.clip(y4 - (x4 >> 1), 0, 3)
    h_even = (_g(L, khc) + _g(L, khc + 1) + 1) >> 1
    h_odd = (_g(L, np.clip(khc - 1, 0, 3)) + 2 * _g(L, khc) + _g(L, khc + 1) + 2) >> 2
    hdm1 = (T[:, 1] + 2 * T[:, 0] + L[:, 1] + 2) >> 2
    kxl = np.clip(x4 - 1, 0, 3)
    h_low = (_g(T, kxl + 1) + 2 * _g(T, np.clip(kxl, 0, 4))
             + _g(T, np.clip(kxl - 1, 0, 4)) + 2) >> 2
    p_hd = _w((zhd >= 0) & (zhd % 2 == 0), h_even,
              _w(zhd >= 0, h_odd, _w(zhd == -1, _c(hdm1).expand(s, 4, 4), h_low)))
    # VL (8.3.1.2.8)
    kvl = x4 + (y4 >> 1)
    vl_even = (_g(t, kvl) + _g(t, kvl + 1) + 1) >> 1
    vl_odd = (_g(t, kvl) + 2 * _g(t, kvl + 1) + _g(t, np.minimum(kvl + 2, 7)) + 2) >> 2
    p_vl = _w(y4 % 2 == 0, vl_even, vl_odd)
    # HU (8.3.1.2.9)
    zhu = x4 + 2 * y4
    khu = np.clip(y4 + (x4 >> 1), 0, 3)
    hu_even = (_g(l, khu) + _g(l, np.minimum(khu + 1, 3)) + 1) >> 1
    hu_odd = (_g(l, khu) + 2 * _g(l, np.minimum(khu + 1, 3))
              + _g(l, np.minimum(khu + 2, 3)) + 2) >> 2
    hu5 = (l[:, 2] + 3 * l[:, 3] + 2) >> 2
    p_hu = _w(zhu > 5, _c(l[:, 3]).expand(s, 4, 4),
              _w(zhu == 5, _c(hu5).expand(s, 4, 4), _w(zhu % 2 == 0, hu_even, hu_odd)))
    return torch.stack([p_v, p_h, p_dc, p_ddl, p_ddr, p_vr, p_hd, p_vl, p_hu],
                       dim=1).to(torch.int32)


def intra8x8_modes(t16, l8, m, have_l, have_t, have_c, mid=128):
    """Spec 8.3.2: reference filtering + the nine 8x8 modes. t16: [s, 16]
    raw (substituted) top row, l8: [s, 8], m: [s]. Returns [s, 9, 8, 8]."""
    s = t16.shape[0]
    # ---- 8.3.2.2.1 reference filtering
    tl = torch.where(have_c, m, torch.zeros_like(m))
    t_m1 = torch.cat([tl[:, None], t16[:, :-1]], dim=1)
    t_p1 = torch.cat([t16[:, 1:], t16[:, 15:16]], dim=1)
    ft = (t_m1 + 2 * t16 + t_p1 + 2) >> 2
    ft0_noc = (3 * t16[:, 0] + t16[:, 1] + 2) >> 2
    ft = torch.cat([
        torch.where(have_c, ft[:, 0], ft0_noc)[:, None], ft[:, 1:15],
        ((t16[:, 14] + 3 * t16[:, 15] + 2) >> 2)[:, None],
    ], dim=1)
    l_m1 = torch.cat([tl[:, None], l8[:, :-1]], dim=1)
    l_p1 = torch.cat([l8[:, 1:], l8[:, 7:8]], dim=1)
    fl = (l_m1 + 2 * l8 + l_p1 + 2) >> 2
    fl0_noc = (3 * l8[:, 0] + l8[:, 1] + 2) >> 2
    fl = torch.cat([
        torch.where(have_c, fl[:, 0], fl0_noc)[:, None], fl[:, 1:7],
        ((l8[:, 6] + 3 * l8[:, 7] + 2) >> 2)[:, None],
    ], dim=1)
    fm = torch.where(
        have_l & have_t,
        (t16[:, 0] + 2 * m + l8[:, 0] + 2) >> 2,
        torch.where(
            have_t,
            (3 * m + t16[:, 0] + 2) >> 2,
            torch.where(have_l, (3 * m + l8[:, 0] + 2) >> 2, m),
        ),
    )
    t, l, mm = ft, fl, fm
    T = torch.cat([mm[:, None], t], dim=1)
    L = torch.cat([mm[:, None], l], dim=1)
    t17 = torch.cat([t, t[:, 15:16]], dim=1)
    y8, x8 = _YY8, _XX8

    p_v = t[:, None, 0:8].expand(s, 8, 8)
    p_h = l[:, :, None].expand(s, 8, 8)
    sum_t = t[:, :8].sum(1)
    sum_l = l.sum(1)
    dc = _dc3(have_l, have_t, (sum_t + sum_l + 8) >> 4, (sum_t + 4) >> 3,
              (sum_l + 4) >> 3, mid)
    p_dc = _c(dc).expand(s, 8, 8)
    K = x8 + y8
    p_ddl = (_g(t17, K) + 2 * _g(t17, K + 1) + _g(t17, np.minimum(K + 2, 16)) + 2) >> 2
    ku = np.clip(x8 - y8, 1, 7)
    kl = np.clip(y8 - x8, 1, 7)
    up = (_g(T, ku - 1) + 2 * _g(T, ku) + _g(T, ku + 1) + 2) >> 2
    lo = (_g(L, kl - 1) + 2 * _g(L, kl) + _g(L, kl + 1) + 2) >> 2
    diag = (T[:, 1] + 2 * T[:, 0] + L[:, 1] + 2) >> 2
    p_ddr = _w(x8 > y8, up, _w(x8 < y8, lo, _c(diag).expand(s, 8, 8)))
    zvr = 2 * x8 - y8
    kv = np.clip(x8 - (y8 >> 1), 0, 7)
    even = (_g(T, kv) + _g(T, kv + 1) + 1) >> 1
    odd = (_g(T, np.clip(kv - 1, 0, 7)) + 2 * _g(T, kv) + _g(T, kv + 1) + 2) >> 2
    vrm1 = (L[:, 1] + 2 * T[:, 0] + T[:, 1] + 2) >> 2
    # l[i] with the corner at i = -1 maps to L[i + 1]
    i1 = np.clip(y8 - 2 * x8, 0, 8)
    i2 = np.clip(y8 - 2 * x8 - 1, 0, 8)
    i3 = np.clip(y8 - 2 * x8 - 2, 0, 8)
    low = (_g(L, i1) + 2 * _g(L, i2) + _g(L, i3) + 2) >> 2
    p_vr = _w((zvr >= 0) & (zvr % 2 == 0), even,
              _w(zvr >= 0, odd, _w(zvr == -1, _c(vrm1).expand(s, 8, 8), low)))
    zhd = 2 * y8 - x8
    kh = np.clip(y8 - (x8 >> 1), 0, 7)
    h_even = (_g(L, kh) + _g(L, kh + 1) + 1) >> 1
    h_odd = (_g(L, np.clip(kh - 1, 0, 7)) + 2 * _g(L, kh) + _g(L, kh + 1) + 2) >> 2
    hdm1 = (T[:, 1] + 2 * T[:, 0] + L[:, 1] + 2) >> 2
    j1 = np.clip(x8 - 2 * y8, 0, 16)
    j2 = np.clip(x8 - 2 * y8 - 1, 0, 16)
    j3 = np.clip(x8 - 2 * y8 - 2, 0, 16)
    h_low = (_g(T, j1) + 2 * _g(T, j2) + _g(T, j3) + 2) >> 2
    p_hd = _w((zhd >= 0) & (zhd % 2 == 0), h_even,
              _w(zhd >= 0, h_odd, _w(zhd == -1, _c(hdm1).expand(s, 8, 8), h_low)))
    kvl = x8 + (y8 >> 1)
    vl_even = (_g(t, kvl) + _g(t, kvl + 1) + 1) >> 1
    vl_odd = (_g(t, kvl) + 2 * _g(t, kvl + 1) + _g(t, np.minimum(kvl + 2, 15)) + 2) >> 2
    p_vl = _w(y8 % 2 == 0, vl_even, vl_odd)
    zhu = x8 + 2 * y8
    khu = np.clip(y8 + (x8 >> 1), 0, 7)
    hu_even = (_g(l, khu) + _g(l, np.minimum(khu + 1, 7)) + 1) >> 1
    hu_odd = (_g(l, khu) + 2 * _g(l, np.minimum(khu + 1, 7))
              + _g(l, np.minimum(khu + 2, 7)) + 2) >> 2
    hu13 = (l[:, 6] + 3 * l[:, 7] + 2) >> 2
    p_hu = _w(zhu > 13, _c(l[:, 7]).expand(s, 8, 8),
              _w(zhu == 13, _c(hu13).expand(s, 8, 8), _w(zhu % 2 == 0, hu_even, hu_odd)))
    return torch.stack([p_v, p_h, p_dc, p_ddl, p_ddr, p_vr, p_hd, p_vl, p_hu],
                       dim=1).to(torch.int32)


def intra16_modes(t16, l16, m, have_l, have_t, mid=128, mx=255):
    """Spec 8.3.3: V/H/DC/Plane. t16/l16: [s, 16], m: [s]. [s, 4, 16, 16]."""
    s = t16.shape[0]
    dev = t16.device
    yy = torch.arange(16, device=dev)[:, None]
    xx = torch.arange(16, device=dev)[None, :]
    p_v = t16[:, None, :].expand(s, 16, 16)
    p_h = l16[:, :, None].expand(s, 16, 16)
    sum_t = t16.sum(1)
    sum_l = l16.sum(1)
    dc = _dc3(have_l, have_t, (sum_t + sum_l + 16) >> 5, (sum_t + 8) >> 4,
              (sum_l + 8) >> 4, mid)
    p_dc = _c(dc).expand(s, 16, 16)
    T = torch.cat([m[:, None], t16], dim=1)  # T[0]=m, T[i]=t[i-1]
    L = torch.cat([m[:, None], l16], dim=1)
    ks = np.arange(8)
    w = torch.arange(1, 9, device=dev, dtype=torch.int32)[None, :]
    hsum = (w * (_g(T, 9 + ks) - _g(T, 7 - ks))).sum(1)
    vsum = (w * (_g(L, 9 + ks) - _g(L, 7 - ks))).sum(1)
    a = 16 * (l16[:, 15] + t16[:, 15])
    b = (5 * hsum + 32) >> 6
    c = (5 * vsum + 32) >> 6
    plane = torch.clamp((_c(a) + _c(b) * (xx - 7) + _c(c) * (yy - 7) + 16) >> 5, 0, mx)
    return torch.stack([p_v, p_h, p_dc, plane], dim=1).to(torch.int32)


def chroma_modes(t8, l8, m, have_l, have_t, mid=128, mx=255):
    """Spec 8.3.4 (4:2:0): DC (quadrant rules)/H/V/Plane. [s, 4, 8, 8]."""
    s = t8.shape[0]
    dev = t8.device
    yy = torch.arange(8, device=dev)[:, None]
    xx = torch.arange(8, device=dev)[None, :]
    sum_t = [t8[:, i * 4 : i * 4 + 4].sum(1) for i in range(2)]
    sum_l = [l8[:, i * 4 : i * 4 + 4].sum(1) for i in range(2)]

    def dc_q(tq, lq, prefer):
        both = (sum_t[tq] + sum_l[lq] + 4) >> 3
        only_t = (sum_t[tq] + 2) >> 2
        only_l = (sum_l[lq] + 2) >> 2
        mid_t = torch.full_like(both, mid)
        if prefer == "both":
            return _dc3(have_l, have_t, both, only_t, only_l, mid)
        if prefer == "t":
            return torch.where(have_t, only_t, torch.where(have_l, only_l, mid_t))
        return torch.where(have_l, only_l, torch.where(have_t, only_t, mid_t))

    q00 = dc_q(0, 0, "both")
    q10 = dc_q(1, 0, "t")  # top-right quadrant
    q01 = dc_q(0, 1, "l")  # bottom-left
    q11 = dc_q(1, 1, "both")
    left = xx < 4
    top = torch.where(left, _c(q00), _c(q10))
    bot = torch.where(left, _c(q01), _c(q11))
    p_dc = torch.where(yy < 4, top, bot)
    p_h = l8[:, :, None].expand(s, 8, 8)
    p_v = t8[:, None, :].expand(s, 8, 8)
    T = torch.cat([m[:, None], t8], dim=1)
    L = torch.cat([m[:, None], l8], dim=1)
    ks = np.arange(4)
    w = torch.arange(1, 5, device=dev, dtype=torch.int32)[None, :]
    hsum = (w * (_g(T, 5 + ks) - _g(T, 3 - ks))).sum(1)
    vsum = (w * (_g(L, 5 + ks) - _g(L, 3 - ks))).sum(1)
    a = 16 * (l8[:, 7] + t8[:, 7])
    b = (34 * hsum + 32) >> 6
    c = (34 * vsum + 32) >> 6
    plane = torch.clamp((_c(a) + _c(b) * (xx - 3) + _c(c) * (yy - 3) + 16) >> 5, 0, mx)
    return torch.stack([p_dc, p_h, p_v, plane], dim=1).to(torch.int32)


def chroma_modes_422(t8, l16, m, have_l, have_t, mid=128, mx=255):
    """Spec 8.3.4 (4:2:2): DC per 4x4 block of the 8x16 component, H/V, and
    the plane with yCF = 4. t8: [s, 8] top row, l16: [s, 16] left column.
    Returns [s, 4, 16, 8]."""
    s = t8.shape[0]
    dev = t8.device
    yy = torch.arange(16, device=dev)[:, None]
    xx = torch.arange(8, device=dev)[None, :]
    sum_t = [t8[:, i * 4 : i * 4 + 4].sum(1) for i in range(2)]
    sum_l = [l16[:, i * 4 : i * 4 + 4].sum(1) for i in range(4)]
    p_dc = torch.zeros((s, 16, 8), dtype=torch.int32, device=dev)
    for by in range(4):
        for bx in range(2):
            both = (sum_t[bx] + sum_l[by] + 4) >> 3
            only_t = (sum_t[bx] + 2) >> 2
            only_l = (sum_l[by] + 2) >> 2
            mid_t = torch.full_like(both, mid)
            if (bx == 0) == (by == 0):  # the corner block and the inner ones
                dc = _dc3(have_l, have_t, both, only_t, only_l, mid)
            elif bx > 0:  # top row, right block: prefer top
                dc = torch.where(have_t, only_t, torch.where(have_l, only_l, mid_t))
            else:  # left column, lower blocks: prefer left
                dc = torch.where(have_l, only_l, torch.where(have_t, only_t, mid_t))
            sel = (yy // 4 == by) & (xx // 4 == bx)
            p_dc = torch.where(sel, _c(dc), p_dc)
    p_h = l16[:, :, None].expand(s, 16, 8)
    p_v = t8[:, None, :].expand(s, 16, 8)
    T = torch.cat([m[:, None], t8], dim=1)
    L = torch.cat([m[:, None], l16], dim=1)
    ks, ks8 = np.arange(4), np.arange(8)
    w4 = torch.arange(1, 5, device=dev, dtype=torch.int32)[None, :]
    w8 = torch.arange(1, 9, device=dev, dtype=torch.int32)[None, :]
    hsum = (w4 * (_g(T, 5 + ks) - _g(T, 3 - ks))).sum(1)
    vsum = (w8 * (_g(L, 9 + ks8) - _g(L, 7 - ks8))).sum(1)
    a = 16 * (l16[:, 15] + t8[:, 7])
    b = (34 * hsum + 32) >> 6
    c = (5 * vsum + 32) >> 6  # (34 - 29 * (ChromaArrayType == 2)) at yCF = 4
    plane = torch.clamp((_c(a) + _c(b) * (xx - 3) + _c(c) * (yy - 7) + 16) >> 5, 0, mx)
    return torch.stack([p_dc, p_h, p_v, plane], dim=1).to(torch.int32)


def intra_wavefront(
    y, cb, cr,  # [H, W]/[Hc, Wc] int32 planes with inter+PCM content placed
    resid_y, resid_cb, resid_cr,  # int32 residual planes (all MBs)
    kind,  # [nMB] int32: K_NONE/K_I4/K_I8/K_I16
    modes4,  # [nMB, 16] int32 z-order (also holds 8x8 modes in [:, :4])
    i16mode,  # [nMB] int32
    cmode,  # [nMB] int32
    avl, avt, avtr, avtl,  # [nMB] bool: MB-level intra availability
    mb_h: int,
    mb_w: int,
    ch_h: int = 8,  # chroma MB height in samples: 8 (4:2:0) / 16 (4:2:2)
    mid: int = 128,  # DC fallback = 1 << (BitDepth - 1)
    mx: int = 255,  # Clip1 ceiling = (1 << BitDepth) - 1
    top=None,  # optional (y_row [W], cb_row [Wc], cr_row [Wc]): the row above
    #            MB row 0 (row-band sharding: the band above's unfiltered
    #            bottom row); without it, that row reads as 0
):
    """Runs the anti-diagonal intra wavefront; returns new int32 (y, cb, cr)."""
    dev = y.device
    i32 = torch.int32
    H, W = mb_h * 16, mb_w * 16
    Hc, Wc = mb_h * ch_h, mb_w * 8
    # pad: PAD top/left/right, bottom PAD + a scratch strip that inactive
    # slots gather from and scatter back into
    yp = torch.zeros((H + 2 * PAD + 16, W + 2 * PAD), dtype=i32, device=dev)
    yp[PAD : PAD + H, PAD : PAD + W] = y
    cbp = torch.zeros((Hc + 2 * PAD + ch_h, Wc + 2 * PAD), dtype=i32, device=dev)
    cbp[PAD : PAD + Hc, PAD : PAD + Wc] = cb
    crp = torch.zeros_like(cbp)
    crp[PAD : PAD + Hc, PAD : PAD + Wc] = cr
    if top is not None:  # seeded as padding row PAD - 1, as in the JAX version
        yp[PAD - 1, PAD : PAD + W] = top[0]
        cbp[PAD - 1, PAD : PAD + Wc] = top[1]
        crp[PAD - 1, PAD : PAD + Wc] = top[2]
    rpy = torch.zeros((H + 16, W), dtype=i32, device=dev)
    rpy[:H] = resid_y
    rpc = []
    for r in (resid_cb, resid_cr):
        t = torch.zeros((Hc + ch_h, Wc), dtype=i32, device=dev)
        t[:Hc] = r
        rpc.append(t)
    kind_g = kind.to(i32).reshape(mb_h, mb_w)
    modes4_g = modes4.to(i32).reshape(mb_h, mb_w, 16)
    i16_g = i16mode.to(i32).reshape(mb_h, mb_w)
    cm_g = cmode.to(i32).reshape(mb_h, mb_w)
    fl_g = torch.stack([a.reshape(mb_h, mb_w).bool() for a in (avl, avt, avtr, avtl)])
    mbys = torch.arange(mb_h, device=dev)
    sl = torch.arange(mb_h, device=dev)
    scr_y = PAD + H
    scr_c = PAD + Hc
    true = torch.ones(mb_h, dtype=torch.bool, device=dev)

    def rng(n):
        return torch.arange(n, device=dev)

    def gather_row(plane, r, c0, n):
        return plane[r[:, None], c0[:, None] + rng(n)[None, :]]

    def gather_col(plane, r0, c, n):
        return plane[r0[:, None] + rng(n)[None, :], c[:, None]]

    def patch_idx(r0, c0, h, w):
        return (r0[:, None, None] + rng(h)[None, :, None],
                c0[:, None, None] + rng(w)[None, None, :])

    def where_s(cond, a, b):  # per-slot scalar select
        return torch.where(cond, a, torch.full_like(a, b) if not torch.is_tensor(b) else b)

    # walk only the diagonals that contain intra MBs (one host read)
    d_grid = rng(mb_w)[None, :] + 2 * rng(mb_h)[:, None]
    has = kind_g > 0
    lo = int(torch.where(has, d_grid, mb_w + 2 * mb_h).min())
    hi = int(torch.where(has, d_grid, -1).max()) + 1
    for d in range(lo, hi):
        mbxs = d - 2 * mbys
        in_pic = (mbxs >= 0) & (mbxs < mb_w)
        mbx = torch.clamp(mbxs, 0, mb_w - 1)
        k_mb = torch.where(in_pic, kind_g[mbys, mbx], torch.zeros_like(mbys, dtype=i32))
        m4 = modes4_g[mbys, mbx]  # [s, 16]
        mavl = fl_g[0, mbys, mbx] & in_pic
        mavt = fl_g[1, mbys, mbx] & in_pic
        mavtr = fl_g[2, mbys, mbx] & in_pic
        mavtl = fl_g[3, mbys, mbx] & in_pic

        # ---- Intra16x16 (whole MB)
        act16 = k_mb == K_I16
        ty = where_s(act16, mbys * 16 + PAD, scr_y)
        tx = where_s(act16, mbx * 16 + PAD, 0)
        t16 = gather_row(yp, ty - 1, tx, 16)
        l16 = gather_col(yp, ty, tx - 1, 16)
        m = yp[ty - 1, tx - 1]
        preds = intra16_modes(t16, l16, m, mavl, mavt, mid, mx)
        pred = preds[sl, torch.clamp(i16_g[mbys, mbx], 0, 3).long()]
        res = rpy[patch_idx(where_s(act16, mbys * 16, 0), where_s(act16, mbx * 16, 0), 16, 16)]
        pi = patch_idx(ty, tx, 16, 16)
        yp[pi] = torch.where(_c(act16), torch.clamp(pred + res, 0, mx), yp[pi])

        # ---- chroma for every intra MB (MB-level dependencies only)
        actc = k_mb != K_NONE
        cm_fn = chroma_modes if ch_h == 8 else chroma_modes_422
        for plane, resid in ((cbp, rpc[0]), (crp, rpc[1])):
            cy = where_s(actc, mbys * ch_h + PAD, scr_c)
            cx = where_s(actc, mbx * 8 + PAD, 0)
            t8c = gather_row(plane, cy - 1, cx, 8)
            lc = gather_col(plane, cy, cx - 1, ch_h)
            mc = plane[cy - 1, cx - 1]
            cpreds = cm_fn(t8c, lc, mc, mavl, mavt, mid, mx)
            cpred = cpreds[sl, torch.clamp(cm_g[mbys, mbx], 0, 3).long()]
            cres = resid[patch_idx(where_s(actc, mbys * ch_h, 0), where_s(actc, mbx * 8, 0),
                                   ch_h, 8)]
            ci = patch_idx(cy, cx, ch_h, 8)
            plane[ci] = torch.where(_c(actc), torch.clamp(cpred + cres, 0, mx), plane[ci])

        # ---- 16 sequential sub-steps: 4x4 (every k) and 8x8 (k % 4 == 0)
        act4 = k_mb == K_I4
        act8 = k_mb == K_I8
        for k in range(16):
            bx, by = int(_ZX[k]), int(_ZY[k])
            gy = where_s(act4, mbys * 16 + by * 4 + PAD, scr_y)
            gx = where_s(act4, mbx * 16 + bx * 4 + PAD, 0)
            t8 = gather_row(yp, gy - 1, gx, 8)
            l4 = gather_col(yp, gy, gx - 1, 4)
            mm = yp[gy - 1, gx - 1]
            have_l = true if bx > 0 else mavl
            have_t = true if by > 0 else mavt
            if by > 0:
                have_tr = true if TR_DECODED[k] else ~true
            elif bx < 3:
                have_tr = mavt
            else:
                have_tr = mavtr
            t8 = torch.cat(
                [t8[:, :4], torch.where(have_tr[:, None], t8[:, 4:], t8[:, 3:4])], dim=1
            )
            preds = intra4x4_modes(t8, l4, mm, have_l, have_t, mid)
            pred = preds[sl, torch.clamp(m4[:, k], 0, 8).long()]
            res = rpy[patch_idx(where_s(act4, mbys * 16 + by * 4, 0),
                                where_s(act4, mbx * 16 + bx * 4, 0), 4, 4)]
            pi = patch_idx(gy, gx, 4, 4)
            yp[pi] = torch.where(_c(act4), torch.clamp(pred + res, 0, mx), yp[pi])

            if k % 4 == 0:
                b8 = k // 4
                bx8, by8 = b8 % 2, b8 // 2
                gy = where_s(act8, mbys * 16 + by8 * 8 + PAD, scr_y)
                gx = where_s(act8, mbx * 16 + bx8 * 8 + PAD, 0)
                t16b = gather_row(yp, gy - 1, gx, 16)
                l8b = gather_col(yp, gy, gx - 1, 8)
                mm = yp[gy - 1, gx - 1]
                have_l = true if bx8 > 0 else mavl
                have_t = true if by8 > 0 else mavt
                if by8 == 0:
                    have_tr = mavt if bx8 == 0 else mavtr
                else:
                    have_tr = true if bx8 == 0 else ~true
                have_c = (mavtl, mavt, mavl, true)[b8]
                t16b = torch.cat(
                    [t16b[:, :8], torch.where(have_tr[:, None], t16b[:, 8:], t16b[:, 7:8])],
                    dim=1,
                )
                preds = intra8x8_modes(t16b, l8b, mm, have_l, have_t, have_c, mid)
                pred = preds[sl, torch.clamp(m4[:, b8], 0, 8).long()]
                res = rpy[patch_idx(where_s(act8, mbys * 16 + by8 * 8, 0),
                                    where_s(act8, mbx * 16 + bx8 * 8, 0), 8, 8)]
                pi = patch_idx(gy, gx, 8, 8)
                yp[pi] = torch.where(_c(act8), torch.clamp(pred + res, 0, mx), yp[pi])
    return (
        yp[PAD : PAD + H, PAD : PAD + W].contiguous(),
        cbp[PAD : PAD + Hc, PAD : PAD + Wc].contiguous(),
        crp[PAD : PAD + Hc, PAD : PAD + Wc].contiguous(),
    )
