"""In-loop deblocking (spec 8.7): the plain torch version of the deblock kernels.

Counterpart of h264decode_tpu/kernels/deblock.py::deblock_frame_tpu, and the
plain version that kernels/deblock_cuda.py is held against. The spec's
raster MB order carries dependencies only through the 3-pixel strips each
MB writes into its left and top neighbours, so MBs on the 2:1 anti-diagonal
d = mbx + 2*mby have disjoint footprints. The loop walks the diagonals; each
step gathers a 20x20 luma (12 wide, 4 + ch_h high chroma) patch per MB slot,
applies the MB's 4 vertical then 4 horizontal luma edges in spec order,
vectorised across slots and lines, and scatters the patches back. Chroma
vertical edges ride luma edges 0 and 2; horizontal ones luma edges 0 and 2
for 4:2:0 (ch_h 8), and all four for 4:2:2 (ch_h 16: chroma rows 0, 4, 8,
12, with bS from bs_hc). At bit depth bd, alpha, beta and tC0 scale by
bd_scale = 1 << (bd - 8) (8.7.2.2) and samples clip at mx = (1 << bd) - 1.

Edge parameters come per 4x4 cell edge from kernels/deblock_prep_dev.py.
bS is 0 on picture-boundary edges there, so the zero padding is never
filtered against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..entropy.deblock_tables import ALPHA, BETA, TC0

ALPHA_T = np.asarray(ALPHA, np.int32)
BETA_T = np.asarray(BETA, np.int32)
TC0_T = np.asarray(TC0, np.int32)

LPAD = 4  # patch margin


def _tabs(dev):
    return (torch.as_tensor(ALPHA_T, device=dev), torch.as_tensor(BETA_T, device=dev),
            torch.as_tensor(TC0_T, device=dev))


def filter_luma(p, q, bs, index_a, index_b, tabs, bd_scale=1, mx=255):
    """Spec 8.7.2.3/8.7.2.4. p/q: lists of 4 int32 tensors (p[k] = p_k);
    bs/index_a/index_b broadcastable to p[0]. Returns new (p, q) lists."""
    alpha_t, beta_t, tc0_t = tabs
    ia, ib = index_a.long(), index_b.long()
    alpha = alpha_t[ia] * bd_scale
    beta = beta_t[ib] * bd_scale
    p0, p1, p2, p3 = p
    q0, q1, q2, q3 = q
    filt = (bs > 0) & ((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta) & (
        (q1 - q0).abs() < beta
    )
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta
    tc0 = tc0_t[ia, (torch.clamp(bs, 1, 3) - 1).long()] * bd_scale
    tc = tc0 + ap.to(torch.int32) + aq.to(torch.int32)
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_w = torch.clamp(p0 + delta, 0, mx)
    q0_w = torch.clamp(q0 - delta, 0, mx)
    avg = (p0 + q0 + 1) >> 1
    p1_w = p1 + torch.clamp((p2 + avg - 2 * p1) >> 1, -tc0, tc0)
    q1_w = q1 + torch.clamp((q2 + avg - 2 * q1) >> 1, -tc0, tc0)
    strong = (p0 - q0).abs() < ((alpha >> 2) + 2)
    sp = ap & strong
    p0_s = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                       (2 * p1 + p0 + q1 + 2) >> 2)
    p1_s = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2_s = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq = aq & strong
    q0_s = torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                       (2 * q1 + q0 + p1 + 2) >> 2)
    q1_s = torch.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2_s = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    is4 = bs == 4
    new_p0 = torch.where(filt, torch.where(is4, p0_s, p0_w), p0)
    new_q0 = torch.where(filt, torch.where(is4, q0_s, q0_w), q0)
    new_p1 = torch.where(filt & ap, torch.where(is4, p1_s, p1_w),
                         torch.where(filt & is4, p1_s, p1))
    new_q1 = torch.where(filt & aq, torch.where(is4, q1_s, q1_w),
                         torch.where(filt & is4, q1_s, q1))
    new_p2 = torch.where(filt & is4, p2_s, p2)
    new_q2 = torch.where(filt & is4, q2_s, q2)
    return [new_p0, new_p1, new_p2, p3], [new_q0, new_q1, new_q2, q3]


def filter_chroma(p, q, bs, index_a, index_b, tabs, bd_scale=1, mx=255):
    """Chroma (ChromaArrayType 1 and 2): p/q lists of 2 tensors. tC =
    tC0 * bd_scale + 1, and bS = 4 changes p0/q0 only."""
    alpha_t, beta_t, tc0_t = tabs
    ia, ib = index_a.long(), index_b.long()
    alpha = alpha_t[ia] * bd_scale
    beta = beta_t[ib] * bd_scale
    p0, p1 = p
    q0, q1 = q
    filt = (bs > 0) & ((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta) & (
        (q1 - q0).abs() < beta
    )
    tc = tc0_t[ia, (torch.clamp(bs, 1, 3) - 1).long()] * bd_scale + 1
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_w = torch.clamp(p0 + delta, 0, mx)
    q0_w = torch.clamp(q0 - delta, 0, mx)
    p0_s = (2 * p1 + p0 + q1 + 2) >> 2
    q0_s = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    new_p0 = torch.where(filt, torch.where(is4, p0_s, p0_w), p0)
    new_q0 = torch.where(filt, torch.where(is4, q0_s, q0_w), q0)
    return [new_p0, p1], [new_q0, q1]


def deblock_frame(y, cb, cr, prep: dict, mb_h: int, mb_w: int, ch_h: int = 8,
                  bd_scale: int = 1, mx: int = 255, halo=None):
    """y [H, W], cb/cr [mb_h * ch_h, Wc] integer planes -> filtered planes
    in y's dtype (the port's sample dtype: uint8 at 8 bits, int16 above).
    ch_h: chroma MB height, 8 (4:2:0) or 16 (4:2:2, which reads prep's
    bs_hc); bd_scale = 1 << (bd - 8); mx = (1 << bd) - 1.

    halo: optional (hy [4, W], hcb [4, Wc], hcr [4, Wc]), the filtered
    bottom rows of the band above (row-band sharding). They seed the top
    padding, so MB row 0's top edges filter across the band boundary where
    prep's bS says so, and the function then returns ((y, cb, cr), halo'),
    halo' being those rows as the top edges left them (up to 3 luma rows
    and 1 chroma row change), for the caller to paste back."""
    dev = y.device
    i32 = torch.int32
    tabs = _tabs(dev)
    H, W = mb_h * 16, mb_w * 16
    Hc, Wc = mb_h * ch_h, mb_w * 8
    cf2 = ch_h == 16
    # bottom scratch strip: inactive wavefront slots gather/scatter there
    yp = torch.zeros((LPAD + H + 24, LPAD + W), dtype=i32, device=dev)
    yp[LPAD : LPAD + H, LPAD:] = y
    cps = []
    for c in (cb, cr):
        t = torch.zeros((LPAD + Hc + ch_h + 8, LPAD + Wc), dtype=i32, device=dev)
        t[LPAD : LPAD + Hc, LPAD:] = c
        cps.append(t)
    if halo is not None:
        yp[:LPAD, LPAD:] = halo[0]
        cps[0][:LPAD, LPAD:] = halo[1]
        cps[1][:LPAD, LPAD:] = halo[2]
    bs_v, bs_h = prep["bs_v"], prep["bs_h"]
    bs_hc = prep["bs_hc"] if cf2 else bs_h
    ia_v, ib_v, ia_h, ib_h = prep["ia_v"], prep["ib_v"], prep["ia_h"], prep["ib_h"]
    ca_v, cb_v, ca_h, cb_h = prep["ca_v"], prep["cb_v"], prep["ca_h"], prep["cb_h"]

    mbys = torch.arange(mb_h, device=dev)
    a20 = torch.arange(20, device=dev)
    a_ch = torch.arange(LPAD + ch_h, device=dev)
    a12 = torch.arange(12, device=dev)
    a4 = torch.arange(4, device=dev)
    n_diag = mb_w + 2 * mb_h - 1
    # only walk diagonals whose MBs have a nonzero-strength edge (an MB whose
    # bS are all 0 is an identity write, so skipping it is exact)
    cell_any = (bs_v > 0) | (bs_h > 0) | (bs_hc > 0)
    mb_any = cell_any.reshape(mb_h, 4, mb_w, 4).any(3).any(1)
    d_grid = torch.arange(mb_w, device=dev)[None, :] + 2 * mbys[:, None]
    lo = int(torch.where(mb_any, d_grid, n_diag).min())
    hi = int(torch.where(mb_any, d_grid, -1).max()) + 1
    for d in range(lo, hi):
        mbxs = d - 2 * mbys
        valid = (mbxs >= 0) & (mbxs < mb_w)
        mbx = torch.clamp(mbxs, 0, mb_w - 1)
        ly0 = torch.where(valid, mbys * 16, torch.full_like(mbys, LPAD + H))
        lx0 = torch.where(valid, mbx * 16, torch.zeros_like(mbx))
        ry = ly0[:, None, None] + a20[None, :, None]
        rx = lx0[:, None, None] + a20[None, None, :]
        patch = yp[ry, rx].clone()  # [s, 20, 20]
        cy0 = torch.where(valid, mbys * ch_h, torch.full_like(mbys, LPAD + Hc))
        cx0 = torch.where(valid, mbx * 8, torch.zeros_like(mbx))
        cry = cy0[:, None, None] + a_ch[None, :, None]
        crx = cx0[:, None, None] + a12[None, None, :]
        cpatch = [c[cry, crx].clone() for c in cps]  # [s, 4 + ch_h, 12] each
        c4y = mbys[:, None] * 4 + a4[None, :]  # [s, 4]
        c4x = mbx[:, None] * 4 + a4[None, :]

        # ---- vertical edges e = 0..3 at local X = LPAD + 4e
        for e in range(4):
            X = LPAD + 4 * e
            cell = (c4y, c4x[:, e : e + 1])
            bs_l = bs_v[cell].repeat_interleave(4, 1)  # [s, 16] per line
            ia = ia_v[cell].repeat_interleave(4, 1)
            ib = ib_v[cell].repeat_interleave(4, 1)
            rows = patch[:, LPAD:, :]
            p, q = filter_luma([rows[:, :, X - 1 - k] for k in range(4)],
                               [rows[:, :, X + k] for k in range(4)], bs_l, ia, ib, tabs,
                               bd_scale, mx)
            for k in range(3):
                patch[:, LPAD:, X - 1 - k] = p[k]
                patch[:, LPAD:, X + k] = q[k]
            if e in (0, 2):  # chroma line j uses luma cell row j // (ch_h / 4)
                CX = LPAD + 2 * e
                rep = ch_h // 4
                cbs = bs_v[cell].repeat_interleave(rep, 1)  # [s, ch_h]
                for comp in range(2):
                    cia = ca_v[comp][cell].repeat_interleave(rep, 1)
                    cib = cb_v[comp][cell].repeat_interleave(rep, 1)
                    crows = cpatch[comp][:, LPAD:, :]
                    p, q = filter_chroma([crows[:, :, CX - 1], crows[:, :, CX - 2]],
                                         [crows[:, :, CX], crows[:, :, CX + 1]],
                                         cbs, cia, cib, tabs, bd_scale, mx)
                    cpatch[comp][:, LPAD:, CX - 1] = p[0]
                    cpatch[comp][:, LPAD:, CX] = q[0]

        # ---- horizontal edges at local Y = LPAD + 4e
        for e in range(4):
            Y = LPAD + 4 * e
            cell = (c4y[:, e : e + 1], c4x)
            bs_l = bs_h[cell].repeat_interleave(4, 1)
            ia = ia_h[cell].repeat_interleave(4, 1)
            ib = ib_h[cell].repeat_interleave(4, 1)
            cols = patch[:, :, LPAD:]
            p, q = filter_luma([cols[:, Y - 1 - k, :] for k in range(4)],
                               [cols[:, Y + k, :] for k in range(4)], bs_l, ia, ib, tabs,
                               bd_scale, mx)
            for k in range(3):
                patch[:, Y - 1 - k, LPAD:] = p[k]
                patch[:, Y + k, LPAD:] = q[k]
            # 4:2:2 chroma has a transform edge every 4 chroma rows, so all
            # four luma edge rows carry one (chroma row 4e); 4:2:0 only 0, 2
            if cf2 or e in (0, 2):
                CY = LPAD + (ch_h // 4) * e
                cbs = bs_hc[cell].repeat_interleave(2, 1)
                for comp in range(2):
                    cia = ca_h[comp][cell].repeat_interleave(2, 1)
                    cib = cb_h[comp][cell].repeat_interleave(2, 1)
                    ccols = cpatch[comp][:, :, LPAD : LPAD + 8]
                    p, q = filter_chroma([ccols[:, CY - 1, :], ccols[:, CY - 2, :]],
                                         [ccols[:, CY, :], ccols[:, CY + 1, :]],
                                         cbs, cia, cib, tabs, bd_scale, mx)
                    cpatch[comp][:, CY - 1, LPAD : LPAD + 8] = p[0]
                    cpatch[comp][:, CY, LPAD : LPAD + 8] = q[0]

        # ---- scatter back (inactive slots rewrite the scratch strip as read)
        v = valid[:, None, None]
        yp[ry, rx] = torch.where(v, patch, yp[ry, rx])
        for c, cp in zip(cps, cpatch):
            c[cry, crx] = torch.where(v, cp, c[cry, crx])
    odt = y.dtype
    out = (
        yp[LPAD : LPAD + H, LPAD:].to(odt),
        cps[0][LPAD : LPAD + Hc, LPAD:].to(odt),
        cps[1][LPAD : LPAD + Hc, LPAD:].to(odt),
    )
    if halo is None:
        return out
    return out, tuple(p[:LPAD, LPAD:].to(odt) for p in (yp, *cps))
