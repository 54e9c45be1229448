"""In-loop deblocking filter, spec 8.7 — numpy oracle (frame, 4:2:0).

MBs are processed in raster order; for each MB all vertical edges are
filtered left-to-right, then all horizontal edges top-to-bottom, in place —
exactly the spec ordering the TPU kernel (kernels/deblock.py) restructures
into separable column/row passes.
"""

from __future__ import annotations

import numpy as np

from ..entropy.deblock_tables import ALPHA, BETA, TC0
from ..syntax.pps import PPS
from ..syntax.sps import SPS
from ..tensors.frame_tensors import MB_P, MB_SI, FrameTensors
from .reference_recon import chroma_qp

_ALPHA = np.asarray(ALPHA, np.int32)
_BETA = np.asarray(BETA, np.int32)
_TC0 = np.asarray(TC0, np.int32)  # [52][3]

# bit-depth scaling of the threshold tables + the sample clip ceiling
# (spec 8.7.2.2: alpha/beta/tc0 scale by 1 << (BitDepth - 8)). Set by
# deblock_frame per picture; thread-local because the per-edge filter
# helpers are called from deep per-MB loops and two Decoder instances may
# deblock streams of different bit depths on different threads.
import threading as _threading


class _BdState(_threading.local):
    def __init__(self):
        self.scale = 1
        self.maxval = 255


_BD = _BdState()


def _is_intra(cls: int) -> bool:
    return cls < MB_P or cls == MB_SI


def _bs_internal_intra() -> int:
    return 3


def _mv_bs(ft: FrameTensors, addr_p, blk_p, addr_q, blk_q, thresh_y: int = 4) -> int:
    """bS 0/1 derivation from motion data, spec 8.7.2.1: different reference
    PICTURES (not indices), different vector count, or any component
    differing by >= 4 quarter-pel units (vertical: >= thresh_y — 2 for
    field-coded MBs whose MVs are in quarter FIELD units). Handles uni- and
    bi-prediction."""

    def sides(addr, blk):
        part = (blk // 8) * 2 + (blk % 4) // 2
        used = []
        for lst in range(2):
            if ft.ref_pic[addr, lst, part] >= 0:
                used.append(
                    (
                        # reference identity = (picture uid, field parity):
                        # two field MBs referencing different fields of the
                        # same frame use different reference pictures
                        (
                            int(ft.ref_pic[addr, lst, part]),
                            int(ft.ref_parity[addr, lst, part]),
                        ),
                        int(ft.mv[addr, lst, blk, 0]),
                        int(ft.mv[addr, lst, blk, 1]),
                    )
                )
        return used

    p = sides(addr_p, blk_p)
    q = sides(addr_q, blk_q)
    if len(p) != len(q):
        return 1
    if {r for r, _, _ in p} != {r for r, _, _ in q}:
        return 1

    def mv_far(a, b):
        return abs(a[1] - b[1]) >= 4 or abs(a[2] - b[2]) >= thresh_y

    if len(p) == 1:
        return 1 if mv_far(p[0], q[0]) else 0
    # bi-pred: match vectors by reference picture (8.7.2.1); when both refs
    # are the same picture, bS=1 only if BOTH pairings exceed the threshold
    if p[0][0] == p[1][0]:
        straight = not mv_far(p[0], q[0]) and not mv_far(p[1], q[1])
        crossed = not mv_far(p[0], q[1]) and not mv_far(p[1], q[0])
        return 0 if (straight or crossed) else 1
    q_by_ref = {q[0][0]: q[0], q[1][0]: q[1]}
    for side in p:
        if mv_far(side, q_by_ref[side[0]]):
            return 1
    return 0


def _cell_coded(ft: FrameTensors, addr: int, cx: int, cy: int) -> bool:
    """Nonzero-coefficient status of the 4x4 cell for bS (spec 8.7.2.1).
    Under an 8x8 transform a 4x4 cell counts as coded if its covering 8x8
    block has any nonzero coefficient."""
    if not ft.transform_8x8[addr]:
        return bool(ft.luma_nnz[cy, cx])
    x8, y8 = (cx // 2) * 2, (cy // 2) * 2
    return bool(ft.luma_nnz[y8 : y8 + 2, x8 : x8 + 2].any())


def _boundary_strengths(
    ft: FrameTensors, mbx: int, mby: int, vertical: bool, edge: int
) -> np.ndarray:
    """bS for the 16 luma sample lines of one 4-px-aligned edge of MB
    (mbx,mby). edge = 0..3 (position in 4px units; 0 = MB boundary)."""
    addr_q = mby * ft.mb_w + mbx
    bs = np.zeros(16, np.int32)
    for line in range(16):
        # locate the two 4x4 cells astride this sample line
        if vertical:
            qx, qy = mbx * 4 + edge, mby * 4 + line // 4
            px, py = qx - 1, qy
        else:
            qx, qy = mbx * 4 + line // 4, mby * 4 + edge
            px, py = qx, qy - 1
        addr_p = (py // 4) * ft.mb_w + (px // 4)
        # 8.7.2.1: all MBs of SP/SI slices take intra-strength bS
        intra_p = _is_intra(ft.mb_class[addr_p]) or ft.sp_slice_mb[addr_p]
        intra_q = _is_intra(ft.mb_class[addr_q]) or ft.sp_slice_mb[addr_q]
        if intra_p or intra_q:
            # 8.7.2.1: intra MB edges get bS 4 when the edge is vertical or
            # when p0 and q0 are both in FRAME macroblocks; horizontal MB
            # edges involving field MBs (all MBs of a PAFF field picture,
            # or field-coded MBAFF pairs) get bS 3 instead
            frame_mbs = not ft.field_pic and not (
                ft.mb_field[addr_p] or ft.mb_field[addr_q]
            )
            strong = edge == 0 and (vertical or frame_mbs)
            bs[line] = 4 if strong else 3
        elif _cell_coded(ft, addr_p, px, py) or _cell_coded(ft, addr_q, qx, qy):
            bs[line] = 2
        else:
            blk_p = (py % 4) * 4 + (px % 4)  # raster 4x4 idx within MB
            blk_q = (qy % 4) * 4 + (qx % 4)
            # field pictures carry quarter-FIELD-unit vertical MVs: the
            # spec's 4-quarter-frame-sample threshold is 2 field units
            bs[line] = _mv_bs(
                ft, addr_p, blk_p, addr_q, blk_q, 2 if ft.field_pic else 4
            )
    return bs


def _filter_luma_lines(p, q, bs, index_a, index_b):
    """Filter across one edge: p[4,16] (p3..p0 order p[0]=p3? -> we pass
    p[k] = p_k, i.e. p[0]=p0 nearest edge), q[4,16]. Vectorized over the 16
    lines. Returns new (p, q) int32 arrays."""
    alpha = _ALPHA[index_a] * _BD.scale
    beta = _BETA[index_b] * _BD.scale
    p0, p1, p2, p3 = (p[k].astype(np.int32) for k in range(4))
    q0, q1, q2, q3 = (q[k].astype(np.int32) for k in range(4))
    filt = (
        (bs > 0)
        & (np.abs(p0 - q0) < alpha)
        & (np.abs(p1 - p0) < beta)
        & (np.abs(q1 - q0) < beta)
    )
    ap = np.abs(p2 - p0) < beta
    aq = np.abs(q2 - q0) < beta
    # --- bS < 4 path (8.7.2.3)
    tc0 = _TC0[index_a, np.clip(bs, 1, 3) - 1] * _BD.scale
    tc = tc0 + ap.astype(np.int32) + aq.astype(np.int32)
    delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_w = np.clip(p0 + delta, 0, _BD.maxval)
    q0_w = np.clip(q0 - delta, 0, _BD.maxval)
    p1_w = p1 + np.clip((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1, -tc0, tc0)
    q1_w = q1 + np.clip((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1, -tc0, tc0)
    # --- bS == 4 path (8.7.2.4)
    strong = np.abs(p0 - q0) < ((alpha >> 2) + 2)
    sp = ap & strong
    p0_s = np.where(
        sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, (2 * p1 + p0 + q1 + 2) >> 2
    )
    p1_s = np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2_s = np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq = aq & strong
    q0_s = np.where(
        sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3, (2 * q1 + q0 + p1 + 2) >> 2
    )
    q1_s = np.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2_s = np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs == 4
    new_p0 = np.where(filt, np.where(is4, p0_s, p0_w), p0)
    new_q0 = np.where(filt, np.where(is4, q0_s, q0_w), q0)
    new_p1 = np.where(filt & ap, np.where(is4, p1_s, p1_w), np.where(filt & is4, p1_s, p1))
    new_q1 = np.where(filt & aq, np.where(is4, q1_s, q1_w), np.where(filt & is4, q1_s, q1))
    new_p2 = np.where(filt & is4, p2_s, p2)
    new_q2 = np.where(filt & is4, q2_s, q2)
    return (
        np.stack([new_p0, new_p1, new_p2, p3]),
        np.stack([new_q0, new_q1, new_q2, q3]),
    )


def _filter_chroma_lines(p, q, bs, index_a, index_b):
    """Chroma: only p0/q0 (p1 used as input), 8 lines. p,q: [2,8]."""
    alpha = _ALPHA[index_a] * _BD.scale
    beta = _BETA[index_b] * _BD.scale
    p0, p1 = (p[k].astype(np.int32) for k in range(2))
    q0, q1 = (q[k].astype(np.int32) for k in range(2))
    filt = (
        (bs > 0)
        & (np.abs(p0 - q0) < alpha)
        & (np.abs(p1 - p0) < beta)
        & (np.abs(q1 - q0) < beta)
    )
    tc = _TC0[index_a, np.clip(bs, 1, 3) - 1] * _BD.scale + 1
    delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_w = np.clip(p0 + delta, 0, _BD.maxval)
    q0_w = np.clip(q0 - delta, 0, _BD.maxval)
    p0_s = (2 * p1 + p0 + q1 + 2) >> 2
    q0_s = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    new_p0 = np.where(filt, np.where(is4, p0_s, p0_w), p0)
    new_q0 = np.where(filt, np.where(is4, q0_s, q0_w), q0)
    return np.stack([new_p0, p1]), np.stack([new_q0, q1])


def _mb_rows(ft: FrameTensors, addr: int, unit: int = 16) -> np.ndarray:
    """Picture row indices of the MB's `unit` sample rows in its own
    geometry: consecutive for frame MBs, parity-interleaved for MBAFF
    field MBs."""
    row = addr // ft.mb_w
    if ft.mbaff and ft.mb_field[addr]:
        base = (row & ~1) * unit
        return base + (row & 1) + 2 * np.arange(unit)
    return row * unit + np.arange(unit)


def _bs_pair(
    ft: FrameTensors,
    addr_p: int,
    px: int,
    py: int,
    addr_q: int,
    qx: int,
    qy: int,
    vertical: bool,
    mb_edge: bool,
) -> int:
    """8.7.2.1 bS for one sample line given the two 4x4 cells astride it in
    GLOBAL spatial-local cell coordinates (cell row = spatial mby*4 +
    MB-local cell row — the MBAFF grid layout)."""
    intra_p = _is_intra(ft.mb_class[addr_p]) or ft.sp_slice_mb[addr_p]
    intra_q = _is_intra(ft.mb_class[addr_q]) or ft.sp_slice_mb[addr_q]
    fld_p = bool(ft.mb_field[addr_p]) or ft.field_pic
    fld_q = bool(ft.mb_field[addr_q]) or ft.field_pic
    mixed = fld_p != fld_q
    if intra_p or intra_q:
        strong = mb_edge and (vertical or not (fld_p or fld_q))
        return 4 if strong else 3
    if _cell_coded(ft, addr_p, px, py) or _cell_coded(ft, addr_q, qx, qy):
        return 2
    if mixed:
        # frame/field mixed inter edge: motion is in different units (8.7.2.1)
        return 1
    blk_p = (py % 4) * 4 + (px % 4)
    blk_q = (qy % 4) * 4 + (qx % 4)
    return _mv_bs(ft, addr_p, blk_p, addr_q, blk_q, 2 if fld_p else 4)


def _deblock_mbaff_picture(
    ft: FrameTensors, sps: SPS, pps: PPS, y: np.ndarray, cb: np.ndarray,
    cr: np.ndarray, luma_only: bool = False, qp_arr: np.ndarray | None = None,
):
    """spec 8.7 for an MBAFF picture containing field MB pairs. Per-MB slow
    path in pair decode order with explicit sample-row indexing: a field
    MB's edges live on its parity-interleaved rows; frame/field crossings
    at pair boundaries follow the Table 6-4 mapper per sample line, and a
    frame MB below a field pair filters its top edge as TWO stride-2
    sub-edges (one per parity). The reference decodes no pixels at all
    (/root/reference/h264/slice.go)."""
    from ..syntax.mbaff_nbr import MbaffGrid

    # qp_arr overrides ft.qp for threshold derivation only (the 4:4:4
    # chroma-as-luma pass re-runs this with per-MB QPc values)
    if qp_arr is None:
        qp_arr = ft.qp
    grid = MbaffGrid(
        ft.mb_w, ft.mb_h,
        field_at=lambda sp: bool(ft.mb_field[sp]),
        avail=lambda sp: True,
        ch_h=ft.ch_mb_h,
    )
    w_mb, h_mb = ft.mb_w, ft.mb_h

    def cqp(qp_p, qp_q, off):
        return (chroma_qp(qp_p, off) + chroma_qp(qp_q, off) + 1) >> 1

    def filter_luma_cols(rows, x, bs, ia, ib):
        p = np.stack([y[rows, x - 1 - k] for k in range(4)])
        q = np.stack([y[rows, x + k] for k in range(4)])
        p, q = _filter_luma_lines(p, q, bs, ia, ib)
        for k in range(3):
            y[rows, x - 1 - k] = p[k]
            y[rows, x + k] = q[k]

    def filter_luma_rows(prow, qrow, cols, bs, ia, ib):
        """prow/qrow: arrays of 4 row indices each (p0..p3 / q0..q3)."""
        p = np.stack([y[prow[k], cols] for k in range(4)])
        q = np.stack([y[qrow[k], cols] for k in range(4)])
        p, q = _filter_luma_lines(p, q, bs, ia, ib)
        for k in range(3):
            y[prow[k], cols] = p[k]
            y[qrow[k], cols] = q[k]

    def filter_chroma_cols(crows, cx, cbs, qp_p, qp_q, a_off, b_off):
        if luma_only:
            return
        for plane, off in ((cb, pps.chroma_qp_index_offset),
                           (cr, pps.second_chroma_qp_index_offset)):
            qpc = cqp(qp_p, qp_q, off)
            ia = np.clip(qpc + a_off, 0, 51)
            ib = np.clip(qpc + b_off, 0, 51)
            p = np.stack([plane[crows, cx - 1 - k] for k in range(2)])
            q = np.stack([plane[crows, cx + k] for k in range(2)])
            p, q = _filter_chroma_lines(p, q, cbs, ia, ib)
            plane[crows, cx - 1] = p[0]
            plane[crows, cx] = q[0]

    def filter_chroma_rows(prow, qrow, ccols, cbs, qp_p, qp_q, a_off, b_off):
        if luma_only:
            return
        for plane, off in ((cb, pps.chroma_qp_index_offset),
                           (cr, pps.second_chroma_qp_index_offset)):
            qpc = cqp(qp_p, qp_q, off)
            ia = np.clip(qpc + a_off, 0, 51)
            ib = np.clip(qpc + b_off, 0, 51)
            p = np.stack([plane[prow[k], ccols] for k in range(2)])
            q = np.stack([plane[qrow[k], ccols] for k in range(2)])
            p, q = _filter_chroma_lines(p, q, cbs, ia, ib)
            plane[prow[0], ccols] = p[0]
            plane[qrow[0], ccols] = q[0]

    scan = [
        (2 * pr + tb) * w_mb + pc
        for pr in range(h_mb // 2)
        for pc in range(w_mb)
        for tb in (0, 1)
    ]
    cf2 = ft.chroma_format == 2  # 4:2:2: full-height chroma, 16-row MBs
    ch = ft.ch_mb_h
    for addr in scan:
        if ft.disable_deblock[addr] == 1:
            continue
        mby, mbx = divmod(addr, w_mb)
        fld = bool(ft.mb_field[addr])
        rows = _mb_rows(ft, addr)
        crows = _mb_rows(ft, addr, ch)
        qp_q = int(qp_arr[addr])
        a_off = int(ft.alpha_off[addr])
        b_off = int(ft.beta_off[addr])
        t8 = bool(ft.transform_8x8[addr])
        edges = [0, 1, 2, 3] if not t8 else [0, 2]

        def same_slice(p_addr):
            return (
                ft.disable_deblock[addr] != 2
                or ft.slice_id[p_addr] == ft.slice_id[addr]
            )

        # ---------------- vertical edges (same picture rows both sides)
        for edge in edges:
            x = mbx * 16 + edge * 4
            if edge == 0 and mbx == 0:
                continue
            bs = np.zeros(16, np.int32)
            qp_p_line = np.full(16, qp_q, np.int32)
            skip_all = True
            for line in range(16):
                qx, qy = mbx * 4 + edge, mby * 4 + line // 4
                if edge:
                    addr_p, px, py = addr, qx - 1, qy
                else:
                    naddr, xW, yW = grid.neighbor(addr, -1, line)
                    if naddr < 0 or not same_slice(naddr):
                        continue
                    nmby, nmbx = divmod(naddr, w_mb)
                    addr_p = naddr
                    px, py = nmbx * 4 + (xW >> 2), nmby * 4 + (yW >> 2)
                skip_all = False
                bs[line] = _bs_pair(ft, addr_p, px, py, addr, qx, qy, True, edge == 0)
                qp_p_line[line] = qp_arr[addr_p]
            if skip_all or not bs.any():
                continue
            qp_av = (qp_p_line + qp_q + 1) >> 1
            ia = np.clip(qp_av + a_off, 0, 51)
            ib = np.clip(qp_av + b_off, 0, 51)
            filter_luma_cols(rows, x, bs, ia, ib)
            if not luma_only and edge in (0, 2):
                cx = mbx * 8 + edge * 2
                # per-line chroma qp: derive per pair of luma lines
                qline = qp_p_line if cf2 else qp_p_line[::2]
                cbs_v = bs if cf2 else bs[::2]
                for plane, off in ((cb, pps.chroma_qp_index_offset),
                                   (cr, pps.second_chroma_qp_index_offset)):
                    qpc_av = (
                        np.array([chroma_qp(int(q_), off) for q_ in qline])
                        + chroma_qp(qp_q, off) + 1
                    ) >> 1
                    ia_c = np.clip(qpc_av + a_off, 0, 51)
                    ib_c = np.clip(qpc_av + b_off, 0, 51)
                    p = np.stack([plane[crows, cx - 1 - k] for k in range(2)])
                    q = np.stack([plane[crows, cx + k] for k in range(2)])
                    p, q = _filter_chroma_lines(p, q, cbs_v, ia_c, ib_c)
                    plane[crows, cx - 1] = p[0]
                    plane[crows, cx] = q[0]

        # ---------------- horizontal edges
        cols = slice(mbx * 16, mbx * 16 + 16)
        ccols = slice(mbx * 8, mbx * 8 + 8)
        # top MB edge
        pair_top = addr - w_mb if mby & 1 else addr
        if not fld and (mby & 1):
            # frame bottom MB: edge vs own pair's top (frame) MB
            addr_p = pair_top
            if same_slice(addr_p):
                bs = np.zeros(16, np.int32)
                for line in range(16):
                    qx = mbx * 4 + line // 4
                    bs[line] = _bs_pair(
                        ft, addr_p, qx, (mby - 1) * 4 + 3, addr, qx, mby * 4,
                        False, True,
                    )
                if bs.any():
                    qp_p = int(qp_arr[addr_p])
                    qp_av = (qp_p + qp_q + 1) >> 1
                    ia = np.clip(qp_av + a_off, 0, 51)
                    ib = np.clip(qp_av + b_off, 0, 51)
                    prow = [rows[0] - 1 - k for k in range(4)]
                    qrow = [rows[0] + k for k in range(4)]
                    filter_luma_rows(prow, qrow, cols, bs, ia, ib)
                    filter_chroma_rows(
                        [crows[0] - 1 - k for k in range(2)],
                        [crows[0] + k for k in range(2)],
                        ccols, bs[::2], qp_p, qp_q, a_off, b_off,
                    )
        elif (mby // 2) >= 1:
            # field MB (either slot) or frame top MB: edge vs the above pair
            pr = mby // 2
            if True:
                above_top = (2 * (pr - 1)) * w_mb + mbx
                above_fld = bool(ft.mb_field[above_top])
                if not fld and above_fld:
                    # frame MB below a field pair: TWO stride-2 sub-edges
                    for par in (0, 1):
                        addr_p = above_top + par * w_mb
                        if not same_slice(addr_p):
                            continue
                        bs = np.zeros(16, np.int32)
                        for line in range(16):
                            qx = mbx * 4 + line // 4
                            bs[line] = _bs_pair(
                                ft, addr_p, qx, (2 * (pr - 1) + par) * 4 + 3,
                                addr, qx, mby * 4, False, True,
                            )
                        if not bs.any():
                            continue
                        qp_p = int(qp_arr[addr_p])
                        qp_av = (qp_p + qp_q + 1) >> 1
                        ia = np.clip(qp_av + a_off, 0, 51)
                        ib = np.clip(qp_av + b_off, 0, 51)
                        y0 = mby * 16
                        prow = [y0 + par - 2 * (k + 1) for k in range(4)]
                        qrow = [y0 + par + 2 * k for k in range(4)]
                        filter_luma_rows(prow, qrow, cols, bs, ia, ib)
                        cy0 = mby * ch
                        filter_chroma_rows(
                            [cy0 + par - 2 * (k + 1) for k in range(2)],
                            [cy0 + par + 2 * k for k in range(2)],
                            ccols, bs[::2], qp_p, qp_q, a_off, b_off,
                        )
                else:
                    # p side: owner of the same-geometry row above q0
                    if fld:
                        par = mby & 1
                        if above_fld:
                            addr_p = above_top + par * w_mb
                            p_cell_row = (2 * (pr - 1) + par) * 4 + 3
                        else:
                            addr_p = above_top + w_mb  # frame bottom MB
                            # p0 = picture row 32*pr - 2 + par -> local 14+par
                            p_cell_row = (2 * (pr - 1) + 1) * 4 + 3
                    else:
                        addr_p = above_top + w_mb
                        p_cell_row = (2 * (pr - 1) + 1) * 4 + 3
                    bs = np.zeros(16, np.int32)
                    if same_slice(addr_p):
                        for line in range(16):
                            qx = mbx * 4 + line // 4
                            bs[line] = _bs_pair(
                                ft, addr_p, qx, p_cell_row, addr, qx, mby * 4,
                                False, True,
                            )
                    if bs.any():  # NOT continue: internal edges still follow
                        qp_p = int(qp_arr[addr_p])
                        qp_av = (qp_p + qp_q + 1) >> 1
                        ia = np.clip(qp_av + a_off, 0, 51)
                        ib = np.clip(qp_av + b_off, 0, 51)
                        if fld:
                            prow = [rows[0] - 2 * (k + 1) for k in range(4)]
                            crow_p = [crows[0] - 2 * (k + 1) for k in range(2)]
                        else:
                            prow = [rows[0] - 1 - k for k in range(4)]
                            crow_p = [crows[0] - 1 - k for k in range(2)]
                        qrow = [rows[0] + (2 if fld else 1) * k for k in range(4)]
                        filter_luma_rows(prow, qrow, cols, bs, ia, ib)
                        filter_chroma_rows(
                            crow_p,
                            [crows[0] + (2 if fld else 1) * k for k in range(2)],
                            ccols, bs[::2], qp_p, qp_q, a_off, b_off,
                        )
        # internal edges: both sides inside this MB (its own geometry).
        # 4:2:2 chroma has a transform boundary every 4 chroma rows, so all
        # three internal positions carry chroma filtering even when the 8x8
        # luma transform suppresses luma edges 1/3 (mirrors deblock_frame)
        ch_int = (1, 2, 3) if cf2 else (2,)
        for edge in ([1, 2, 3] if cf2 else edges[1:]):
            yy0 = edge * 4
            bs = np.zeros(16, np.int32)
            for line in range(16):
                qx, qy = mbx * 4 + line // 4, mby * 4 + edge
                bs[line] = _bs_pair(ft, addr, qx, qy - 1, addr, qx, qy, False, False)
            if not bs.any():
                continue
            ia = np.clip(qp_q + a_off, 0, 51)
            ib = np.clip(qp_q + b_off, 0, 51)
            if edge in edges:  # luma transform boundary
                filter_luma_rows(
                    rows[yy0 - 1 :: -1][:4], rows[yy0 : yy0 + 4], cols, bs,
                    ia, ib
                )
            if not luma_only and edge in ch_int:
                c0 = (ch // 4) * edge
                filter_chroma_rows(
                    crows[c0 - 1 :: -1][:2], crows[c0 : c0 + 2], ccols,
                    bs[::2], qp_q, qp_q, a_off, b_off,
                )
    return y, cb, cr


def deblock_frame(
    ft: FrameTensors, sps: SPS, pps: PPS, y: np.ndarray, cb: np.ndarray, cr: np.ndarray
):
    """Apply spec 8.7 in place over copies; returns filtered planes."""
    _BD.scale = 1 << (sps.bit_depth_luma - 8)
    _BD.maxval = (1 << sps.bit_depth_luma) - 1
    pxdtype = np.uint16 if sps.bit_depth_luma > 8 else np.uint8
    if ft.mb_field.any():
        if (ft.disable_deblock == 1).all():
            return y, cb, cr
        y = y.astype(np.int32)
        cb = cb.astype(np.int32)
        cr = cr.astype(np.int32)
        if ft.chroma_format == 3:
            # ChromaArrayType 3: chroma filters exactly like luma (8.7.2
            # chromaStyleFilteringFlag = 0) at luma geometry — run the luma
            # pass once per plane, with per-MB QPc driving the thresholds
            y, _, _ = _deblock_mbaff_picture(ft, sps, pps, y, cb, cr,
                                             luma_only=True)
            for plane, off in (
                (cb, pps.chroma_qp_index_offset),
                (cr, pps.second_chroma_qp_index_offset),
            ):
                qpc = np.array(
                    [chroma_qp(int(q), off) for q in ft.qp], np.int8
                )
                _deblock_mbaff_picture(ft, sps, pps, plane, plane, plane,
                                       luma_only=True, qp_arr=qpc)
        else:
            y, cb, cr = _deblock_mbaff_picture(ft, sps, pps, y, cb, cr)
        return y.astype(pxdtype), cb.astype(pxdtype), cr.astype(pxdtype)
    y = y.astype(np.int32)
    cb = cb.astype(np.int32)
    cr = cr.astype(np.int32)
    w_mb, h_mb = ft.mb_w, ft.mb_h
    cf = ft.chroma_format
    ch = ft.ch_mb_h  # chroma MB height in samples (8 / 16)
    if ft.mbaff:
        # MBAFF: MBs filter in PAIR scan order (8.7 processes macroblocks
        # in decoding order). The order is observable: a bottom MB's
        # horizontal edge and the next pair's vertical edge overlap in the
        # 3x3 corner samples both filters may touch.
        scan = [
            ((2 * pr + tb) * w_mb + pc)
            for pr in range(h_mb // 2)
            for pc in range(w_mb)
            for tb in (0, 1)
        ]
    else:
        scan = range(h_mb * w_mb)
    for addr in scan:
        mby, mbx = divmod(addr, w_mb)
        if ft.disable_deblock[addr] == 1:
            continue
        same_slice_l = mbx > 0 and (
            ft.disable_deblock[addr] != 2
            or ft.slice_id[addr - 1] == ft.slice_id[addr]
        )
        same_slice_t = mby > 0 and (
            ft.disable_deblock[addr] != 2
            or ft.slice_id[addr - w_mb] == ft.slice_id[addr]
        )
        qp_q = int(ft.qp[addr])
        a_off = int(ft.alpha_off[addr])
        b_off = int(ft.beta_off[addr])
        t8 = bool(ft.transform_8x8[addr])
        # ---- vertical edges (filter across columns)
        edges = [0, 1, 2, 3] if not t8 else [0, 2]
        for edge in edges:
            if edge == 0 and not same_slice_l:
                continue
            x = mbx * 16 + edge * 4
            bs = _boundary_strengths(ft, mbx, mby, True, edge)
            if not bs.any():
                continue
            addr_p = addr - 1 if edge == 0 else addr
            qp_p = int(ft.qp[addr_p])
            qp_av = (qp_p + qp_q + 1) >> 1
            index_a = np.clip(qp_av + a_off, 0, 51)
            index_b = np.clip(qp_av + b_off, 0, 51)
            rows = slice(mby * 16, mby * 16 + 16)
            p = np.stack([y[rows, x - 1 - k] for k in range(4)])
            q = np.stack([y[rows, x + k] for k in range(4)])
            p, q = _filter_luma_lines(p, q, bs, index_a, index_b)
            for k in range(4):
                y[rows, x - 1 - k] = p[k]
                y[rows, x + k] = q[k]
            if cf == 3:
                # ChromaArrayType 3: chromaStyleFilteringFlag = 0 (8.7.2) —
                # full-resolution chroma filters with the LUMA process at
                # the same edge positions, using each component's QPc
                for plane, off in (
                    (cb, pps.chroma_qp_index_offset),
                    (cr, pps.second_chroma_qp_index_offset),
                ):
                    qpc_av = (
                        chroma_qp(qp_p, off) + chroma_qp(qp_q, off) + 1
                    ) >> 1
                    ia = np.clip(qpc_av + a_off, 0, 51)
                    ib = np.clip(qpc_av + b_off, 0, 51)
                    p = np.stack([plane[rows, x - 1 - k] for k in range(4)])
                    q = np.stack([plane[rows, x + k] for k in range(4)])
                    p, q = _filter_luma_lines(p, q, bs, ia, ib)
                    for k in range(4):
                        plane[rows, x - 1 - k] = p[k]
                        plane[rows, x + k] = q[k]
            elif edge in (0, 2):  # chroma vertical edges (x = 0/4 of 8-wide)
                cx = mbx * 8 + edge * 2
                qpc_p = chroma_qp(qp_p, pps.chroma_qp_index_offset)
                qpc_q = chroma_qp(qp_q, pps.chroma_qp_index_offset)
                qpc_av = (qpc_p + qpc_q + 1) >> 1
                ia = np.clip(qpc_av + a_off, 0, 51)
                ib = np.clip(qpc_av + b_off, 0, 51)
                qpc_p2 = chroma_qp(qp_p, pps.second_chroma_qp_index_offset)
                qpc_q2 = chroma_qp(qp_q, pps.second_chroma_qp_index_offset)
                qpc_av2 = (qpc_p2 + qpc_q2 + 1) >> 1
                ia2 = np.clip(qpc_av2 + a_off, 0, 51)
                ib2 = np.clip(qpc_av2 + b_off, 0, 51)
                crows = slice(mby * ch, mby * ch + ch)
                # 4:2:2 chroma rows map 1:1 to the 16 luma sample lines
                cbs = bs if cf == 2 else bs[::2]
                for plane, iaa, ibb in ((cb, ia, ib), (cr, ia2, ib2)):
                    p = np.stack([plane[crows, cx - 1 - k] for k in range(2)])
                    q = np.stack([plane[crows, cx + k] for k in range(2)])
                    p, q = _filter_chroma_lines(p, q, cbs, iaa, ibb)
                    plane[crows, cx - 1] = p[0]
                    plane[crows, cx] = q[0]
        # ---- horizontal edges (filter across rows). 4:2:2 chroma has a
        # transform boundary every 4 chroma rows = every 4 LUMA rows, so all
        # four edge positions carry chroma filtering even when the 8x8 luma
        # transform suppresses luma edges 1 and 3.
        h_edges = [0, 1, 2, 3] if cf == 2 else edges
        for edge in h_edges:
            if edge == 0 and not same_slice_t:
                continue
            yy = mby * 16 + edge * 4
            bs = _boundary_strengths(ft, mbx, mby, False, edge)
            if not bs.any():
                continue
            addr_p = addr - w_mb if edge == 0 else addr
            qp_p = int(ft.qp[addr_p])
            qp_av = (qp_p + qp_q + 1) >> 1
            index_a = np.clip(qp_av + a_off, 0, 51)
            index_b = np.clip(qp_av + b_off, 0, 51)
            cols = slice(mbx * 16, mbx * 16 + 16)
            if edge in edges:  # luma transform boundary
                p = np.stack([y[yy - 1 - k, cols] for k in range(4)])
                q = np.stack([y[yy + k, cols] for k in range(4)])
                p, q = _filter_luma_lines(p, q, bs, index_a, index_b)
                for k in range(4):
                    y[yy - 1 - k, cols] = p[k]
                    y[yy + k, cols] = q[k]
            if cf == 3:
                if edge in edges:
                    for plane, off in (
                        (cb, pps.chroma_qp_index_offset),
                        (cr, pps.second_chroma_qp_index_offset),
                    ):
                        qpc_av = (
                            chroma_qp(qp_p, off) + chroma_qp(qp_q, off) + 1
                        ) >> 1
                        ia = np.clip(qpc_av + a_off, 0, 51)
                        ib = np.clip(qpc_av + b_off, 0, 51)
                        p = np.stack([plane[yy - 1 - k, cols] for k in range(4)])
                        q = np.stack([plane[yy + k, cols] for k in range(4)])
                        p, q = _filter_luma_lines(p, q, bs, ia, ib)
                        for k in range(4):
                            plane[yy - 1 - k, cols] = p[k]
                            plane[yy + k, cols] = q[k]
            elif cf == 2 or edge in (0, 2):
                cy = mby * ch + edge * (ch // 4)
                qpc_p = chroma_qp(qp_p, pps.chroma_qp_index_offset)
                qpc_q = chroma_qp(qp_q, pps.chroma_qp_index_offset)
                qpc_av = (qpc_p + qpc_q + 1) >> 1
                ia = np.clip(qpc_av + a_off, 0, 51)
                ib = np.clip(qpc_av + b_off, 0, 51)
                qpc_p2 = chroma_qp(qp_p, pps.second_chroma_qp_index_offset)
                qpc_q2 = chroma_qp(qp_q, pps.second_chroma_qp_index_offset)
                qpc_av2 = (qpc_p2 + qpc_q2 + 1) >> 1
                ia2 = np.clip(qpc_av2 + a_off, 0, 51)
                ib2 = np.clip(qpc_av2 + b_off, 0, 51)
                ccols = slice(mbx * 8, mbx * 8 + 8)
                cbs = bs[::2]
                for plane, iaa, ibb in ((cb, ia, ib), (cr, ia2, ib2)):
                    p = np.stack([plane[cy - 1 - k, ccols] for k in range(2)])
                    q = np.stack([plane[cy + k, ccols] for k in range(2)])
                    p, q = _filter_chroma_lines(p, q, cbs, iaa, ibb)
                    plane[cy - 1, ccols] = p[0]
                    plane[cy, ccols] = q[0]
    return y.astype(pxdtype), cb.astype(pxdtype), cr.astype(pxdtype)
