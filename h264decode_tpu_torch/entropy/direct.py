"""B-slice direct motion derivation, spec 8.4.1.2 (spatial and temporal),
shared by B_Skip, B_Direct_16x16 and B_Direct_8x8.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mv_pred import MotionContext


def _min_positive(a: int, b: int) -> int:
    """spec 8-206: min of the two when both >= 0, else the max."""
    if a >= 0 and b >= 0:
        return min(a, b)
    return max(a, b)


@dataclass
class DirectContext:
    """Per-slice inputs for direct derivation."""

    col_mv: np.ndarray | None  # colPic (RefPicList1[0]) colocated grids
    col_ref_idx: np.ndarray | None
    col_ref_uid: np.ndarray | None
    col_is_short_term: bool
    col_poc: int
    l0_uids: list  # uid per list0 index
    l0_pocs: list
    l0_long_term: list
    l1_pocs: list
    cur_poc: int
    spatial: bool
    direct_8x8_inference: bool
    # MBAFF (8.4.1.2.1 AFRM cases): current picture tensors, the colocated
    # picture's per-MB field flags, and its field order counts
    cur_ft: object = None
    col_mb_field: np.ndarray | None = None
    col_top_poc: int = 0
    col_bottom_poc: int = 0
    # field temporal direct (8.4.1.2.3): col referenced-field parities and
    # the list-0 / current field order counts
    col_ref_parity: np.ndarray | None = None
    l0_top_pocs: list | None = None
    l0_bottom_pocs: list | None = None

    def ref_idx_l0_of_uid(self, uid: int) -> int:
        """Lowest list0 index referring to the given picture (8.4.1.2.3)."""
        for i, u in enumerate(self.l0_uids):
            if u == uid:
                return i
        return 0

    def l0_field_poc(self, frame_pos: int, parity: int) -> int:
        pocs = self.l0_bottom_pocs if parity else self.l0_top_pocs
        return pocs[frame_pos] if frame_pos < len(pocs) else 0


# corner 4x4 cell of each 8x8 quadrant used under direct_8x8_inference
_INFER_CORNER = ((0, 0), (3, 0), (0, 3), (3, 3))


def derive_direct(
    motion: MotionContext,
    ctx: DirectContext,
    bx0: int,
    by0: int,
) -> list:
    """Derive direct MVs for the four 8x8 quadrants of the MB whose top-left
    4x4 cell is (bx0, by0). Returns a list of 4 quadrant dicts:
    {cells: [(cx, cy, mv0, ref0, mv1, ref1)]} with ref < 0 meaning the list
    is unused for that quadrant."""
    if ctx.spatial:
        return _spatial_direct(motion, ctx, bx0, by0)
    return _temporal_direct(motion, ctx, bx0, by0)


def _col_cell(ctx: DirectContext, cx: int, cy: int, q: int, bx0: int, by0: int):
    """Pick the colocated 4x4 cell (8.4.1.2.1): corner of the quadrant under
    direct_8x8_inference, else the same cell."""
    if ctx.direct_8x8_inference:
        dx, dy = _INFER_CORNER[q]
        return bx0 + dx, by0 + dy
    return cx, cy


def _col_motion(ctx: DirectContext, ccx: int, ccy: int, want_cell=False):
    """(refIdxCol, mvCol[, crossed cell]) for the colocated cell of current
    spatial-local cell (ccx, ccy) — the 8.4.1.2.1 AFRM frame/field
    crossings: the col grids are in the col picture's own spatial-local
    layout and per-MB units; vertMvScale converts Frm<->Fld vertical units.
    With want_cell, a third element (gy, gx, col_is_field) reports WHERE in
    the col grids the motion was read (for uid/parity lookups). Returns
    (None, None) when no colocated data exists."""
    if ctx.col_ref_idx is None:
        return (None, None, None) if want_cell else (None, None)
    ft = ctx.cur_ft
    mb_w = ft.mb_w if ft is not None else 0

    def ret(ref, mv, gy, gx, col_fld):
        if want_cell:
            return ref, mv, (gy, gx, col_fld)
        return ref, mv

    if ft is None or not getattr(ft, "mbaff", False):
        return ret(int(ctx.col_ref_idx[ccy, ccx]),
                   tuple(int(v) for v in ctx.col_mv[ccy, ccx]),
                   ccy, ccx, False)
    addr = (ccy // 4) * mb_w + (ccx // 4)
    row = addr // mb_w
    pr, par = row // 2, row & 1
    ly = ccy - row * 4
    cur_fld = bool(ft.mb_field[addr])
    cfa = ctx.col_mb_field
    pair_top = 2 * pr * mb_w + (addr % mb_w)

    def grid_at(col_addr, cell_row):
        gy = (col_addr // mb_w) * 4 + cell_row
        return int(ctx.col_ref_idx[gy, ccx]), ctx.col_mv[gy, ccx], gy

    col_pair_fld = bool(cfa[pair_top]) if cfa is not None else False
    if cur_fld == col_pair_fld:
        # same coding: colocated MB is the same spatial slot, same units
        return ret(int(ctx.col_ref_idx[ccy, ccx]),
                   tuple(int(v) for v in ctx.col_mv[ccy, ccx]),
                   ccy, ccx, col_pair_fld)
    if cur_fld:
        # current FIELD, colocated FRAME pair (Frm_To_Fld): picture strip
        # row 8*ly + par selects the top/bottom frame MB; vertical halves
        s = 8 * ly + par
        col_addr = pair_top + (mb_w if s >= 16 else 0)
        cref, cmv, gy = grid_at(col_addr, (s % 16) >> 2)
        vy = int(cmv[1])
        return ret(cref,
                   (int(cmv[0]), vy // 2 if vy >= 0 else -((-vy) // 2)),
                   gy, ccx, False)
    # current FRAME, colocated FIELD pair (Fld_To_Frm): the field whose POC
    # is closer to the current picture; field row = strip row / 2; vertical
    # doubles
    par_sel = (
        1
        if abs(ctx.col_bottom_poc - ctx.cur_poc)
        < abs(ctx.col_top_poc - ctx.cur_poc)
        else 0
    )
    s = 16 * par + 4 * ly
    col_addr = pair_top + (mb_w if par_sel else 0)
    cref, cmv, gy = grid_at(col_addr, (s >> 1) >> 2)
    return ret(cref, (int(cmv[0]), int(cmv[1]) * 2), gy, ccx, True)


def _spatial_direct(motion: MotionContext, ctx: DirectContext, bx0, by0):
    """8.4.1.2.2: spatial direct."""
    # MinPositive over the 16x16 partition neighbors, per list
    refs = []
    mvps = []
    for lst in range(2):
        (a_mv, a_ref), (b_mv, b_ref), (c_mv, c_ref) = motion.neighbors(
            lst, bx0, by0, 4
        )
        r = _min_positive(a_ref, _min_positive(b_ref, c_ref))
        r = max(r, -1)  # UNAVAILABLE counts as no-reference
        refs.append(r)
        mvps.append(
            motion.predict(lst, r, bx0, by0, 4, 4) if r >= 0 else (0, 0)
        )
    direct_zero = refs[0] < 0 and refs[1] < 0
    if direct_zero:
        refs = [0, 0]
        mvps = [(0, 0), (0, 0)]
    out = []
    for q in range(4):
        qx, qy = bx0 + (q % 2) * 2, by0 + (q // 2) * 2
        cells = []
        for sy in range(2):
            for sx in range(2):
                cx, cy = qx + sx, qy + sy
                ccx, ccy = _col_cell(ctx, cx, cy, q, bx0, by0)
                col_zero = False
                if (
                    not direct_zero
                    and ctx.col_ref_idx is not None
                    and ctx.col_is_short_term
                ):
                    cref, cmv = _col_motion(ctx, ccx, ccy)
                    col_zero = (
                        cref == 0 and abs(int(cmv[0])) <= 1 and abs(int(cmv[1])) <= 1
                    )
                cell = [cx, cy, (0, 0), -1, (0, 0), -1]
                for lst in range(2):
                    if refs[lst] >= 0:
                        mv = (0, 0) if (col_zero and refs[lst] == 0 and not direct_zero) else mvps[lst]
                        if direct_zero:
                            mv = (0, 0)
                        cell[2 + 2 * lst] = mv
                        cell[3 + 2 * lst] = refs[lst]
                cells.append(tuple(cell))
        out.append(cells)
    return out


def _temporal_direct(motion: MotionContext, ctx: DirectContext, bx0, by0):
    """8.4.1.2.3: temporal direct (POC-distance scaled colocated vectors).

    MBAFF pictures with field macroblocks run the field variant: the
    colocated cell comes through the 8.4.1.2.1 AFRM crossing (with
    vertMvScale applied to mvCol), refIdxCol maps into the current FIELD
    reference list by (frame uid, field parity), and the tb/td distances
    use FIELD order counts. Validated against libavcodec on synthesized
    MBAFF B_Skip streams (tests/test_mbaff.py)."""
    ft = ctx.cur_ft
    mbaff_fields = (
        ft is not None and getattr(ft, "mbaff", False) and ft.mb_field.any()
    )
    cur_addr = (by0 // 4) * (ft.mb_w if ft is not None else 1) + bx0 // 4
    cur_fld = bool(ft.mb_field[cur_addr]) if mbaff_fields else False
    cur_par = ((by0 // 4) & 1) if cur_fld else -1
    out = []
    for q in range(4):
        qx, qy = bx0 + (q % 2) * 2, by0 + (q // 2) * 2
        cells = []
        for sy in range(2):
            for sx in range(2):
                cx, cy = qx + sx, qy + sy
                ccx, ccy = _col_cell(ctx, cx, cy, q, bx0, by0)
                if not mbaff_fields:
                    if ctx.col_ref_idx is None or int(ctx.col_ref_idx[ccy, ccx]) < 0:
                        # colocated intra: refIdxL0 = 0, mvCol = 0
                        ref0 = 0
                        mv_col = (0, 0)
                    else:
                        mv_col = (
                            int(ctx.col_mv[ccy, ccx, 0]),
                            int(ctx.col_mv[ccy, ccx, 1]),
                        )
                        ref0 = ctx.ref_idx_l0_of_uid(int(ctx.col_ref_uid[ccy, ccx]))
                    poc0 = ctx.l0_pocs[ref0]
                    lt0 = ctx.l0_long_term[ref0]
                    cur_poc, poc1 = ctx.cur_poc, ctx.col_poc
                    ref1 = 0
                else:
                    cref, mv_col, cell = _col_motion(ctx, ccx, ccy, want_cell=True)
                    if cref is None or cref < 0:
                        ref0 = 0 if not cur_fld else 0
                        mv_col = (0, 0)
                        frame_pos, ref_par = 0, (cur_par if cur_fld else -1)
                    else:
                        gy, gx, col_is_fld = cell
                        uid = int(ctx.col_ref_uid[gy, gx])
                        frame_pos = ctx.ref_idx_l0_of_uid(uid)
                        if col_is_fld and ctx.col_ref_parity is not None:
                            ref_par = int(ctx.col_ref_parity[gy, gx])
                        else:
                            ref_par = -1
                    if cur_fld:
                        # field list index: 2k = same parity, 2k+1 opposite
                        same = ref_par < 0 or ref_par == cur_par
                        ref0 = 2 * frame_pos + (0 if same else 1)
                        rp = cur_par if ref_par < 0 else ref_par
                        poc0 = ctx.l0_field_poc(frame_pos, rp)
                        cur_poc = (
                            ft.cur_field_pocs[cur_par]
                            if hasattr(ft, "cur_field_pocs")
                            else ctx.cur_poc
                        )
                        # colPic = same-parity field of RefPicList1[0]
                        poc1 = (
                            ctx.col_bottom_poc if cur_par else ctx.col_top_poc
                        )
                    else:
                        ref0 = frame_pos
                        poc0 = ctx.l0_pocs[frame_pos]
                        cur_poc, poc1 = ctx.cur_poc, ctx.col_poc
                    lt0 = ctx.l0_long_term[frame_pos]
                    ref1 = 0
                if lt0 or poc1 == poc0:
                    mv0 = mv_col
                    mv1 = (0, 0)
                else:
                    tb = _clip3(-128, 127, cur_poc - poc0)
                    td = _clip3(-128, 127, poc1 - poc0)
                    tx = (16384 + abs(td) // 2) // td if td > 0 else -(
                        (16384 + abs(td) // 2) // -td
                    )
                    dsf = _clip3(-1024, 1023, (tb * tx + 32) >> 6)
                    mv0 = (
                        (dsf * mv_col[0] + 128) >> 8,
                        (dsf * mv_col[1] + 128) >> 8,
                    )
                    mv1 = (mv0[0] - mv_col[0], mv0[1] - mv_col[1])
                cells.append((cx, cy, mv0, ref0, mv1, ref1))
        out.append(cells)
    return out


def _clip3(lo, hi, v):
    return lo if v < lo else hi if v > hi else v
