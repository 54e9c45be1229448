"""Intra-frame reconstruction walker (numpy oracle).

Walks macroblocks in decode order applying spec 8.3 prediction + 8.5
transform/dequant via the primitives in reference_recon.py. Produces the
pre-deblock picture; kernels/ must reproduce it bit-exactly on TPU.
"""

from __future__ import annotations

import numpy as np

from ..syntax.pps import PPS
from ..syntax.sps import SPS
from ..tensors.frame_tensors import (
    CHROMA_BLK_XY,
    LUMA_BLK_XY,
    MB_I_16X16,
    MB_I_NXN,
    MB_I_PCM,
    MB_SI,
    FrameTensors,
)
from . import reference_recon as rr


class IntraFrameReconstructor:
    """Reconstructs one frame: intra MBs (spec 8.3) and inter MBs (8.4)
    in decode order. `ref_lists` maps slice_id -> (list0, list1) of
    pipeline.dpb.Picture; `weight_ctx` maps slice_id -> (use_weighting,
    PredWeightTable or None)."""

    def __init__(
        self,
        ft: FrameTensors,
        sps: SPS,
        pps: PPS,
        ref_lists: list | None = None,
        weight_ctx: list | None = None,
        cur_poc: int = 0,
        cur_parity: int = -1,  # -1 frame picture; 0/1 = field parity (PAFF)
        sp_ctx: list | None = None,  # per slice_id: None or
        #   ("sp", sp_for_switch_flag, QSy) / ("si", True, QSy) — spec 8.6
        cur_field_pocs: tuple = (0, 0),  # (top, bottom) OCs of this frame
    ):
        self.ft = ft
        self.sps = sps
        self.pps = pps
        self.ref_lists = ref_lists or []
        self.weight_ctx = weight_ctx or []
        self.sp_ctx = sp_ctx or []
        self.cur_poc = cur_poc
        self.cur_parity = cur_parity
        self.cur_top_poc, self.cur_bottom_poc = cur_field_pocs
        self.bypass_enabled = bool(sps.qpprime_y_zero_transform_bypass_flag)
        self.W = ft.mb_w * 16
        self.H = ft.mb_h * 16
        self.cf = sps.chroma_array_type
        # bit-depth contract (High 10): clip ceiling, DC default, the
        # QpBdOffset added to QP before every dequant (spec 8.5: qP = QP'),
        # and the pixel dtype
        self.bd = sps.bit_depth_luma
        self.mx = (1 << self.bd) - 1
        self.mid = 1 << (self.bd - 1)
        self.qp_off = 6 * (self.bd - 8)  # QpBdOffsetY
        self.qp_off_c = 6 * (sps.bit_depth_chroma - 8)
        self.pxdtype = np.uint16 if self.bd > 8 else np.uint8
        # chroma MB geometry (MbHeightC x MbWidthC): 8x8 / 16x8 / 16x16
        self.ch = 16 if self.cf in (2, 3) else 8
        self.cw = 16 if self.cf == 3 else 8
        ch_pic_h = self.H if self.cf in (2, 3) else self.H // 2
        ch_pic_w = self.W if self.cf == 3 else self.W // 2
        self.y = np.zeros((self.H, self.W), self.pxdtype)
        self.cb = np.zeros((ch_pic_h, ch_pic_w), self.pxdtype)
        self.cr = np.zeros((ch_pic_h, ch_pic_w), self.pxdtype)
        # decoded 4x4 luma cells (drives spec 6.4 availability exactly under
        # raster decode order within a slice). For MBAFF pictures rows are
        # each spatial MB's LOCAL cell rows (same convention as the entropy
        # grids), not picture geometry.
        self.cell_done = np.zeros((ft.mb_h * 4, ft.mb_w * 4), bool)
        self.mb_done = np.zeros(ft.n_mbs, bool)
        self._grid = None  # 6.4.10 mapper, built lazily for MBAFF pictures
        if ft.mbaff:
            from ..syntax.mbaff_nbr import MbaffGrid

            self._grid = MbaffGrid(
                ft.mb_w, ft.mb_h,
                field_at=lambda sp: bool(ft.mb_field[sp]),
                avail=lambda sp: True,  # availability checked by the caller
                ch_h=ft.ch_mb_h,
            )
        # effective scaling lists
        s4 = pps.effective_scaling_4x4(sps)
        self.ls4 = {
            (idx): [rr.level_scale_4x4(s4[idx], m) for m in range(6)]
            for idx in range(6)
        }
        s8 = pps.effective_scaling_8x8(sps)
        # 8x8 lists: 0/1 = Intra/Inter Y; 2/3 = Intra/Inter Cb and 4/5 =
        # Intra/Inter Cr exist only for ChromaArrayType 3 streams
        n8 = 6 if self.cf == 3 else 2
        self.ls8 = {
            idx: [rr.level_scale_8x8(s8[idx], m) for m in range(6)]
            for idx in range(n8)
        }

    # ---------------------------------------------------------- availability

    def _mb_avail_intra(self, naddr: int, cur_addr: int) -> bool:
        """Neighbor MB availability for intra prediction (6.4.9), including
        the constrained_intra_pred gate (8.3.1.2 etc.)."""
        ft = self.ft
        if naddr < 0 or naddr >= ft.n_mbs or not self.mb_done[naddr]:
            return False
        if ft.slice_id[naddr] != ft.slice_id[cur_addr]:
            return False
        ncls = ft.mb_class[naddr]
        if self.pps.constrained_intra_pred_flag and ncls >= 3 and ncls != MB_SI:
            return False  # inter neighbor barred by CIP
        return True

    def _cell_avail(self, cx: int, cy: int, cur_addr: int) -> bool:
        ft = self.ft
        if cx < 0 or cy < 0 or cx >= ft.mb_w * 4 or cy >= ft.mb_h * 4:
            return False
        naddr = (cy >> 2) * ft.mb_w + (cx >> 2)
        if naddr == cur_addr:
            return bool(self.cell_done[cy, cx])
        return self._mb_avail_intra(naddr, cur_addr) and bool(self.cell_done[cy, cx])

    # -------------------------------------------------- MBAFF sample access
    # MBAFF pictures (frame AND field macroblocks) route reference-sample
    # gathering through the spec 6.4.10 neighbor mapper per SAMPLE location:
    # with mixed frame/field pairs one block's left references can come from
    # BOTH macroblocks of the left pair, so block-granular gathering cannot
    # be exact. Placement interleaves field MBs' rows at their parity inside
    # the pair's 32-row strip. The reference repo never reconstructs any
    # pixels (/root/reference/h264/slice.go:599-630).

    def _plane_of(self, idx: int):
        return (self.y, self.cb, self.cr)[idx]

    def _field_view(self, pic, parity: int):
        """Cached field view of a frame reference (8.4.2.1), for MBAFF
        field-MB motion compensation."""
        cache = getattr(self, "_field_views", None)
        if cache is None:
            cache = self._field_views = {}
        key = (pic.uid, parity)
        v = cache.get(key)
        if v is None:
            v = cache[key] = pic.field(parity)
        return v

    def _nbr_px(self, addr: int, xN: int, yN: int, plane_idx: int,
                chroma: bool):
        """Reference sample at location (xN, yN) relative to MB `addr`
        (6.4.10 + 6.4.9 availability + CIP); None if unavailable."""
        from ..syntax.mbaff_nbr import sample_pos

        ft = self.ft
        naddr, xW, yW = self._grid.neighbor(addr, xN, yN, chroma=chroma)
        if naddr < 0:
            return None
        if naddr != addr:
            if not self._mb_avail_intra(naddr, addr):
                return None
        sh = 2 if not chroma else 2  # px -> 4x4 cell shift (8px MB = 2 cells)
        nmby, nmbx = divmod(naddr, ft.mb_w)
        if chroma:
            # map the chroma sample to its covering LUMA cell: vertical
            # scale 2 at 4:2:0, 1:1 at 4:2:2 (full-height chroma)
            ysc = 2 if self.cf == 1 else 1
            cy, cx = nmby * 4 + (yW >> 2) * ysc, nmbx * 4 + (xW >> 2) * 2
        else:
            cy, cx = nmby * 4 + (yW >> sh), nmbx * 4 + (xW >> sh)
        if not self.cell_done[cy, cx]:
            return None
        x, y = sample_pos(naddr, bool(ft.mb_field[naddr]), ft.mb_w, xW, yW,
                          chroma=chroma, ch_h=ft.ch_mb_h)
        return int(self._plane_of(plane_idx)[y, x])

    def _gather(self, addr, locs, plane_idx=0, chroma=False):
        """[sample or None] for a list of (xN, yN) locations."""
        return [self._nbr_px(addr, x, y, plane_idx, chroma) for x, y in locs]

    def _put_block(self, addr: int, x0: int, y0: int, block: np.ndarray,
                   plane_idx: int = 0, chroma: bool = False):
        """Write a reconstructed block (MB-local origin x0,y0) into the
        picture, interleaving rows for field MBs."""
        ft = self.ft
        plane = self._plane_of(plane_idx)
        h, w = block.shape
        row = addr // ft.mb_w
        mbx = addr % ft.mb_w
        w_unit = 8 if chroma else 16
        h_unit = self.ch if chroma else 16
        x = mbx * w_unit + x0
        if not ft.mb_field[addr]:
            yb = row * h_unit + y0
            plane[yb : yb + h, x : x + w] = block
        else:
            base = (row & ~1) * h_unit + (row & 1)
            rows = base + 2 * (y0 + np.arange(h))
            plane[rows, x : x + w] = block

    def _refs_mbaff_line(self, addr, n, x0, y0, plane_idx=0, chroma=False,
                         n_left=None):
        """(left[n_left or n], top[n], corner) sample groups for a block at
        local (x0, y0): group available only when every sample in it is.
        `n_left` differs from `n` for non-square chroma MBs (8x16 at 4:2:2)."""
        left = self._gather(
            addr, [(x0 - 1, y0 + i) for i in range(n_left or n)], plane_idx,
            chroma
        )
        top = self._gather(
            addr, [(x0 + i, y0 - 1) for i in range(n)], plane_idx, chroma
        )
        corner = self._nbr_px(addr, x0 - 1, y0 - 1, plane_idx, chroma)
        l = (
            np.asarray(left, np.int32) if all(v is not None for v in left)
            else None
        )
        t = (
            np.asarray(top, np.int32) if all(v is not None for v in top)
            else None
        )
        return l, t, corner

    def _refs_4x4_mbaff(self, addr, x0, y0, plane_idx=0):
        left, top, corner = self._refs_mbaff_line(addr, 4, x0, y0, plane_idx)
        tr = None
        if top is not None:
            trs = self._gather(
                addr, [(x0 + 4 + i, y0 - 1) for i in range(4)], plane_idx
            )
            # 8.3.1.2: unavailable top-right samples substitute p[3,-1]
            tr = np.asarray(
                [int(top[3]) if v is None else v for v in trs], np.int32
            )
        return left, top, tr, corner

    def _intra8x8_pred_mbaff(self, addr, x0, y0, mode, plane_idx=0):
        from .intra8x8 import intra8x8_predict

        left, top, corner = self._refs_mbaff_line(addr, 8, x0, y0, plane_idx)
        tr = None
        if top is not None:
            trs = self._gather(
                addr, [(x0 + 8 + i, y0 - 1) for i in range(8)], plane_idx
            )
            tr = np.asarray(
                [int(top[7]) if v is None else v for v in trs], np.int32
            )
        return intra8x8_predict(mode, left, top, tr, corner, self.mid)

    # ------------------------------------------------------------- main walk

    def run(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        for addr in self.ft.decode_order:
            self.recon_mb(addr)
        return self.y, self.cb, self.cr

    def recon_mb(self, addr: int) -> None:
        ft = self.ft
        cls = ft.mb_class[addr]
        mbx, mby = ft.mb_xy(addr)
        if cls == MB_I_PCM:
            y, cb, cr = ft.pcm_samples[addr]
            if ft.mb_field[addr]:
                # MBAFF field MB: samples interleave into the pair's 32-row
                # strip at this MB's parity (spec 6.4.1 figure 6-8; parity =
                # spatial row slot assigned by the MBAFF address mapping)
                par = mby & 1
                ch, cw = self.ch, self.cw
                t16, t8 = (mby & ~1) * 16, (mby & ~1) * ch
                self.y[t16 + par : t16 + 32 : 2, mbx * 16 : mbx * 16 + 16] = y
                self.cb[t8 + par : t8 + 2 * ch : 2, mbx * cw : (mbx + 1) * cw] = cb
                self.cr[t8 + par : t8 + 2 * ch : 2, mbx * cw : (mbx + 1) * cw] = cr
            else:
                ch, cw = self.ch, self.cw
                self.y[mby * 16 : mby * 16 + 16, mbx * 16 : mbx * 16 + 16] = y
                self.cb[mby * ch : (mby + 1) * ch, mbx * cw : (mbx + 1) * cw] = cb
                self.cr[mby * ch : (mby + 1) * ch, mbx * cw : (mbx + 1) * cw] = cr
        elif cls == MB_I_NXN:
            if ft.transform_8x8[addr]:
                self._recon_i8x8_luma(addr, mbx, mby)
            else:
                self._recon_i4x4_luma(addr, mbx, mby)
            self._recon_chroma(addr, mbx, mby)
        elif cls == MB_I_16X16:
            self._recon_i16_luma(addr, mbx, mby)
            self._recon_chroma(addr, mbx, mby)
        elif cls == MB_SI:  # SI macroblock: Intra_4x4 + 8.6.2
            self._recon_si_mb(addr, mbx, mby)
        elif cls >= 3:  # inter (P/P_Skip; B with the B milestone)
            self._recon_inter_mb(addr, mbx, mby)
        else:
            raise NotImplementedError(f"mb class {cls} in frame walker")
        self.cell_done[mby * 4 : mby * 4 + 4, mbx * 4 : mbx * 4 + 4] = True
        self.mb_done[addr] = True

    def _field_mb(self, addr: int) -> bool:
        """Field-coded MB: PAFF field picture or MBAFF field pair — selects
        the FIELD coefficient scan (spec 8.5.6, Tables 8-13/8-14)."""
        return self.ft.field_pic or bool(self.ft.mb_field[addr])

    def _dz4(self, addr: int, scan16) -> np.ndarray:
        return rr.descan_4x4(scan16, self._field_mb(addr))

    def _s8(self, addr: int) -> np.ndarray:
        from ..tensors.frame_tensors import FIELD_SCAN_8x8, ZIGZAG_8x8

        return FIELD_SCAN_8x8 if self._field_mb(addr) else ZIGZAG_8x8

    def _bypass(self, addr) -> bool:
        """TransformBypassModeFlag (spec 8.5.15): lossless coding when the
        SPS enables qpprime_y_zero_transform_bypass and the MB's QP' is 0."""
        return (
            self.bypass_enabled
            and int(self.ft.qp[addr]) + self.qp_off == 0
        )

    @staticmethod
    def _dpcm(pred, res, mode):
        """8.5.15 intra bypass: vertical(0)/horizontal(1) prediction turns
        into DPCM along the prediction direction; other modes add raw
        residual to the normal prediction."""
        if mode == 0:  # vertical: accumulate down columns from the top refs
            return pred + np.cumsum(res, axis=0)
        if mode == 1:  # horizontal: accumulate along rows
            return pred + np.cumsum(res, axis=1)
        return pred + res

    # ------------------------------------------------ per-component access
    # ChromaArrayType 3 (4:4:4) codes Cb/Cr with the LUMA processes — same
    # prediction modes, transforms and scans per component (spec 8.3/8.5).
    # comp 0 = Y (always); 1/2 = Cb/Cr only when self.cf == 3.

    def _comps(self):
        return (0, 1, 2) if self.cf == 3 else (0,)

    def _comp_qp(self, addr: int, comp: int) -> int:
        """EFFECTIVE per-component QP' (incl. QpBdOffset) for dequant."""
        qp = int(self.ft.qp[addr])
        if comp == 0:
            return qp + self.qp_off
        off = (
            self.pps.chroma_qp_index_offset
            if comp == 1
            else self.pps.second_chroma_qp_index_offset
        )
        return rr.chroma_qp(qp, off, self.qp_off_c)

    def _comp_ac(self, addr: int, comp: int):
        ft = self.ft
        return ft.luma_ac[addr] if comp == 0 else ft.c444_ac[addr, comp - 1]

    def _comp_dc(self, addr: int, comp: int):
        ft = self.ft
        return ft.luma_dc[addr] if comp == 0 else ft.c444_dc[addr, comp - 1]

    def _comp_ac8(self, addr: int, comp: int):
        ft = self.ft
        if comp == 0:
            return ft.luma8_ac[addr] if ft.luma8_ac is not None else None
        return ft.c444_8x8[addr, comp - 1] if ft.c444_8x8 is not None else None

    # ------------------------------------------------------------- Intra 4x4

    def _refs_4x4(self, addr, gx, gy, plane=None):
        """Gather (left[4], top[4], topright[4], corner) for the 4x4 block at
        cell (gx, gy), applying the spec substitution rules."""
        if plane is None:
            plane = self.y
        x0, y0 = gx * 4, gy * 4
        have_l = self._cell_avail(gx - 1, gy, addr)
        have_t = self._cell_avail(gx, gy - 1, addr)
        have_tr = self._cell_avail(gx + 1, gy - 1, addr)
        have_c = self._cell_avail(gx - 1, gy - 1, addr)
        left = plane[y0 : y0 + 4, x0 - 1].astype(np.int32) if have_l else None
        top = plane[y0 - 1, x0 : x0 + 4].astype(np.int32) if have_t else None
        if have_tr:
            tr = plane[y0 - 1, x0 + 4 : x0 + 8].astype(np.int32)
            if tr.shape[0] < 4:  # picture edge: substitute per 8.3.1.2
                pad = np.full(4 - tr.shape[0], tr[-1] if tr.size else 0, np.int32)
                tr = np.concatenate([tr, pad])
        elif have_t:
            tr = np.full(4, top[3], np.int32)
        else:
            tr = None
        corner = int(plane[y0 - 1, x0 - 1]) if have_c else None
        return left, top, tr, corner

    def _recon_i4x4_luma(self, addr, mbx, mby):
        ft = self.ft
        comps = self._comps()
        qp_ls = [
            (q, self.ls4[(0, 1, 2)[c]][q % 6])  # lists 0/1/2: Intra Y/Cb/Cr
            for c, q in ((c, self._comp_qp(addr, c)) for c in comps)
        ]
        for blk in range(16):
            bx, by = LUMA_BLK_XY[blk]
            gx, gy = mbx * 4 + bx, mby * 4 + by
            mode = int(ft.intra4x4_modes[addr, blk])
            # components interleave per block so cell_done tracks the spec
            # availability identically for all three planes (cf == 3)
            for comp, (qp, ls) in zip(comps, qp_ls):
                plane = self._plane_of(comp)
                if self._grid is not None:
                    left, top, tr, corner = self._refs_4x4_mbaff(
                        addr, bx * 4, by * 4, comp
                    )
                else:
                    left, top, tr, corner = self._refs_4x4(addr, gx, gy, plane)
                pred = rr.intra4x4_predict(mode, left, top, tr, corner, self.mid)
                c = self._dz4(addr, self._comp_ac(addr, comp)[blk].astype(np.int32))
                if self._bypass(addr):
                    out = self._dpcm(pred, c, mode)
                else:
                    d = rr.dequant_4x4_ac(c, ls, qp)
                    out = pred + rr.idct_4x4(d)
                blkpx = rr.clip1(out, self.mx).astype(self.pxdtype)
                if self._grid is not None:
                    self._put_block(addr, bx * 4, by * 4, blkpx, comp)
                else:
                    plane[gy * 4 : gy * 4 + 4, gx * 4 : gx * 4 + 4] = blkpx
            self.cell_done[gy, gx] = True

    # ------------------------------------------------------------- Intra 8x8

    def _recon_i8x8_luma(self, addr, mbx, mby):
        ft = self.ft
        comps = self._comps()
        qp_ls = [
            # 8x8 lists 0/2/4: Intra Y/Cb/Cr (Inter at odd indices)
            (q, self.ls8[2 * c][q % 6])
            for c, q in ((c, self._comp_qp(addr, c)) for c in comps)
        ]
        for b8 in range(4):
            bx, by = b8 % 2, b8 // 2
            gx, gy = mbx * 4 + bx * 2, mby * 4 + by * 2
            x0, y0 = gx * 4, gy * 4
            mode = int(ft.intra4x4_modes[addr, b8])
            for comp, (qp, ls8) in zip(comps, qp_ls):
                plane = self._plane_of(comp)
                if self._grid is not None:
                    pred = self._intra8x8_pred_mbaff(
                        addr, bx * 8, by * 8, mode, comp
                    )
                else:
                    pred = self._intra8x8_pred(addr, gx, gy, mode, plane)
                ac8 = self._comp_ac8(addr, comp)
                scan = (
                    ac8[b8].astype(np.int32)
                    if ac8 is not None
                    else np.zeros(64, np.int32)
                )
                c = np.zeros(64, np.int32)
                c[self._s8(addr)] = scan
                c = c.reshape(8, 8)
                if self._bypass(addr):
                    out = self._dpcm(pred, c, mode)
                else:
                    if qp >= 36:
                        d = (c * ls8) << (qp // 6 - 6)
                    else:
                        d = (c * ls8 + (1 << (5 - qp // 6))) >> (6 - qp // 6)
                    out = pred + rr.idct_8x8(d)
                blkpx = rr.clip1(out, self.mx).astype(self.pxdtype)
                if self._grid is not None:
                    self._put_block(addr, bx * 8, by * 8, blkpx, comp)
                else:
                    plane[y0 : y0 + 8, x0 : x0 + 8] = blkpx
            self.cell_done[gy : gy + 2, gx : gx + 2] = True

    def _intra8x8_pred(self, addr, gx, gy, mode, plane=None):
        """spec 8.3.2: reference sample gathering + filtering (8.3.2.2.1),
        then the 9 8x8 prediction modes."""
        if plane is None:
            plane = self.y
        x0, y0 = gx * 4, gy * 4
        have_l = self._cell_avail(gx - 1, gy, addr) and self._cell_avail(gx - 1, gy + 1, addr)
        have_t = self._cell_avail(gx, gy - 1, addr) and self._cell_avail(gx + 1, gy - 1, addr)
        have_tr = self._cell_avail(gx + 2, gy - 1, addr) and self._cell_avail(gx + 3, gy - 1, addr)
        have_c = self._cell_avail(gx - 1, gy - 1, addr)
        left = plane[y0 : y0 + 8, x0 - 1].astype(np.int32) if have_l else None
        top = plane[y0 - 1, x0 : x0 + 8].astype(np.int32) if have_t else None
        if have_tr:
            tr = plane[y0 - 1, x0 + 8 : x0 + 16].astype(np.int32)
            if tr.shape[0] < 8:
                pad = np.full(8 - tr.shape[0], tr[-1] if tr.size else 0, np.int32)
                tr = np.concatenate([tr, pad])
        elif have_t:
            tr = np.full(8, top[7], np.int32)
        else:
            tr = None
        corner = int(plane[y0 - 1, x0 - 1]) if have_c else None
        from .intra8x8 import intra8x8_predict

        return intra8x8_predict(mode, left, top, tr, corner, self.mid)

    # ----------------------------------------------------------- Intra 16x16

    def _recon_i16_luma(self, addr, mbx, mby):
        ft = self.ft
        x0, y0 = mbx * 16, mby * 16
        mode16 = int(ft.intra16_mode[addr])
        for comp in self._comps():
            qp = self._comp_qp(addr, comp)
            ls = self.ls4[(0, 1, 2)[comp]][qp % 6]
            plane = self._plane_of(comp)
            if self._grid is not None:
                left, top, corner = self._refs_mbaff_line(addr, 16, 0, 0, comp)
            else:
                have_l = self._mb_avail_intra(addr - 1, addr) and mbx > 0
                have_t = self._mb_avail_intra(addr - ft.mb_w, addr) and mby > 0
                left = plane[y0 : y0 + 16, x0 - 1].astype(np.int32) if have_l else None
                top = plane[y0 - 1, x0 : x0 + 16].astype(np.int32) if have_t else None
                corner = int(plane[y0 - 1, x0 - 1]) if (have_l and have_t) else None
            if not (left is not None and top is not None):
                corner = None  # plane/corner use requires both edges
            pred = rr.intra16x16_predict(mode16, left, top, corner,
                                         self.mid, self.mx)
            ac = self._comp_ac(addr, comp)
            dc_scan = self._comp_dc(addr, comp).astype(np.int32)
            dc = self._dz4(addr, dc_scan)
            mb = np.zeros((16, 16), np.int32)
            if self._bypass(addr):
                # 8.5.15: DC/AC levels are the raw residual samples
                for blk in range(16):
                    bx, by = LUMA_BLK_XY[blk]
                    c = self._dz4(addr, ac[blk].astype(np.int32))
                    c[0, 0] = dc[by, bx]
                    mb[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = c
                blkpx = rr.clip1(self._dpcm(pred, mb, mode16), self.mx).astype(self.pxdtype)
                if self._grid is not None:
                    self._put_block(addr, 0, 0, blkpx, comp)
                else:
                    plane[y0 : y0 + 16, x0 : x0 + 16] = blkpx
                continue
            f = rr.hadamard_4x4(dc)
            dcy = rr.luma_dc_dequant(f, int(ls[0, 0]), qp)
            for blk in range(16):
                bx, by = LUMA_BLK_XY[blk]
                c = self._dz4(addr, ac[blk].astype(np.int32))
                d = rr.dequant_4x4_ac(c, ls, qp)
                d[0, 0] = dcy[by, bx]
                mb[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = rr.idct_4x4(d)
            blkpx = rr.clip1(pred + mb, self.mx).astype(self.pxdtype)
            if self._grid is not None:
                self._put_block(addr, 0, 0, blkpx, comp)
            else:
                plane[y0 : y0 + 16, x0 : x0 + 16] = blkpx

    # ---------------------------------------------------------------- Inter

    def _implicit_weights(self, p0, p1, cur_poc=None) -> tuple[int, int]:
        """8.4.2.3.1: implicit bi-prediction weights from POC distances.
        For MBAFF field MBs `cur_poc` is the current FIELD's order count and
        p0/p1 are field views carrying field POCs."""
        if cur_poc is None:
            cur_poc = self.cur_poc
        if p1.poc == p0.poc or p0.long_term or p1.long_term:
            return 32, 32
        tb = np.clip(cur_poc - p0.poc, -128, 127)
        td = np.clip(p1.poc - p0.poc, -128, 127)
        tx = int((16384 + abs(int(td)) // 2) / td) if td != 0 else 0
        if td < 0:
            tx = -((16384 + abs(int(td)) // 2) // -int(td))
        else:
            tx = (16384 + abs(int(td)) // 2) // int(td)
        dsf = int(np.clip((int(tb) * tx + 32) >> 6, -1024, 1023))
        w1 = dsf >> 2
        if w1 < -64 or w1 > 128:
            return 32, 32
        w0 = 64 - w1
        # additional spec guard: products must fit (w0/w1 within [-128,127] x2)
        if not (-64 <= w1 <= 128):
            return 32, 32
        return w0, w1

    def _recon_inter_mb(self, addr, mbx, mby):
        """P/B macroblock: MC prediction (8.4.2.2), uni/bi combination with
        default, explicit or implicit weighting (8.4.2.3), then residual."""
        from .inter import chroma_mc_block, luma_mc_block, weight_bi, weight_uni

        ft = self.ft
        sid = int(ft.slice_id[addr])
        lists = self.ref_lists[sid]
        wmode, pwt = (
            self.weight_ctx[sid] if sid < len(self.weight_ctx) else ("none", None)
        )
        x0, y0 = mbx * 16, mby * 16
        pred_y = np.zeros((16, 16), np.int32)
        pred_cb = np.zeros((self.ch, self.cw), np.int32)
        pred_cr = np.zeros((self.ch, self.cw), np.int32)
        chroma = self.sps.chroma_array_type in (1, 2)
        # 4:4:4: chroma MC uses the LUMA interpolation per component with
        # unscaled MVs (spec 8.4.2.2.2 when ChromaArrayType == 3)
        c444 = self.sps.chroma_array_type == 3
        # chroma vertical scale: 4:2:2 chroma rows are full-resolution, so
        # mvCLX[1] = 2 * mvLX[1] (8.4.1.4.1) and cell blocks are 2x4
        csy = self.ch // 8
        # MBAFF field MB: prediction runs in FIELD geometry — field ref
        # views (8.4.2.1: field idx 2k/2k+1 over the frame list), field-row
        # coordinates, and the MB's own parity for the 8.4.1.4 chroma shift
        fld = self._grid is not None and bool(ft.mb_field[addr])
        mb_par = (addr // ft.mb_w) & 1 if fld else self.cur_parity
        y0m = (mby // 2) * 16 if fld else y0
        cy0m = (mby // 2) * 8 if fld else mby * 8
        # per 4x4 luma cell (MVs are constant within partitions, and the
        # interpolation filters are local, so cell granularity is exact)
        for cy in range(4):
            for cx in range(4):
                blk = cy * 4 + cx
                part = (cy // 2) * 2 + (cx // 2)
                preds = []  # (lst, ref_idx, Picture, y, cb, cr)
                for lst in range(2):
                    ref_idx = int(ft.ref_idx[addr, lst, part])
                    if ref_idx < 0 or not lists[lst]:
                        continue
                    mvx, mvy = (int(v) for v in ft.mv[addr, lst, blk])
                    if fld:
                        widx = ref_idx >> 1  # pred-weight index: frame entry
                        ref = self._field_view(
                            lists[lst][widx], int(ft.ref_parity[addr, lst, part])
                        )
                    else:
                        widx = ref_idx
                        ref = lists[lst][ref_idx]
                    py = luma_mc_block(
                        ref.y, x0 + cx * 4, y0m + cy * 4, 4, 4, mvx, mvy,
                        self.mx,
                    )
                    pcb = pcr = None
                    if c444:
                        pcb = luma_mc_block(
                            ref.cb, x0 + cx * 4, y0m + cy * 4, 4, 4, mvx, mvy,
                            self.mx,
                        )
                        pcr = luma_mc_block(
                            ref.cr, x0 + cx * 4, y0m + cy * 4, 4, 4, mvx, mvy,
                            self.mx,
                        )
                    if chroma:
                        # spec 8.4.1.4.1: field MC from an opposite-parity
                        # reference field shifts the chroma vertical MV by
                        # +-2 (1/8-pel chroma units)
                        cvy = mvy * csy
                        # 8.4.1.4.1: the +-2 shift for opposite-parity field
                        # references applies only to 4:2:0 chroma
                        if self.cf == 1 and mb_par >= 0 and ref.parity >= 0 and (
                            ref.parity != mb_par
                        ):
                            cvy += 2 if mb_par == 1 else -2
                        pcb = chroma_mc_block(
                            ref.cb, mbx * 8 + cx * 2, csy * (cy0m + cy * 2),
                            2, 2 * csy, mvx, cvy,
                        )
                        pcr = chroma_mc_block(
                            ref.cr, mbx * 8 + cx * 2, csy * (cy0m + cy * 2),
                            2, 2 * csy, mvx, cvy,
                        )
                    preds.append((lst, widx, ref, py, pcb, pcr))
                if len(preds) == 1:
                    lst, ref_idx, ref, py, pcb, pcr = preds[0]
                    if wmode == "explicit":
                        tab = pwt.l0 if lst == 0 else pwt.l1
                        e = tab[ref_idx]
                        osh = self.bd - 8  # 8.4.2.3.2 offset scaling
                        py = weight_uni(
                            py, e.luma_weight, e.luma_offset << osh,
                            pwt.luma_log2_weight_denom, self.mx,
                        )
                        if chroma or c444:
                            d = pwt.chroma_log2_weight_denom
                            pcb = weight_uni(pcb, e.chroma_weight[0], e.chroma_offset[0] << osh, d, self.mx)
                            pcr = weight_uni(pcr, e.chroma_weight[1], e.chroma_offset[1] << osh, d, self.mx)
                else:
                    _, r0, p0, y0p, cb0, cr0 = preds[0]
                    _, r1, p1, y1p, cb1, cr1 = preds[1]
                    if wmode == "explicit":
                        e0, e1 = pwt.l0[r0], pwt.l1[r1]
                        osh = self.bd - 8
                        py = weight_bi(
                            y0p, y1p, e0.luma_weight, e1.luma_weight,
                            e0.luma_offset << osh, e1.luma_offset << osh,
                            pwt.luma_log2_weight_denom, self.mx,
                        )
                        if chroma or c444:
                            d = pwt.chroma_log2_weight_denom
                            pcb = weight_bi(cb0, cb1, e0.chroma_weight[0], e1.chroma_weight[0], e0.chroma_offset[0] << osh, e1.chroma_offset[0] << osh, d, self.mx)
                            pcr = weight_bi(cr0, cr1, e0.chroma_weight[1], e1.chroma_weight[1], e0.chroma_offset[1] << osh, e1.chroma_offset[1] << osh, d, self.mx)
                    elif wmode == "implicit":
                        cpoc = None
                        if fld:
                            cpoc = (
                                self.cur_bottom_poc if mb_par else self.cur_top_poc
                            )
                        w0, w1 = self._implicit_weights(p0, p1, cpoc)
                        py = weight_bi(y0p, y1p, w0, w1, 0, 0, 5, self.mx)
                        if chroma or c444:
                            pcb = weight_bi(cb0, cb1, w0, w1, 0, 0, 5, self.mx)
                            pcr = weight_bi(cr0, cr1, w0, w1, 0, 0, 5, self.mx)
                    else:
                        py = (y0p + y1p + 1) >> 1
                        if chroma or c444:
                            pcb = (cb0 + cb1 + 1) >> 1
                            pcr = (cr0 + cr1 + 1) >> 1
                pred_y[cy * 4 : cy * 4 + 4, cx * 4 : cx * 4 + 4] = py
                if c444:
                    pred_cb[cy * 4 : cy * 4 + 4, cx * 4 : cx * 4 + 4] = pcb
                    pred_cr[cy * 4 : cy * 4 + 4, cx * 4 : cx * 4 + 4] = pcr
                elif chroma:
                    ch0 = cy * 2 * csy
                    pred_cb[ch0 : ch0 + 2 * csy, cx * 2 : cx * 2 + 2] = pcb
                    pred_cr[ch0 : ch0 + 2 * csy, cx * 2 : cx * 2 + 2] = pcr
        sp = self.sp_ctx[sid] if sid < len(self.sp_ctx) else None
        if sp is not None:
            # SP slice: inter MBs (incl. P_Skip) reconstruct in the
            # transform domain (spec 8.6.1)
            self._sp_recon(addr, mbx, mby, pred_y, pred_cb, pred_cr,
                           switching=sp[1], qs=sp[2])
        else:
            self._add_inter_residual(addr, mbx, mby, pred_y, pred_cb, pred_cr)

    def _sp_recon(self, addr, mbx, mby, pred_y, pred_cb, pred_cr, *,
                  switching: bool, qs: int):
        """SP/SI macroblock reconstruction through the 8.6 transform-domain
        requantization chain (no 8x8 transform exists in SP/SI slices)."""
        ft = self.ft
        # High bit depth: the 8.6 chain consumes EFFECTIVE QP'/QS'
        # (+QpBdOffset), mirroring 8.5 — Extended profile is 8-bit in
        # practice, so this extension has no conformance oracle and is
        # validated against the in-test 8.6 transcription (tests/test_spsi.py)
        qp = int(ft.qp[addr])
        x0, y0 = mbx * 16, mby * 16
        out = np.empty((16, 16), np.int64)
        for blk in range(16):
            bx, by = LUMA_BLK_XY[blk]
            pred = pred_y[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4]
            lev = self._dz4(addr, ft.luma_ac[addr, blk].astype(np.int32))
            out[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = rr.sp_luma_block(
                pred, lev, qp + self.qp_off, qs + self.qp_off, switching
            )
        self.y[y0 : y0 + 16, x0 : x0 + 16] = rr.clip1(out, self.mx).astype(self.pxdtype)
        if self.sps.chroma_array_type == 1:
            self._sp_chroma(addr, mbx, mby, pred_cb, pred_cr, qp, qs, switching)

    def _sp_chroma(self, addr, mbx, mby, pred_cb, pred_cr, qp, qs, switching):
        ft, pps = self.ft, self.pps
        for comp, plane, pred, off in (
            (0, self.cb, pred_cb, pps.chroma_qp_index_offset),
            (1, self.cr, pred_cr, pps.second_chroma_qp_index_offset),
        ):
            qpc = rr.chroma_qp(qp, off, self.qp_off_c)
            qsc = rr.chroma_qp(qs, off, self.qp_off_c)
            dc = ft.chroma_dc[addr, comp].astype(np.int64)
            ac = np.stack([
                self._dz4(addr, ft.chroma_ac[addr, comp, k].astype(np.int32))
                for k in range(4)
            ]).astype(np.int64)
            rec = rr.sp_chroma_comp(pred, dc, ac, qpc, qsc, switching)
            plane[mby * 8 : mby * 8 + 8, mbx * 8 : mbx * 8 + 8] = (
                rr.clip1(rec, self.mx).astype(self.pxdtype)
            )

    def _recon_si_mb(self, addr, mbx, mby):
        """SI macroblock (spec 8.6.2): Intra_4x4 prediction, reconstruction
        through the QS quantization chain (same math as switching SP)."""
        ft = self.ft
        sp = self.sp_ctx[int(ft.slice_id[addr])]
        qs = sp[2]
        qp = int(ft.qp[addr])
        for blk in range(16):
            bx, by = LUMA_BLK_XY[blk]
            gx, gy = mbx * 4 + bx, mby * 4 + by
            x0, y0 = gx * 4, gy * 4
            mode = int(ft.intra4x4_modes[addr, blk])
            left, top, tr, corner = self._refs_4x4(addr, gx, gy)
            pred = rr.intra4x4_predict(mode, left, top, tr, corner, self.mid)
            lev = self._dz4(addr, ft.luma_ac[addr, blk].astype(np.int32))
            out = rr.sp_luma_block(
                pred, lev, qp + self.qp_off, qs + self.qp_off, switching=True
            )
            self.y[y0 : y0 + 4, x0 : x0 + 4] = rr.clip1(out, self.mx).astype(self.pxdtype)
            self.cell_done[gy, gx] = True
        if self.sps.chroma_array_type == 1:
            # chroma prediction as for intra MBs, then the 8.6 chain
            pred_cb, pred_cr = self._chroma_pred(addr, mbx, mby)
            self._sp_chroma(addr, mbx, mby, pred_cb, pred_cr, qp, qs, True)

    def _put_mb(self, addr, mbx, mby, plane_idx, block, chroma=False):
        """Final MB write: interleaved for MBAFF field MBs, direct else."""
        if self._grid is not None:
            self._put_block(addr, 0, 0, block, plane_idx, chroma=chroma)
        else:
            w = 8 if chroma else 16
            h = self.ch if chroma else 16
            plane = self._plane_of(plane_idx)
            plane[mby * h : mby * h + h, mbx * w : mbx * w + w] = block

    def _add_inter_residual(self, addr, mbx, mby, pred_y, pred_cb, pred_cr):
        ft = self.ft
        x0, y0 = mbx * 16, mby * 16
        # luma-process residual per component (Y always; Cb/Cr when 4:4:4,
        # spec 7.3.5.3.1 / 8.5: chroma uses the luma transform chain with
        # its own QPc and Inter Cb/Cr scaling lists)
        comp_preds = [(0, pred_y)]
        if self.cf == 3:
            comp_preds += [(1, pred_cb), (2, pred_cr)]
        for comp, pred in comp_preds:
            qp = self._comp_qp(addr, comp)
            ac = self._comp_ac(addr, comp)
            ac8 = self._comp_ac8(addr, comp)
            res = np.zeros((16, 16), np.int32)
            if self._bypass(addr):
                if ft.transform_8x8[addr] and ac8 is not None:
                    for b8 in range(4):
                        c = np.zeros(64, np.int32)
                        c[self._s8(addr)] = ac8[b8]
                        bx, by = b8 % 2, b8 // 2
                        res[by * 8 : by * 8 + 8, bx * 8 : bx * 8 + 8] = c.reshape(8, 8)
                else:
                    for blk in range(16):
                        bx, by = LUMA_BLK_XY[blk]
                        res[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = self._dz4(
                            addr, ac[blk].astype(np.int32)
                        )
            elif ft.transform_8x8[addr] and ac8 is not None:
                ls8 = self.ls8[2 * comp + 1][qp % 6]  # lists 1/3/5: Inter Y/Cb/Cr
                for b8 in range(4):
                    bx, by = b8 % 2, b8 // 2
                    c = np.zeros(64, np.int32)
                    c[self._s8(addr)] = ac8[b8].astype(np.int32)
                    c = c.reshape(8, 8)
                    if qp >= 36:
                        d = (c * ls8) << (qp // 6 - 6)
                    else:
                        d = (c * ls8 + (1 << (5 - qp // 6))) >> (6 - qp // 6)
                    res[by * 8 : by * 8 + 8, bx * 8 : bx * 8 + 8] = rr.idct_8x8(d)
            else:
                ls = self.ls4[(3, 4, 5)[comp]][qp % 6]  # lists 3/4/5: Inter
                for blk in range(16):
                    bx, by = LUMA_BLK_XY[blk]
                    c = self._dz4(addr, ac[blk].astype(np.int32))
                    d = rr.dequant_4x4_ac(c, ls, qp)
                    res[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = rr.idct_4x4(d)
            self._put_mb(addr, mbx, mby, comp, rr.clip1(pred + res, self.mx).astype(self.pxdtype))
        if self.sps.chroma_array_type not in (1, 2):
            return
        qp = int(ft.qp[addr])
        if self._bypass(addr):
            if self.sps.chroma_array_type == 1:
                for comp, (plane, pred) in enumerate(
                    ((self.cb, pred_cb), (self.cr, pred_cr))
                ):
                    mbres = np.zeros((8, 8), np.int32)
                    c2 = ft.chroma_dc[addr, comp].astype(np.int32).reshape(2, 2)
                    for blk in range(4):
                        bx, by = CHROMA_BLK_XY[blk]
                        c = self._dz4(addr, ft.chroma_ac[addr, comp, blk].astype(np.int32))
                        c[0, 0] = c2[by, bx]
                        mbres[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = c
                    self._put_mb(addr, mbx, mby, 1 + comp,
                                 rr.clip1(pred + mbres, self.mx).astype(self.pxdtype), chroma=True)
            return
        for comp, (plane, pred, qp_off, ls_idx) in enumerate(
            [
                (self.cb, pred_cb, self.pps.chroma_qp_index_offset, 4),
                (self.cr, pred_cr, self.pps.second_chroma_qp_index_offset, 5),
            ]
        ):
            qpc = rr.chroma_qp(qp, qp_off, self.qp_off_c)
            ls = self.ls4[ls_idx][qpc % 6]  # lists 4/5: Inter Cb/Cr
            dcc = self._chroma_dc_deq(
                self._chroma_dc_grid(addr, comp), ls_idx, ls, qpc
            )
            mb = np.zeros((self.ch, 8), np.int32)
            for blk in range(ft.ch_blks):
                bx, by = ft.ch_blk_xy[blk]
                c = self._dz4(addr, ft.chroma_ac[addr, comp, blk].astype(np.int32))
                d = rr.dequant_4x4_ac(c, ls, qpc)
                d[0, 0] = dcc[by, bx]
                mb[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = rr.idct_4x4(d)
            self._put_mb(addr, mbx, mby, 1 + comp,
                         rr.clip1(pred + mb, self.mx).astype(self.pxdtype), chroma=True)

    # --------------------------------------------------------------- Chroma

    def _chroma_pred(self, addr, mbx, mby):
        """Intra chroma prediction (8.3.4) for both components (SI path)."""
        ft = self.ft
        x0, y0 = mbx * 8, mby * 8
        have_l = self._mb_avail_intra(addr - 1, addr) and mbx > 0
        have_t = self._mb_avail_intra(addr - ft.mb_w, addr) and mby > 0
        mode = int(ft.chroma_mode[addr])
        preds = []
        for plane in (self.cb, self.cr):
            left = plane[y0 : y0 + 8, x0 - 1].astype(np.int32) if have_l else None
            top = plane[y0 - 1, x0 : x0 + 8].astype(np.int32) if have_t else None
            corner = int(plane[y0 - 1, x0 - 1]) if (have_l and have_t) else None
            preds.append(rr.intra_chroma_predict(mode, left, top, corner, None,
                                                 mid=self.mid, mx=self.mx))
        return preds[0], preds[1]

    def _chroma_dc_grid(self, addr, comp):
        """Chroma DC levels as the spatial DC array: 2x2 raster (4:2:0) or
        the spec 8.5.4 4x2 inverse scan (4:2:2)."""
        dc_scan = self.ft.chroma_dc[addr, comp].astype(np.int32)
        if self.cf == 2:
            from ..tensors.frame_tensors import CHROMA422_DC_SCAN

            c = np.zeros((4, 2), np.int32)
            for k, (i, j) in enumerate(CHROMA422_DC_SCAN):
                c[i, j] = dc_scan[k]
            return c
        return dc_scan.reshape(2, 2)  # raster scan per 8.5.11 note

    def _chroma_dc_deq(self, cgrid, ls_idx, ls, qpc):
        """Dequantized chroma DC grid for either chroma format."""
        if self.cf == 2:
            return rr.chroma_dc_dequant_422(cgrid, self.ls4[ls_idx], qpc)
        return rr.chroma_dc_dequant(cgrid, int(ls[0, 0]), qpc)

    def _recon_chroma(self, addr, mbx, mby):
        ft, pps = self.ft, self.pps
        if self.sps.chroma_array_type not in (1, 2):
            # mono: nothing; 4:4:4: Cb/Cr already reconstructed luma-style
            # inside the per-component intra walkers
            return
        qp_y = int(ft.qp[addr])
        ch = self.ch
        x0, y0 = mbx * 8, mby * ch
        have_l = self._mb_avail_intra(addr - 1, addr) and mbx > 0
        have_t = self._mb_avail_intra(addr - ft.mb_w, addr) and mby > 0
        mode = int(ft.chroma_mode[addr])
        for comp, (plane, qp_off, ls_idx) in enumerate(
            [
                (self.cb, pps.chroma_qp_index_offset, 1),
                (self.cr, pps.second_chroma_qp_index_offset, 2),
            ]
        ):
            qpc = rr.chroma_qp(qp_y, qp_off, self.qp_off_c)
            ls = self.ls4[ls_idx][qpc % 6]  # lists 1/2: Intra Cb/Cr
            if self._grid is not None:
                left, top, corner = self._refs_mbaff_line(
                    addr, 8, 0, 0, plane_idx=1 + comp, chroma=True,
                    n_left=ch
                )
                if left is None or top is None:
                    corner = None
            else:
                left = plane[y0 : y0 + ch, x0 - 1].astype(np.int32) if have_l else None
                top = plane[y0 - 1, x0 : x0 + 8].astype(np.int32) if have_t else None
                corner = int(plane[y0 - 1, x0 - 1]) if (have_l and have_t) else None
            pred = rr.intra_chroma_predict(mode, left, top, corner, None, h=ch,
                                           mid=self.mid, mx=self.mx)
            cdc = self._chroma_dc_grid(addr, comp)
            mb = np.zeros((ch, 8), np.int32)
            if self.cf == 1 and self._bypass(addr) and qpc == 0:
                for blk in range(4):
                    bx, by = CHROMA_BLK_XY[blk]
                    c = self._dz4(addr, ft.chroma_ac[addr, comp, blk].astype(np.int32))
                    c[0, 0] = cdc[by, bx]
                    mb[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = c
                # chroma modes: 1 horizontal, 2 vertical (8.3.4 numbering)
                dmode = 1 if mode == 1 else (0 if mode == 2 else -1)
                blkpx = rr.clip1(self._dpcm(pred, mb, dmode), self.mx).astype(self.pxdtype)
                if self._grid is not None:
                    self._put_block(addr, 0, 0, blkpx, 1 + comp, chroma=True)
                else:
                    plane[y0 : y0 + ch, x0 : x0 + 8] = blkpx
                continue
            dcc = self._chroma_dc_deq(cdc, ls_idx, ls, qpc)
            for blk in range(ft.ch_blks):
                bx, by = ft.ch_blk_xy[blk]
                c = self._dz4(addr, ft.chroma_ac[addr, comp, blk].astype(np.int32))
                d = rr.dequant_4x4_ac(c, ls, qpc)
                d[0, 0] = dcc[by, bx]
                mb[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = rr.idct_4x4(d)
            blkpx = rr.clip1(pred + mb, self.mx).astype(self.pxdtype)
            if self._grid is not None:
                self._put_block(addr, 0, 0, blkpx, 1 + comp, chroma=True)
            else:
                plane[y0 : y0 + ch, x0 : x0 + 8] = blkpx
