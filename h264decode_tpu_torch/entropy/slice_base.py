"""Entropy-agnostic slice decoding machinery shared by the CAVLC and CABAC
slice decoders: neighbor availability, intra-mode prediction, QP chaining,
motion storage, skip/direct macroblocks.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.bitreader import BitReader
from ..syntax.pps import PPS
from ..syntax.slice_header import SliceHeader
from ..syntax.sps import SPS
from ..tensors.frame_tensors import (
    MB_B_SKIP,
    MB_P_SKIP,
    MB_SI,
    FrameTensors,
)
from .direct import DirectContext, derive_direct
from .mv_pred import MotionContext

# (partition shape tag, cell offsets/sizes) for 16x16 / 16x8 / 8x16
P_PARTS = {
    0: ("", ((0, 0, 4, 4),)),
    1: ("16x8", ((0, 0, 4, 2), (0, 2, 4, 2))),
    2: ("8x16", ((0, 0, 2, 4), (2, 0, 2, 4))),
}
# sub partition geometry: 0=8x8, 1=8x4, 2=4x8, 3=4x4 -> (dx, dy, w, h) cells
SUB_PARTS = {
    0: ((0, 0, 2, 2),),
    1: ((0, 0, 2, 1), (0, 1, 2, 1)),
    2: ((0, 0, 1, 2), (1, 0, 1, 2)),
    3: ((0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)),
}

# B mb_type (Table 7-14), types 1..21: pred masks (1=L0, 2=L1, 3=BI)
B_16x16 = {1: 1, 2: 2, 3: 3}
B_TWO_PART = {
    4: ("16x8", (1, 1)), 5: ("8x16", (1, 1)),
    6: ("16x8", (2, 2)), 7: ("8x16", (2, 2)),
    8: ("16x8", (1, 2)), 9: ("8x16", (1, 2)),
    10: ("16x8", (2, 1)), 11: ("8x16", (2, 1)),
    12: ("16x8", (1, 3)), 13: ("8x16", (1, 3)),
    14: ("16x8", (2, 3)), 15: ("8x16", (2, 3)),
    16: ("16x8", (3, 1)), 17: ("8x16", (3, 1)),
    18: ("16x8", (3, 2)), 19: ("8x16", (3, 2)),
    20: ("16x8", (3, 3)), 21: ("8x16", (3, 3)),
}
# B sub_mb_type (Table 7-18): (pred mask or None=direct, geometry key)
B_SUB = {
    0: (None, 0),
    1: (1, 0), 2: (2, 0), 3: (3, 0),
    4: (1, 1), 5: (1, 2),
    6: (2, 1), 7: (2, 2),
    8: (3, 1), 9: (3, 2),
    10: (1, 3), 11: (2, 3), 12: (3, 3),
}


class SliceDecoderBase:
    """Shared state + semantics for one slice's macroblock decoding."""

    def __init__(
        self,
        ft: FrameTensors,
        hdr: SliceHeader,
        sps: SPS,
        pps: PPS,
        r: BitReader,
        slice_id: int,
        mb_map: np.ndarray,
        intra_mode_grid: np.ndarray,
        motion: MotionContext | None = None,
        ref_uids_l0: list[int] | None = None,
        ref_uids_l1: list[int] | None = None,
        direct_ctx: DirectContext | None = None,
    ):
        self.ft = ft
        self.hdr = hdr
        self.sps = sps
        self.pps = pps
        self.r = r
        self.slice_id = slice_id
        self.mb_map = mb_map
        self.motion = motion
        if motion is not None:
            motion.cur_slice = slice_id
        self.ref_uids_l0 = ref_uids_l0 or []
        self.ref_uids_l1 = ref_uids_l1 or []
        self.direct_ctx = direct_ctx
        # [4h, 4w] int8: Intra4x4/8x8 mode per cell, -1 = not intra-NxN;
        # shared per frame, gated by availability
        self.modes = intra_mode_grid
        self.qp_prev = hdr.slice_qp(pps)
        # spec 7-37: QP wraps over [-QpBdOffsetY, 51] for high bit depths
        self.qp_bd_offset = 6 * (sps.bit_depth_luma - 8)
        self.chroma12 = sps.chroma_array_type in (1, 2)
        # data partitioning (7.4.1: syntax categories 2/3/4): category-2
        # elements read from `r` (partition A or the whole slice); residual
        # elements from the intra (B) / inter (C) partition readers. For
        # ordinary slices all three are the same reader. A missing B/C
        # partition leaves None: referencing it raises rather than
        # mis-decoding (partitions may legitimately be absent when no MB
        # needs them).
        dp = getattr(hdr, "dp_readers", None)
        if dp is None:
            self.r_intra = self.r_inter = r
        else:
            self.r_intra = dp.get(3)
            self.r_inter = dp.get(4)
        self.res_r = self.r_intra if (hdr.is_i or hdr.is_si) else r

    # ------------------------------------------------------------ neighbors

    def _mb_available(self, naddr: int) -> bool:
        """spec 6.4.9: neighbor must exist, be decoded, and share the slice."""
        return 0 <= naddr < self.ft.n_mbs and self.ft.slice_id[naddr] == self.slice_id

    def _nbr_grid(self):
        """6.4.10 MBAFF neighbor-location mapper (lazy; MBAFF slices only)."""
        g = getattr(self, "_nbr_grid_", None)
        if g is None:
            from ..syntax.mbaff_nbr import MbaffGrid

            ft = self.ft
            g = self._nbr_grid_ = MbaffGrid(
                ft.mb_w,
                ft.mb_h,
                field_at=self._field_at_for_nbr,
                avail=self._mb_available,
                ch_h=ft.ch_mb_h,
            )
        return g

    def _field_at_for_nbr(self, sp: int) -> bool:
        """mb_field flag feeding 6.4.10 derivation. The CABAC decoder
        overrides this with the 7.4.4 inference for the current pair when
        mb_skip_flag precedes mb_field_decoding_flag."""
        return bool(self.ft.mb_field[sp])

    def _pred_intra4x4_mode_mbaff(self, addr: int, x0: int, y0: int) -> int:
        """8.3.1.1 for MBAFF slices: neighbors A/B via 6.4.10.4 in MB-local
        coordinates; the modes/nnz grids store each spatial MB's cells in
        its OWN local layout, so (naddr, xW, yW) indexes them directly."""
        g = self._nbr_grid()
        ft = self.ft

        def mode_nbr(xN, yN):
            naddr, xW, yW = g.neighbor(addr, xN, yN)
            if naddr < 0 or not self._mb_available(naddr):
                return -1
            cls = ft.mb_class[naddr]
            if (
                self.pps.constrained_intra_pred_flag
                and cls >= 3
                and cls != MB_SI
            ):
                return -1
            nmby, nmbx = divmod(naddr, ft.mb_w)
            m = self.modes[nmby * 4 + (yW >> 2), nmbx * 4 + (xW >> 2)]
            return 2 if m < 0 else int(m)

        pred = min(mode_nbr(x0 - 1, y0), mode_nbr(x0, y0 - 1))
        return 2 if pred < 0 else pred

    def _pred_intra4x4_mode(self, gx: int, gy: int) -> int:
        """spec 8.3.1.1. dcPredModePredictedFlag is global over BOTH
        neighbors: if either is unavailable (or CIP-barred), the prediction
        is DC — encoded here as -1 propagating through the min. Available
        non-Intra-NxN neighbors contribute DC(2)."""

        def mode_at(nx, ny):
            if nx < 0 or ny < 0:
                return -1
            naddr = (ny >> 2) * self.ft.mb_w + (nx >> 2)
            if not self._mb_available(naddr):
                return -1
            cls = self.ft.mb_class[naddr]
            if (
                self.pps.constrained_intra_pred_flag
                and cls >= 3
                and cls != MB_SI
            ):
                return -1  # inter neighbor barred by constrained_intra_pred
            m = self.modes[ny, nx]
            return 2 if m < 0 else int(m)  # non-Intra-NxN MB -> DC

        pred = min(mode_at(gx - 1, gy), mode_at(gx, gy - 1))
        return 2 if pred < 0 else pred

    def _update_qp(self, delta: int) -> int:
        # spec 7-37: QPy = ((prev + delta + 52 + 2*QpBdOffsetY)
        #                   % (52 + QpBdOffsetY)) - QpBdOffsetY
        off = self.qp_bd_offset
        self.qp_prev = (
            (self.qp_prev + delta + 52 + 2 * off) % (52 + off)
        ) - off
        return self.qp_prev

    # ------------------------------------------------------------------ MBAFF
    # MBAFF macroblock addresses scan pair-by-pair (spec 6.4.1 figure 6-6:
    # addr 2k = top MB, 2k+1 = bottom MB of pair k, pairs in raster order).
    # We map them to SPATIAL raster addresses so every per-MB tensor and
    # every spatial grid (nnz, motion, intra modes) keeps one indexing
    # scheme; for frame-coded pairs the spec's MBAFF neighbor derivation
    # (6.4.10) then coincides with the plain spatial neighbors these grids
    # already implement. The reference walks mb_field syntax but decodes
    # nothing (/root/reference/h264/slice.go:599-630).

    def _mbaff_spatial(self, mbaff_addr: int) -> int:
        """MBAFF decode address -> spatial raster MB address."""
        pair, bottom = divmod(mbaff_addr, 2)
        pr, pc = divmod(pair, self.ft.mb_w)
        return (2 * pr + bottom) * self.ft.mb_w + pc

    def _set_pair_field(self, top_spatial: int, flag: bool) -> None:
        """Record mb_field_decoding_flag for both MBs of a pair (7.4.4)."""
        self.ft.mb_field[top_spatial] = flag
        self.ft.mb_field[top_spatial + self.ft.mb_w] = flag

    def _infer_pair_field_flag(self, top_spatial: int) -> bool:
        """7.4.4: flag of a fully-skipped pair = left pair's, else above
        pair's, else 0 (availability per 6.4.9: same slice, in picture)."""
        ft = self.ft
        mby, mbx = divmod(top_spatial, ft.mb_w)
        if mbx > 0 and self._mb_available(top_spatial - 1):
            return bool(ft.mb_field[top_spatial - 1])
        if mby >= 2 and self._mb_available(top_spatial - 2 * ft.mb_w):
            return bool(ft.mb_field[top_spatial - 2 * ft.mb_w])
        return False

    def _decode_skip_mb(self, spatial_addr: int) -> None:
        """Skip decode shared by the MBAFF walkers (pair flag already set)."""
        if self.hdr.is_b:
            self._decode_b_skip(spatial_addr)
        else:
            self._decode_p_skip(spatial_addr)

    def _require_frame_mb(self, spatial_addr: int, what: str) -> None:
        """Field MBs inside an MBAFF frame need field-aware prediction
        (6.4.10 neighbor tables, 8.4.1.3.2 frame/field MV mixing); only
        I_PCM field MBs decode today. Gate hard instead of mis-decoding."""
        if self.hdr.mbaff_frame_flag and self.ft.mb_field[spatial_addr]:
            raise NotImplementedError(f"MBAFF field-pair {what}")

    # --------------------------------------------------------- motion store

    def _store_part(self, addr, dx, dy, w, h, mv, ref, lst=0):
        """Mirror a decoded partition into the FrameTensors SoA arrays.

        Field MBs (MBAFF) carry FIELD ref indices (8.4.2.1: index 2k is the
        same-parity field of frame-list entry k, 2k+1 the opposite); the
        referenced frame uid and field parity are resolved here so recon
        and deblock never re-derive list semantics."""
        ft = self.ft
        uids = self.ref_uids_l0 if lst == 0 else self.ref_uids_l1
        for cy in range(dy, dy + h):
            for cx in range(dx, dx + w):
                blk = cy * 4 + cx
                ft.mv[addr, lst, blk] = mv
        fld = self.hdr.mbaff_frame_flag and bool(ft.mb_field[addr])
        if fld and ref >= 0:
            mb_par = (addr // ft.mb_w) & 1
            frame_ref = ref >> 1
            parity = mb_par if (ref & 1) == 0 else 1 - mb_par
            uid = uids[frame_ref] if frame_ref < len(uids) else -1
        else:
            frame_ref = ref
            parity = -1
            uid = uids[ref] if 0 <= ref < len(uids) else -1
        for py in range(dy // 2, (dy + h + 1) // 2):
            for px in range(dx // 2, (dx + w + 1) // 2):
                part = py * 2 + px
                ft.ref_idx[addr, lst, part] = ref
                ft.pred_flags[addr, lst, part] = 1 if ref >= 0 else 0
                ft.ref_pic[addr, lst, part] = uid
                ft.ref_parity[addr, lst, part] = parity

    def _mb_prelude(self, addr: int) -> None:
        """Common per-MB bookkeeping before any syntax parsing."""
        ft = self.ft
        if self.hdr.mbaff_frame_flag and self.motion is not None:
            # rebind per slice: the grid's availability closure is this
            # slice decoder's (6.4.9 same-slice gating)
            self.motion.enable_mbaff(self._nbr_grid(), ft.mb_field)
            self.motion.begin_mb(addr)
        ft.slice_id[addr] = self.slice_id
        ft.sp_slice_mb[addr] = self.hdr.is_sp or self.hdr.is_si
        ft.decode_order.append(addr)
        ft.disable_deblock[addr] = self.hdr.disable_deblocking_filter_idc
        ft.alpha_off[addr] = self.hdr.slice_alpha_c0_offset_div2 * 2
        ft.beta_off[addr] = self.hdr.slice_beta_offset_div2 * 2

    # -------------------------------------------------------- skip / direct

    def _direct_quadrants(self, addr):
        """Direct MVs for this MB, spec 8.4.1.2."""
        mbx, mby = self.ft.mb_xy(addr)
        return derive_direct(self.motion, self.direct_ctx, mbx * 4, mby * 4)

    def _store_direct_quadrant(self, addr, cells):
        """Write one direct quadrant's cells into grids + tensors."""
        motion = self.motion
        for cx, cy, mv0, ref0, mv1, ref1 in cells:
            motion.direct[cy, cx] = True
            for lst, (mv, ref) in enumerate(((mv0, ref0), (mv1, ref1))):
                motion.set_cells(lst, cx, cy, 1, 1, mv, ref if ref >= 0 else -1)
                self._store_part(addr, cx % 4, cy % 4, 1, 1, mv, ref, lst)

    def _decode_p_skip(self, addr: int) -> None:
        """P_Skip macroblock (spec 8.4.1.1)."""
        ft = self.ft
        self._mb_prelude(addr)
        ft.mb_class[addr] = MB_P_SKIP
        ft.qp[addr] = self.qp_prev
        ft.cbp[addr] = 0
        mbx, mby = ft.mb_xy(addr)
        bx, by = mbx * 4, mby * 4
        mv = self.motion.skip_mv(bx, by)
        self.motion.set_cells(0, bx, by, 4, 4, mv, 0)
        self.motion.ref[1, by : by + 4, bx : bx + 4] = -1
        self.motion.refctx[1, by : by + 4, bx : bx + 4] = -1
        self._store_part(addr, 0, 0, 4, 4, mv, 0)
        ft.luma_nnz[by : by + 4, bx : bx + 4] = 0
        cr_ = ft.ch_rows
        ft.chroma_nnz[:, mby * cr_ : (mby + 1) * cr_, mbx * 2 : mbx * 2 + 2] = 0
        if ft.c444_nnz is not None:
            ft.c444_nnz[:, by : by + 4, bx : bx + 4] = 0

    def _decode_b_skip(self, addr: int) -> None:
        """B_Skip macroblock: direct prediction, no residual."""
        ft = self.ft
        self._mb_prelude(addr)
        ft.mb_class[addr] = MB_B_SKIP
        ft.qp[addr] = self.qp_prev
        ft.cbp[addr] = 0
        mbx, mby = ft.mb_xy(addr)
        for cells in self._direct_quadrants(addr):
            self._store_direct_quadrant(addr, cells)
        ft.luma_nnz[mby * 4 : mby * 4 + 4, mbx * 4 : mbx * 4 + 4] = 0
        cr_ = ft.ch_rows
        ft.chroma_nnz[:, mby * cr_ : (mby + 1) * cr_, mbx * 2 : mbx * 2 + 2] = 0
        if ft.c444_nnz is not None:
            ft.c444_nnz[:, mby * 4 : mby * 4 + 4, mbx * 4 : mbx * 4 + 4] = 0
