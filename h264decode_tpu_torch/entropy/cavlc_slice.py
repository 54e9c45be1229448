"""CAVLC slice-data decoder: slice_data() + macroblock_layer() (spec 7.3.4,
7.3.5) into FrameTensors.

Replaces the reference's interleaved per-MB walk (h264/slice.go:570-830) with
a full-slice entropy pass producing SoA tensors (SURVEY.md section 7.1), and
adds everything the reference lacks: residual parsing, nC context tracking,
I_PCM samples, QP accumulation, P/B motion syntax.

Pure-Python reference implementation; the native/ C++ engine is the fast path.
"""

from __future__ import annotations

import numpy as np

from ..syntax.fmo import next_mb_address
from ..tensors.frame_tensors import (
    CHROMA_BLK_XY,
    LUMA_BLK_XY,
    MB_B,
    MB_B_DIRECT,
    MB_I_16X16,
    MB_I_NXN,
    MB_I_PCM,
    MB_P,
    MB_SI,
)
from .cavlc import nc_from_neighbors, residual_block_cavlc
from .cavlc_tables import (
    CBP_ME_CHROMA03_INTER,
    CBP_ME_CHROMA03_INTRA,
    CBP_ME_CHROMA12_INTER,
    CBP_ME_CHROMA12_INTRA,
)
from .slice_base import (
    B_16x16,
    B_SUB,
    B_TWO_PART,
    P_PARTS,
    SUB_PARTS,
    SliceDecoderBase,
)


class CavlcSliceDecoder(SliceDecoderBase):
    """Decodes one slice's worth of macroblocks into the frame tensors."""

    # ---------------------------------------------------------- nC contexts

    def _luma_nnz_at(self, gx: int, gy: int):
        if gx < 0 or gy < 0:
            return None
        naddr = (gy >> 2) * self.ft.mb_w + (gx >> 2)
        if not self._mb_available(naddr):
            return None
        return int(self.ft.luma_nnz[gy, gx])

    def _chroma_nnz_at(self, comp: int, gx: int, gy: int):
        if gx < 0 or gy < 0:
            return None
        naddr = (gy // self.ft.ch_rows) * self.ft.mb_w + (gx >> 1)
        if not self._mb_available(naddr):
            return None
        return int(self.ft.chroma_nnz[comp, gy, gx])

    def luma_nc(self, gx: int, gy: int) -> int:
        if self.hdr.mbaff_frame_flag:
            return self._nc_mbaff(gx, gy, comp=None)
        return nc_from_neighbors(
            self._luma_nnz_at(gx - 1, gy), self._luma_nnz_at(gx, gy - 1)
        )

    def _c444_nnz_at(self, comp: int, gx: int, gy: int):
        """4:4:4 Cb/Cr (comp 1/2): same-component neighbor TotalCoeff on the
        luma-shaped per-component grid (spec 9.2.1 for ChromaArrayType 3)."""
        if gx < 0 or gy < 0:
            return None
        naddr = (gy >> 2) * self.ft.mb_w + (gx >> 2)
        if not self._mb_available(naddr):
            return None
        return int(self.ft.c444_nnz[comp - 1, gy, gx])

    def comp444_nc(self, comp: int, gx: int, gy: int) -> int:
        if comp == 0:
            return self.luma_nc(gx, gy)
        if self.hdr.mbaff_frame_flag:
            return self._nc_mbaff444(comp, gx, gy)
        return nc_from_neighbors(
            self._c444_nnz_at(comp, gx - 1, gy),
            self._c444_nnz_at(comp, gx, gy - 1),
        )

    def _nc_mbaff444(self, comp: int, gx: int, gy: int) -> int:
        """9.2.1 nC for 4:4:4 Cb/Cr in MBAFF slices: chroma blocks have
        LUMA geometry, so the 6.4.10 mapping runs in luma coordinates and
        indexes the per-component nnz grid."""
        g = self._nbr_grid()
        ft = self.ft
        addr = (gy >> 2) * ft.mb_w + (gx >> 2)
        x0, y0 = (gx & 3) * 4, (gy & 3) * 4

        def at(xN, yN):
            naddr, xW, yW = g.neighbor(addr, xN, yN, chroma=False)
            if naddr < 0 or not self._mb_available(naddr):
                return None
            nmby, nmbx = divmod(naddr, ft.mb_w)
            return int(
                ft.c444_nnz[comp - 1, nmby * 4 + (yW >> 2), nmbx * 4 + (xW >> 2)]
            )

        return nc_from_neighbors(at(x0 - 1, y0), at(x0, y0 - 1))

    def chroma_nc(self, comp: int, gx: int, gy: int) -> int:
        if self.hdr.mbaff_frame_flag:
            return self._nc_mbaff(gx, gy, comp=comp)
        return nc_from_neighbors(
            self._chroma_nnz_at(comp, gx - 1, gy), self._chroma_nnz_at(comp, gx, gy - 1)
        )

    def _nc_mbaff(self, gx: int, gy: int, comp) -> int:
        """9.2.1 nC for MBAFF slices: neighbor 4x4 blocks via the 6.4.10
        location mapper. (gx, gy) are the current block's cell coordinates
        in the repo-wide spatial-local grid layout; neighbor lookups convert
        to MB-local pixel locations, map, and index the nnz grids back in
        the neighbor's own local layout."""
        g = self._nbr_grid()
        ft = self.ft
        if comp is None:
            addr = (gy >> 2) * ft.mb_w + (gx >> 2)
            x0, y0 = (gx & 3) * 4, (gy & 3) * 4
            chroma = False
        else:
            cr_ = ft.ch_rows  # chroma 4x4-block rows per MB (2 / 4)
            addr = (gy // cr_) * ft.mb_w + (gx >> 1)
            x0, y0 = (gx & 1) * 4, (gy % cr_) * 4
            chroma = True

        def at(xN, yN):
            naddr, xW, yW = g.neighbor(addr, xN, yN, chroma=chroma)
            if naddr < 0 or not self._mb_available(naddr):
                return None
            nmby, nmbx = divmod(naddr, ft.mb_w)
            if comp is None:
                return int(ft.luma_nnz[nmby * 4 + (yW >> 2), nmbx * 4 + (xW >> 2)])
            return int(
                ft.chroma_nnz[
                    comp, nmby * ft.ch_rows + (yW >> 2), nmbx * 2 + (xW >> 2)
                ]
            )

        return nc_from_neighbors(at(x0 - 1, y0), at(x0, y0 - 1))

    # ------------------------------------------------------------- main loop

    def decode(self) -> None:
        """slice_data(), spec 7.3.4 (CAVLC branch)."""
        if self.hdr.mbaff_frame_flag:
            return self._decode_mbaff()
        hdr, r = self.hdr, self.r
        n = self.ft.n_mbs
        addr = hdr.first_mb_in_slice
        is_inter_slice = not (hdr.is_i or hdr.is_si)
        while True:
            if is_inter_slice:
                skip_run = r.ue()
                for _ in range(skip_run):
                    if addr >= n:
                        raise ValueError("skip run overruns picture")
                    if hdr.is_b:
                        self._decode_b_skip(addr)
                    else:
                        self._decode_p_skip(addr)
                    addr = next_mb_address(self.mb_map, addr)
                if not r.more_rbsp_data():
                    break
            if addr >= n:
                raise ValueError("slice overruns picture")
            self.parse_macroblock(addr)
            if not r.more_rbsp_data():
                break
            addr = next_mb_address(self.mb_map, addr)

    def _decode_mbaff(self) -> None:
        """slice_data() for an MBAFF frame (7.3.4 with MbaffFrameFlag=1).

        mb_field_decoding_flag is read before the top MB of each pair, or
        before the bottom MB when the top was skipped (prevMbSkipped); a
        fully-skipped pair infers it per 7.4.4. A skipped TOP MB defers its
        reconstruction until the pair's flag is known (the flag selects
        frame- vs field-MV prediction) — still ahead of the bottom MB, so
        neighbor-dependent derivations see pairs complete in order."""
        hdr, r, ft = self.hdr, self.r, self.ft
        n = ft.n_mbs
        addr_m = hdr.first_mb_in_slice * 2  # 7.4.3: CurrMbAddr scaling
        is_inter_slice = not (hdr.is_i or hdr.is_si)
        pending_top_skip = None  # spatial addr awaiting its pair's flag
        prev_skipped = False

        def flush_pending(infer: bool):
            nonlocal pending_top_skip
            if pending_top_skip is None:
                return
            if infer:
                self._set_pair_field(
                    pending_top_skip, self._infer_pair_field_flag(pending_top_skip)
                )
            self._decode_skip_mb(pending_top_skip)
            pending_top_skip = None

        while True:
            if is_inter_slice:
                skip_run = r.ue()
                for _ in range(skip_run):
                    if addr_m >= n:
                        raise ValueError("skip run overruns picture")
                    sp = self._mbaff_spatial(addr_m)
                    if addr_m % 2 == 0:
                        pending_top_skip = sp
                    else:
                        flush_pending(infer=True)  # whole pair skipped
                        self._decode_skip_mb(sp)
                    addr_m = next_mb_address(self.mb_map, addr_m)
                prev_skipped = skip_run > 0
                if not r.more_rbsp_data():
                    flush_pending(infer=True)
                    break
            if addr_m >= n:
                raise ValueError("slice overruns picture")
            sp = self._mbaff_spatial(addr_m)
            top = sp - ft.mb_w if addr_m % 2 else sp
            if addr_m % 2 == 0 or prev_skipped:
                self._set_pair_field(top, r.flag())  # mb_field_decoding_flag
            flush_pending(infer=False)
            self.parse_macroblock(sp)
            prev_skipped = False
            if not r.more_rbsp_data():
                break
            addr_m = next_mb_address(self.mb_map, addr_m)

    # ------------------------------------------------------ macroblock layer

    def parse_macroblock(self, addr: int) -> None:
        ft, r = self.ft, self.r
        self._mb_prelude(addr)
        mb_type = r.ue()
        if self.hdr.is_si:
            # Table 7-12: mb_type 0 = SI; >= 1 follows Table 7-11 offset 1
            if mb_type == 0:
                self._parse_si_mb(addr)
            else:
                self._parse_i_mb(addr, mb_type - 1)
            if self.motion is not None:
                mbx, mby = ft.mb_xy(addr)
                self.motion.set_intra(mbx * 4, mby * 4)
        elif self.hdr.is_i:
            # Table 7-11 (I-slice mb_type)
            self._parse_i_mb(addr, mb_type)
            if self.motion is not None:
                mbx, mby = ft.mb_xy(addr)
                self.motion.set_intra(mbx * 4, mby * 4)
        elif self.hdr.is_b:
            # Table 7-14: B mb_type 0..22 inter, >=23 intra (offset 23)
            if mb_type >= 23:
                self._parse_i_mb(addr, mb_type - 23)
                mbx, mby = ft.mb_xy(addr)
                self.motion.set_intra(mbx * 4, mby * 4)
            else:
                self._parse_b_mb(addr, mb_type)
        else:
            # Table 7-13: P mb_type 0..4 inter, >=5 intra (offset 5)
            if mb_type >= 5:
                self._parse_i_mb(addr, mb_type - 5)
                mbx, mby = ft.mb_xy(addr)
                self.motion.set_intra(mbx * 4, mby * 4)
            else:
                self._parse_p_mb(addr, mb_type)

    def _res_reader(self, intra: bool):
        """Residual reader by syntax category (3 = intra, 4 = inter). May be
        None (absent partition): raising is deferred to first actual read —
        a partition is legitimately absent when no MB needs it."""
        return self.r_intra if intra else self.r_inter

    def _need_res_r(self):
        if self.res_r is None:
            raise ValueError("data partition B/C missing but residual coded")
        return self.res_r

    def _parse_i_mb(self, addr: int, mb_type: int) -> None:
        ft, r = self.ft, self.r
        self.res_r = self._res_reader(intra=True)
        mbx, mby = ft.mb_xy(addr)
        if mb_type == 25:  # I_PCM
            self._parse_pcm(addr)
            return
        if mb_type == 0:  # I_NxN
            ft.mb_class[addr] = MB_I_NXN
            t8 = False
            if self.pps.transform_8x8_mode_flag:
                t8 = r.flag()
            ft.transform_8x8[addr] = t8
            self._parse_intra_nxn_modes(addr, mbx, mby, t8)
            if self.sps.chroma_array_type in (1, 2):
                ft.chroma_mode[addr] = r.ue()
            cbp_code = r.ue()
            tab = CBP_ME_CHROMA12_INTRA if self.chroma12 else CBP_ME_CHROMA03_INTRA
            cbp = tab[cbp_code]
            ft.cbp[addr] = cbp
            if cbp:
                ft.qp[addr] = self._update_qp(r.se())
            else:
                ft.qp[addr] = self.qp_prev
            self._parse_luma_residual(addr, mbx, mby, cbp & 15, i16=False, t8=t8)
            self._parse_chroma_residual(addr, mbx, mby, cbp >> 4,
                                        cbp_luma=cbp & 15, t8=t8)
        else:  # I_16x16: mb_type 1..24, Table 7-11 derivation
            ft.mb_class[addr] = MB_I_16X16
            k = mb_type - 1
            ft.intra16_mode[addr] = k % 4
            cbp_chroma = (k // 4) % 3
            cbp_luma = 15 if k >= 12 else 0
            ft.cbp[addr] = cbp_luma | (cbp_chroma << 4)
            if self.sps.chroma_array_type in (1, 2):
                ft.chroma_mode[addr] = r.ue()
            ft.qp[addr] = self._update_qp(r.se())
            # Intra16x16DCLevel: nC as for luma4x4BlkIdx 0 (spec 9.2.1)
            nc = self.luma_nc(mbx * 4, mby * 4)
            coeffs, _ = residual_block_cavlc(self._need_res_r(), 0, 15, 16, nc)
            ft.luma_dc[addr] = coeffs
            self._parse_luma_residual(addr, mbx, mby, cbp_luma, i16=True, t8=False)
            self._parse_chroma_residual(addr, mbx, mby, cbp_chroma,
                                        cbp_luma=cbp_luma, i16=True)
        # non-NxN MBs leave the intra-mode grid at -1 ("predict DC from me")

    def _parse_si_mb(self, addr: int) -> None:
        """SI macroblock (Table 7-12 mb_type 0): Intra_4x4 prediction syntax;
        reconstruction runs the 8.6.2 chain (pipeline/intra_frame.py)."""
        ft, r = self.ft, self.r
        self.res_r = self._res_reader(intra=True)
        mbx, mby = ft.mb_xy(addr)
        ft.mb_class[addr] = MB_SI
        self._parse_intra_nxn_modes(addr, mbx, mby, False)
        if self.sps.chroma_array_type in (1, 2):
            ft.chroma_mode[addr] = r.ue()
        cbp_code = r.ue()
        tab = CBP_ME_CHROMA12_INTRA if self.chroma12 else CBP_ME_CHROMA03_INTRA
        cbp = tab[cbp_code]
        ft.cbp[addr] = cbp
        if cbp:
            ft.qp[addr] = self._update_qp(r.se())
        else:
            ft.qp[addr] = self.qp_prev
        self._parse_luma_residual(addr, mbx, mby, cbp & 15, i16=False, t8=False)
        self._parse_chroma_residual(addr, mbx, mby, cbp >> 4)

    def _parse_pcm(self, addr: int) -> None:
        ft = self.ft
        r = self._need_res_r()  # pcm_sample_* are category 3 (partition B)
        ft.mb_class[addr] = MB_I_PCM
        r.align()  # pcm_alignment_zero_bit
        bdl = self.sps.bit_depth_luma
        bdc = self.sps.bit_depth_chroma
        ydt = np.uint16 if bdl > 8 else np.uint8
        cdt = np.uint16 if bdc > 8 else np.uint8
        y = np.array([r.u(bdl) for _ in range(256)], ydt).reshape(16, 16)
        if self.sps.chroma_array_type in (1, 2):
            ch = ft.ch_mb_h
            cb = np.array([r.u(bdc) for _ in range(ch * 8)], cdt).reshape(ch, 8)
            cr = np.array([r.u(bdc) for _ in range(ch * 8)], cdt).reshape(ch, 8)
        elif self.sps.chroma_array_type == 3:  # full-resolution chroma
            cb = np.array([r.u(bdc) for _ in range(256)], cdt).reshape(16, 16)
            cr = np.array([r.u(bdc) for _ in range(256)], cdt).reshape(16, 16)
        else:
            cb = cr = np.zeros((8, 8), np.uint8)
        ft.pcm_samples[addr] = (y, cb, cr)
        # deblock treats I_PCM as QP 0 (spec 8.7.2); QPy,prev carries over
        ft.qp[addr] = 0
        mbx, mby = ft.mb_xy(addr)
        # spec 9.2.1: PCM neighbors count as TotalCoeff 16
        ft.luma_nnz[mby * 4 : mby * 4 + 4, mbx * 4 : mbx * 4 + 4] = 16
        cr_ = ft.ch_rows
        ft.chroma_nnz[:, mby * cr_ : (mby + 1) * cr_, mbx * 2 : mbx * 2 + 2] = 16
        if ft.c444_nnz is not None:
            ft.c444_nnz[:, mby * 4 : mby * 4 + 4, mbx * 4 : mbx * 4 + 4] = 16

    def _parse_intra_nxn_modes(self, addr: int, mbx: int, mby: int, t8: bool) -> None:
        ft, r = self.ft, self.r
        mbaff = self.hdr.mbaff_frame_flag
        if t8:
            for b8 in range(4):
                bx, by = b8 % 2, b8 // 2
                gx, gy = mbx * 4 + bx * 2, mby * 4 + by * 2
                pred = (
                    self._pred_intra4x4_mode_mbaff(addr, bx * 8, by * 8)
                    if mbaff
                    else self._pred_intra4x4_mode(gx, gy)
                )
                if r.flag():  # prev_intra8x8_pred_mode_flag
                    mode = pred
                else:
                    rem = r.u(3)
                    mode = rem if rem < pred else rem + 1
                ft.intra4x4_modes[addr, b8] = mode
                self.modes[gy : gy + 2, gx : gx + 2] = mode
        else:
            for blk in range(16):
                bx, by = LUMA_BLK_XY[blk]
                gx, gy = mbx * 4 + bx, mby * 4 + by
                pred = (
                    self._pred_intra4x4_mode_mbaff(addr, bx * 4, by * 4)
                    if mbaff
                    else self._pred_intra4x4_mode(gx, gy)
                )
                if r.flag():  # prev_intra4x4_pred_mode_flag
                    mode = pred
                else:
                    rem = r.u(3)
                    mode = rem if rem < pred else rem + 1
                ft.intra4x4_modes[addr, blk] = mode
                self.modes[gy, gx] = mode

    # ------------------------------------------------------------ P slices

    def _parse_p_mb(self, addr: int, mb_type: int) -> None:
        """P macroblock, spec 7.3.5.1/7.3.5.2 + 8.4.1.3 MV reconstruction."""
        ft, r = self.ft, self.r
        self.res_r = self._res_reader(intra=False)
        mbx, mby = ft.mb_xy(addr)
        bx0, by0 = mbx * 4, mby * 4
        ft.mb_class[addr] = MB_P
        # 7.4.5.1: a field MB indexes a per-field list of twice the size
        n_ref = (self.hdr.num_ref_idx_l0_active_minus1 + 1) * (
            2 if (self.hdr.mbaff_frame_flag and ft.mb_field[addr]) else 1
        )
        motion = self.motion
        motion.ref[1, by0 : by0 + 4, bx0 : bx0 + 4] = -1
        motion.refctx[1, by0 : by0 + 4, bx0 : bx0 + 4] = -1
        ft.pred_flags[addr, 0] = 1
        sub_types = None
        if mb_type in (0, 1, 2):
            shape, parts = P_PARTS[mb_type]
            refs = []
            for _ in parts:
                refs.append(r.te(n_ref - 1) if n_ref > 1 else 0)
            for idx, ((dx, dy, w, h), ref) in enumerate(zip(parts, refs)):
                mvd = (r.se(), r.se())
                bx, by = bx0 + dx, by0 + dy
                px, py = motion.predict(0, ref, bx, by, w, h, shape, idx)
                mv = (px + mvd[0], py + mvd[1])
                motion.set_cells(0, bx, by, w, h, mv, ref)
                self._store_part(addr, dx, dy, w, h, mv, ref)
        else:  # P_8x8 / P_8x8ref0
            sub_types = [r.ue() for _ in range(4)]
            if any(t > 3 for t in sub_types):
                raise ValueError(f"invalid P sub_mb_type {sub_types}")
            refs = [0] * 4
            if mb_type == 3 and n_ref > 1:
                refs = [r.te(n_ref - 1) for _ in range(4)]
            mvds = [
                [(r.se(), r.se()) for _ in SUB_PARTS[sub_types[i]]] for i in range(4)
            ]
            for i8 in range(4):
                odx, ody = (i8 % 2) * 2, (i8 // 2) * 2
                for sp, mvd in zip(SUB_PARTS[sub_types[i8]], mvds[i8]):
                    dx, dy, w, h = sp
                    bx, by = bx0 + odx + dx, by0 + ody + dy
                    px, py = motion.predict(0, refs[i8], bx, by, w, h)
                    mv = (px + mvd[0], py + mvd[1])
                    motion.set_cells(0, bx, by, w, h, mv, refs[i8])
                    self._store_part(addr, odx + dx, ody + dy, w, h, mv, refs[i8])
        # --- cbp, transform size, qp, residual (spec 7.3.5)
        cbp_code = r.ue()
        tab = CBP_ME_CHROMA12_INTER if self.chroma12 else CBP_ME_CHROMA03_INTER
        cbp = tab[cbp_code]
        ft.cbp[addr] = cbp
        t8 = False
        if (
            (cbp & 15)
            and self.pps.transform_8x8_mode_flag
            and (mb_type in (0, 1, 2) or all(t == 0 for t in sub_types))
        ):
            t8 = r.flag()
        ft.transform_8x8[addr] = t8
        if cbp:
            ft.qp[addr] = self._update_qp(r.se())
        else:
            ft.qp[addr] = self.qp_prev
        self._parse_luma_residual(addr, mbx, mby, cbp & 15, i16=False, t8=t8)
        self._parse_chroma_residual(addr, mbx, mby, cbp >> 4,
                                    cbp_luma=cbp & 15, t8=t8)

    # ------------------------------------------------------------ B slices

    def _parse_b_mb(self, addr: int, mb_type: int) -> None:
        """B macroblock, Table 7-14 + spec 7.3.5.1/7.3.5.2 + 8.4.1."""
        ft, r = self.ft, self.r
        self.res_r = self._res_reader(intra=False)
        mbx, mby = ft.mb_xy(addr)
        bx0, by0 = mbx * 4, mby * 4
        motion = self.motion
        _fx = 2 if (self.hdr.mbaff_frame_flag and ft.mb_field[addr]) else 1
        n_ref = (
            (self.hdr.num_ref_idx_l0_active_minus1 + 1) * _fx,
            (self.hdr.num_ref_idx_l1_active_minus1 + 1) * _fx,
        )
        no_sub_lt_8x8 = True
        if mb_type == 0:  # B_Direct_16x16
            ft.mb_class[addr] = MB_B_DIRECT
            for cells in self._direct_quadrants(addr):
                self._store_direct_quadrant(addr, cells)
            no_sub_lt_8x8 = self.sps.direct_8x8_inference_flag
        elif mb_type <= 21:
            ft.mb_class[addr] = MB_B
            if mb_type <= 3:
                shape, parts, masks = "", ((0, 0, 4, 4),), (B_16x16[mb_type],)
            else:
                shape, masks = B_TWO_PART[mb_type]
                parts = P_PARTS[1][1] if shape == "16x8" else P_PARTS[2][1]
            refs = {0: [0] * len(parts), 1: [0] * len(parts)}
            for lst in range(2):
                for i, mask in enumerate(masks):
                    if mask & (lst + 1) and n_ref[lst] > 1:
                        refs[lst][i] = r.te(n_ref[lst] - 1)
            mvds = {0: [None] * len(parts), 1: [None] * len(parts)}
            for lst in range(2):
                for i, mask in enumerate(masks):
                    if mask & (lst + 1):
                        mvds[lst][i] = (r.se(), r.se())
            for i, ((dx, dy, w, h), mask) in enumerate(zip(parts, masks)):
                bx, by = bx0 + dx, by0 + dy
                for lst in range(2):
                    if mask & (lst + 1):
                        px, py = motion.predict(lst, refs[lst][i], bx, by, w, h, shape, i)
                        mv = (px + mvds[lst][i][0], py + mvds[lst][i][1])
                        motion.set_cells(lst, bx, by, w, h, mv, refs[lst][i])
                        self._store_part(addr, dx, dy, w, h, mv, refs[lst][i], lst)
                    else:
                        motion.set_cells(lst, bx, by, w, h, (0, 0), -1)
                        self._store_part(addr, dx, dy, w, h, (0, 0), -1, lst)
        else:  # B_8x8
            ft.mb_class[addr] = MB_B
            sub_types = [r.ue() for _ in range(4)]
            if any(t > 12 for t in sub_types):
                raise ValueError(f"invalid B sub_mb_type {sub_types}")
            refs = {0: [0] * 4, 1: [0] * 4}
            for lst in range(2):
                for i8 in range(4):
                    mask, _ = B_SUB[sub_types[i8]]
                    if mask is not None and mask & (lst + 1) and n_ref[lst] > 1:
                        refs[lst][i8] = r.te(n_ref[lst] - 1)
            mvds = {0: [[] for _ in range(4)], 1: [[] for _ in range(4)]}
            for lst in range(2):
                for i8 in range(4):
                    mask, geom = B_SUB[sub_types[i8]]
                    if mask is not None and mask & (lst + 1):
                        mvds[lst][i8] = [(r.se(), r.se()) for _ in SUB_PARTS[geom]]
            direct_q = None
            for i8 in range(4):
                mask, geom = B_SUB[sub_types[i8]]
                odx, ody = (i8 % 2) * 2, (i8 // 2) * 2
                if mask is None:  # B_Direct_8x8
                    if direct_q is None:
                        direct_q = self._direct_quadrants(addr)
                    self._store_direct_quadrant(addr, direct_q[i8])
                    if not self.sps.direct_8x8_inference_flag:
                        no_sub_lt_8x8 = False
                    continue
                if geom != 0:
                    no_sub_lt_8x8 = False
                for lst in range(2):
                    if mask & (lst + 1):
                        for sp, mvd in zip(SUB_PARTS[geom], mvds[lst][i8]):
                            dx, dy, w, h = sp
                            bx, by = bx0 + odx + dx, by0 + ody + dy
                            px, py = motion.predict(lst, refs[lst][i8], bx, by, w, h)
                            mv = (px + mvd[0], py + mvd[1])
                            motion.set_cells(lst, bx, by, w, h, mv, refs[lst][i8])
                            self._store_part(addr, odx + dx, ody + dy, w, h, mv, refs[lst][i8], lst)
                    else:
                        bx, by = bx0 + odx, by0 + ody
                        motion.set_cells(lst, bx, by, 2, 2, (0, 0), -1)
                        self._store_part(addr, odx, ody, 2, 2, (0, 0), -1, lst)
        # --- cbp, transform size, qp, residual
        cbp_code = r.ue()
        tab = CBP_ME_CHROMA12_INTER if self.chroma12 else CBP_ME_CHROMA03_INTER
        cbp = tab[cbp_code]
        ft.cbp[addr] = cbp
        t8 = False
        if (cbp & 15) and self.pps.transform_8x8_mode_flag and no_sub_lt_8x8:
            t8 = r.flag()
        ft.transform_8x8[addr] = t8
        if cbp:
            ft.qp[addr] = self._update_qp(r.se())
        else:
            ft.qp[addr] = self.qp_prev
        self._parse_luma_residual(addr, mbx, mby, cbp & 15, i16=False, t8=t8)
        self._parse_chroma_residual(addr, mbx, mby, cbp >> 4,
                                    cbp_luma=cbp & 15, t8=t8)

    # ----------------------------------------------------------- residuals

    def _parse_luma_residual(
        self, addr: int, mbx: int, mby: int, cbp_luma: int, *, i16: bool,
        t8: bool, comp: int = 0
    ) -> None:
        """residual_luma(), spec 7.3.5.3.1. For CAVLC + transform_8x8 the
        8x8 block is sent as 4 interleaved 4x4 CAVLC blocks
        (coeff k of partition i -> 8x8 scan position 4k+i, spec 8.5.6 note).
        `comp` 0 = luma; 1/2 = Cb/Cr under ChromaArrayType 3, which code
        chroma with this same luma process per component."""
        ft = self.ft
        # residual levels are syntax category 3/4: partition B/C under data
        # partitioning (7.4.1); same reader as `r` for ordinary slices
        r = self._need_res_r() if cbp_luma else None
        # AC blocks occupy scan positions 1..15 of a 16-slot array; the
        # max_num_coeff arg only selects the total_zeros table family (4x4)
        start = 1 if i16 else 0
        maxc = 16
        if comp == 0:
            nnz = ft.luma_nnz
            ac = ft.luma_ac[addr]
            l8 = ft.ensure_luma8()[addr] if t8 else None
        else:
            nnz = ft.c444_nnz[comp - 1]
            ac = ft.c444_ac[addr, comp - 1]
            l8 = ft.ensure_c444_8x8()[addr, comp - 1] if t8 else None
        for b8 in range(4):
            coded = cbp_luma & (1 << b8)
            for i4 in range(4):
                blk = b8 * 4 + i4
                bx, by = LUMA_BLK_XY[blk]
                gx, gy = mbx * 4 + bx, mby * 4 + by
                if not coded:
                    nnz[gy, gx] = 0
                    continue
                nc = self.comp444_nc(comp, gx, gy)
                coeffs, total = residual_block_cavlc(r, start, 15, maxc, nc)
                nnz[gy, gx] = total
                if t8:
                    for k in range(16):
                        l8[b8, 4 * k + i4] = coeffs[k]
                else:
                    ac[blk] = coeffs

    def _parse_chroma_residual(self, addr: int, mbx: int, mby: int, cbp_chroma: int,
                               *, cbp_luma: int = 0, i16: bool = False,
                               t8: bool = False):
        """residual chroma part of 7.3.5.3.3 (ChromaArrayType 1 and 2;
        4:2:2 codes 8-coefficient DC blocks with the nC == -2 VLC).
        ChromaArrayType 3 instead routes each component through the
        residual_luma process (7.3.5.3.1), gated by the LUMA cbp bits."""
        if self.sps.chroma_array_type == 0:
            return
        if self.sps.chroma_array_type == 3:
            ft = self.ft
            for comp in (1, 2):
                if i16:
                    # Intra16x16DCLevel per component, nC as luma4x4BlkIdx 0
                    nc = self.comp444_nc(comp, mbx * 4, mby * 4)
                    coeffs, _ = residual_block_cavlc(
                        self._need_res_r(), 0, 15, 16, nc
                    )
                    ft.c444_dc[addr, comp - 1] = coeffs
                self._parse_luma_residual(
                    addr, mbx, mby, cbp_luma, i16=i16, t8=t8, comp=comp
                )
            return
        ft = self.ft
        dc_n = ft.ch_dc_n
        # category-3/4 reader (partition B/C under data partitioning)
        r = self._need_res_r() if cbp_chroma else None
        if cbp_chroma & 3:
            nc_dc = -1 if dc_n == 4 else -2
            for comp in range(2):
                coeffs, _ = residual_block_cavlc(r, 0, dc_n - 1, dc_n, nc_dc)
                ft.chroma_dc[addr, comp] = coeffs
        for comp in range(2):
            for blk in range(ft.ch_blks):
                bx, by = ft.ch_blk_xy[blk]
                gx, gy = mbx * 2 + bx, mby * ft.ch_rows + by
                if cbp_chroma & 2:
                    nc = self.chroma_nc(comp, gx, gy)
                    coeffs, total = residual_block_cavlc(r, 1, 15, 16, nc)
                    ft.chroma_ac[addr, comp, blk] = coeffs
                    ft.chroma_nnz[comp, gy, gx] = total
                else:
                    ft.chroma_nnz[comp, gy, gx] = 0
