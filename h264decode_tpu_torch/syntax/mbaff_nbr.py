"""MBAFF neighbouring-location derivation (spec 6.4.10).

Maps a location (xN, yN) relative to the current macroblock of an MBAFF
frame to (neighbor MB, xW, yW) — the MB containing that location and the
location's coordinates inside it. This single mapper backs every MBAFF
neighbor consumer: intra mode prediction (8.3.1.1), intra reference
samples (8.3.2), CAVLC nC (9.2.1), CABAC context derivation (9.3.3.1),
and motion-vector prediction (8.4.1.3 via 6.4.10.7).

Macroblocks are identified by SPATIAL raster address (the repo-wide MBAFF
convention, see entropy/slice_base.py): pair k row-major, top MB at
spatial row 2*(k // mb_w), bottom at 2*(k // mb_w) + 1. A FRAME MB covers
16 consecutive sample rows of its pair's 32-row strip; a FIELD MB covers
the 16 same-parity rows (parity = spatial row & 1).

Derivation logic: for yN >= 0 with xN < 0 (left neighbors) the mapping is
purely geometric — the same absolute sample row, re-expressed in the left
pair's frame/field coordinates. For yN < 0 (above neighbors) the spec's
Table 6-4 picks specific rows per (current frame/field, top/bottom,
neighbor pair frame/field); the cases here were cross-validated
empirically against libavcodec with PCM probe streams
(tests/test_mbaff_field.py), which pins them to the conformant behavior.

The reference repo only walks MBAFF syntax flags and decodes nothing
(/root/reference/h264/slice.go:599-630).
"""

from __future__ import annotations


class MbaffGrid:
    """Neighbor derivation context for one MBAFF picture.

    field_at(spatial_addr) -> bool, avail(spatial_addr) -> bool (decoded,
    same slice — spec 6.4.9 availability) are supplied by the caller.
    """

    def __init__(self, mb_w: int, mb_h: int, field_at, avail, ch_h: int = 8):
        self.mb_w = mb_w
        self.mb_h = mb_h  # spatial MB rows (frame height in MBs, even)
        self.field_at = field_at
        self.avail = avail
        self.ch_h = ch_h  # MbHeightC: 8 (4:2:0) or 16 (4:2:2)

    # -------------------------------------------------------- pair helpers

    def _pair_of(self, sp: int) -> tuple[int, int]:
        """spatial addr -> (pair row, pair col)."""
        return (sp // self.mb_w) // 2, sp % self.mb_w

    def _top_of_pair(self, pr: int, pc: int) -> int:
        return (2 * pr) * self.mb_w + pc

    def _pair_avail(self, pr: int, pc: int) -> bool:
        """Pair-level availability (6.4.8/6.4.9 on the pair's top MB)."""
        if pr < 0 or pc < 0 or pc >= self.mb_w or 2 * pr >= self.mb_h:
            return False
        return self.avail(self._top_of_pair(pr, pc))

    # ---------------------------------------------------------- the mapper

    def neighbor(self, sp: int, xN: int, yN: int, chroma: bool = False):
        """spec 6.4.10.4: (current spatial MB, xN, yN) -> (spatial neighbor
        MB or -1, xW, yW). maxW/maxH are 16 luma, 8 chroma (4:2:0)."""
        maxW = 8 if chroma else 16
        maxH = self.ch_h if chroma else 16
        mb_w = self.mb_w
        row = sp // mb_w
        pr, pc = row // 2, sp % mb_w
        is_bottom = row & 1
        cur_field = bool(self.field_at(sp))

        if 0 <= xN < maxW and 0 <= yN < maxH:
            return sp, xN, yN

        if xN >= 2 * maxW or xN < -maxW or yN >= maxH:
            return -1, 0, 0
        if xN >= maxW and yN >= 0:
            return -1, 0, 0  # right neighbor at same rows: never decoded yet
        if xN >= maxW:
            # C position (above-right, yN < 0): mirrors the D/above logic on
            # the right side. For a frame BOTTOM MB the location is in the
            # RIGHT pair (strip row 15 + yN + 1 region); all other cases
            # reach the above-right pair. Decode-order availability (the
            # right pair decodes later) is enforced by the caller.
            xW = xN - maxW
            if not cur_field and is_bottom:
                if not self._pair_avail(pr, pc + 1):
                    return -1, 0, 0
                rtop = self._top_of_pair(pr, pc + 1)
                if not self.field_at(rtop):
                    return rtop, xW, maxH + yN  # right pair top MB, row 15
                return rtop + mb_w, xW, (2 * maxH + yN) >> 1
            if cur_field and is_bottom:
                if not self._pair_avail(pr - 1, pc + 1):
                    return -1, 0, 0
                ctop = self._top_of_pair(pr - 1, pc + 1)
                if self.field_at(ctop):
                    return ctop + mb_w, xW, maxH + yN
                return ctop + mb_w, xW, maxH + 2 * yN + 1
            if not self._pair_avail(pr - 1, pc + 1):
                return -1, 0, 0
            ctop = self._top_of_pair(pr - 1, pc + 1)
            nb_field = bool(self.field_at(ctop))
            if not cur_field:
                return ctop + mb_w, xW, maxH + yN  # above-right bottom MB
            if nb_field:
                return ctop, xW, maxH + yN
            return ctop + mb_w, xW, maxH + 2 * yN

        if yN >= 0:
            # left neighbor (xN < 0): same absolute sample row, re-expressed
            # in the left pair's coordinates (geometric; Table 6-4 agrees)
            if pc == 0 or not self._pair_avail(pr, pc - 1):
                return -1, 0, 0
            ltop = self._top_of_pair(pr, pc - 1)
            nb_field = bool(self.field_at(ltop))
            xW = xN + maxW
            if cur_field == nb_field:
                return ltop + mb_w * is_bottom, xW, yN
            if cur_field:  # field MB, frame left pair
                abs_row = 2 * yN + is_bottom
                return ltop + mb_w * (abs_row >= maxH), xW, abs_row % maxH
            # frame MB, field left pair
            abs_row = maxH * is_bottom + yN
            return ltop + mb_w * (abs_row & 1), xW, abs_row >> 1

        # ---- yN < 0: above (xN in range), above-left (xN < 0) neighbors
        if xN < 0:
            # D position (-1, -1): above-left. For a frame bottom MB the
            # location falls inside the LEFT pair; all other cases reach
            # into the above-left (or above) pair per Table 6-4.
            if not cur_field and is_bottom:
                # frame bottom: sample row 15 of the pair strip, left pair
                if pc == 0 or not self._pair_avail(pr, pc - 1):
                    return -1, 0, 0
                ltop = self._top_of_pair(pr, pc - 1)
                nb_field = bool(self.field_at(ltop))
                if not nb_field:
                    return ltop, xN + maxW, maxH + yN  # top MB, row 15
                # field left pair: strip row 15 is odd parity -> bottom
                # field MB, local row (15)>>1 = 7
                return ltop + mb_w, xN + maxW, (maxH + yN) >> 1
            if cur_field and is_bottom:
                # field bottom: same-parity (bottom) field row -1 lives in
                # the ABOVE-LEFT pair — bottom field MB row 16+yN when that
                # pair is field-coded, else picture strip row 32+2*yN+1 =
                # frame bottom MB row 16+2*yN+1 (mirrors the C-position
                # logic; pinned vs libavcodec by tests/test_mbaff.py x264
                # field streams)
                if pc == 0 or not self._pair_avail(pr - 1, pc - 1):
                    return -1, 0, 0
                dtop = self._top_of_pair(pr - 1, pc - 1)
                if self.field_at(dtop):
                    return dtop + mb_w, xN + maxW, maxH + yN
                return dtop + mb_w, xN + maxW, maxH + 2 * yN + 1
            # top MB (frame or field): above-left pair's bottom region
            if pc == 0 or not self._pair_avail(pr - 1, pc - 1):
                return -1, 0, 0
            dtop = self._top_of_pair(pr - 1, pc - 1)
            nb_field = bool(self.field_at(dtop))
            if not cur_field:
                # frame top: strip row -1 = above pair's last row (31)
                if not nb_field:
                    return dtop + mb_w, xN + maxW, maxH + yN  # bottom, 15
                return dtop + mb_w, xN + maxW, maxH + yN  # bottom field, 15
            # field top (parity 0): same-parity row above = above row 30
            if nb_field:
                return dtop, xN + maxW, maxH + yN  # top field MB, row 15
            return dtop + mb_w, xN + maxW, maxH + 2 * yN  # frame bottom, 14

        # ---- above neighbor proper (0 <= xN < maxW, yN < 0)
        if not cur_field:
            if is_bottom:
                # frame bottom: own pair's top MB
                return sp - mb_w, xN, maxH + yN
            # frame top: above pair's bottom MB (frame or field)
            if not self._pair_avail(pr - 1, pc):
                return -1, 0, 0
            btop = self._top_of_pair(pr - 1, pc)
            return btop + mb_w, xN, maxH + yN
        # current FIELD MB: above PAIR (both top and bottom MBs of a field
        # pair neighbor the above pair, 6.4.10.5)
        if not self._pair_avail(pr - 1, pc):
            return -1, 0, 0
        btop = self._top_of_pair(pr - 1, pc)
        nb_field = bool(self.field_at(btop))
        if nb_field:
            # same-parity field MB of the above pair, its last row
            return btop + mb_w * is_bottom, xN, maxH + yN
        if is_bottom:
            # bottom field above frame pair: frame bottom MB, last row
            return btop + mb_w, xN, maxH + 2 * yN + 1
        # top field above frame pair: frame bottom MB, row 14 (2*yN)
        return btop + mb_w, xN, maxH + 2 * yN


def sample_pos(sp: int, field: bool, mb_w: int, xW: int, yW: int,
               chroma: bool = False, ch_h: int = 8) -> tuple[int, int]:
    """(spatial MB, within-MB location) -> absolute plane coordinates.

    A frame MB's rows are consecutive; a field MB's rows interleave at its
    parity within the pair's strip (32 luma rows; 2*MbHeightC chroma)."""
    w = 8 if chroma else 16
    h = (ch_h if chroma else 16)
    row = sp // mb_w
    col = sp % mb_w
    x = col * w + xW
    if not field:
        return x, row * h + yW
    base = (row & ~1) * h
    return x, base + (row & 1) + 2 * yW
