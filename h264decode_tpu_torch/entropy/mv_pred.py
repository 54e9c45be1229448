"""Motion vector prediction, spec 8.4.1.3 (median + directional shortcuts)
and the P_Skip vector (8.4.1.1).

Shared by the CAVLC and CABAC slice decoders. Operates on per-frame
4x4-granularity grids so neighbor lookup is uniform across MB boundaries.

Ref-value conventions per cell (mirroring the spec's availability classes):
  -2  partition unavailable (outside picture, other slice, not yet decoded)
  -1  available but no vector for this list (intra MB, or list unused)
  >=0 reference index
"""

from __future__ import annotations

import numpy as np

UNAVAILABLE = -2
NO_LIST = -1


class MotionContext:
    """Per-frame MV/ref grids at 4x4 granularity, plus the slice gating."""

    def __init__(self, mb_w: int, mb_h: int, slice_id_per_mb: np.ndarray):
        self.mb_w = mb_w
        self.mv = np.zeros((2, mb_h * 4, mb_w * 4, 2), np.int32)
        self.ref = np.full((2, mb_h * 4, mb_w * 4), UNAVAILABLE, np.int8)
        # |mvd| per cell/list/component — CABAC mvd context (9.3.3.1.1.7)
        self.absmvd = np.zeros((2, mb_h * 4, mb_w * 4, 2), np.int32)
        # ref values visible to the CABAC ref_idx context: unlike `ref`,
        # updated as soon as each ref_idx is PARSED (same-MB partitions are
        # context-visible before their MVs are reconstructed, 9.3.3.1.1.6)
        self.refctx = np.full((2, mb_h * 4, mb_w * 4), UNAVAILABLE, np.int8)
        # direct-predicted cells (B_Skip / B_Direct_16x16 / B_Direct_8x8
        # sub-partitions): excluded from the CABAC ref_idx context
        # (9.3.3.1.1.6 — per PARTITION, not per macroblock)
        self.direct = np.zeros((mb_h * 4, mb_w * 4), bool)
        self.slice_id = slice_id_per_mb  # shared with FrameTensors
        self._reset_state()

    def reset(self, inter: bool = True) -> None:
        """Return the grids to their fresh values in place (the slice ids
        are FrameTensors.reset's): the entropy engine then reads this
        context as a freshly made one. inter=False: no MB was inter
        predicted, and an intra MB writes only zero vectors (and no |mvd|
        or direct flag)."""
        if inter:
            self.mv[...] = 0
            self.absmvd[...] = 0
            self.direct[...] = False
        self.ref[...] = UNAVAILABLE
        self.refctx[...] = UNAVAILABLE
        self._reset_state()

    def _reset_state(self) -> None:
        self.cur_slice = -1
        # MBAFF mode (8.4.1.3.2): neighbor derivation through the 6.4.10
        # mapper with frame<->field unit conversion. Grids hold each MB's
        # data in its OWN units at its spatial-local cells.
        self.grid = None
        self.mb_field = None
        self.cur_addr = -1
        self.cur_field = False
        self._cur_cx0 = self._cur_cy0 = 0

    def enable_mbaff(self, grid, mb_field) -> None:
        self.grid = grid
        self.mb_field = mb_field

    def begin_mb(self, addr: int) -> None:
        """Set the current MB for MBAFF neighbor derivation."""
        if self.grid is None:
            return
        self.cur_addr = addr
        self.cur_field = bool(self.mb_field[addr])
        mby, mbx = divmod(addr, self.mb_w)
        self._cur_cx0, self._cur_cy0 = mbx * 4, mby * 4

    def _convert(self, naddr: int, mv, ref):
        """8.4.1.3.2 unit conversion when neighbor and current differ in
        frame/field coding: field refs double per frame (2k = same parity),
        vertical MVs halve per field row."""
        nf = bool(self.mb_field[naddr])
        if nf == self.cur_field or ref < 0:
            return mv, ref
        if self.cur_field:  # neighbor is a frame MB
            vy = mv[1]
            return (mv[0], vy // 2 if vy >= 0 else -((-vy) // 2)), ref * 2
        return (mv[0], mv[1] * 2), ref >> 1

    def cell(self, lst: int, cx: int, cy: int):
        """Returns (mv[2], ref) with availability semantics applied. Under
        MBAFF (cx, cy) are interpreted relative to the current MB and routed
        through the Table 6-4 mapper with unit conversion."""
        if self.grid is not None:
            return self._cell_mbaff(lst, cx, cy)
        h4, w4 = self.ref.shape[1], self.ref.shape[2]
        if cx < 0 or cy < 0 or cx >= w4 or cy >= h4:
            return (0, 0), UNAVAILABLE
        naddr = (cy >> 2) * self.mb_w + (cx >> 2)
        if self.slice_id[naddr] != self.cur_slice:
            return (0, 0), UNAVAILABLE
        r = int(self.ref[lst, cy, cx])
        if r == UNAVAILABLE:
            return (0, 0), UNAVAILABLE
        return (int(self.mv[lst, cy, cx, 0]), int(self.mv[lst, cy, cx, 1])), r

    def resolve_cell(self, cx: int, cy: int):
        """MBAFF: (cx, cy) spatial-local cell query relative to the current
        MB -> (naddr, gcx, gcy) of the neighboring cell, or None."""
        px = (cx - self._cur_cx0) * 4
        py = (cy - self._cur_cy0) * 4
        if px < 0:
            px += 3  # -1: rightmost column of the left neighbor cell
        if py < 0:
            py += 3
        naddr, xW, yW = self.grid.neighbor(self.cur_addr, px, py)
        if naddr < 0 or self.slice_id[naddr] != self.cur_slice:
            return None
        nmby, nmbx = divmod(naddr, self.mb_w)
        return naddr, nmbx * 4 + (xW >> 2), nmby * 4 + (yW >> 2)

    def _cell_mbaff(self, lst: int, cx: int, cy: int):
        """MBAFF cell lookup: (cx, cy) in spatial-local cell coordinates;
        locations outside the current MB resolve via the 6.4.10 mapper at a
        representative sample of the queried cell."""
        rc = self.resolve_cell(cx, cy)
        if rc is None:
            return (0, 0), UNAVAILABLE
        naddr, gcx, gcy = rc
        r = int(self.ref[lst, gcy, gcx])
        if r == UNAVAILABLE:
            return (0, 0), UNAVAILABLE
        mv = (int(self.mv[lst, gcy, gcx, 0]), int(self.mv[lst, gcy, gcx, 1]))
        return self._convert(naddr, mv, r)

    def set_cells(self, lst, bx, by, w, h, mv, ref):
        self.mv[lst, by : by + h, bx : bx + w] = mv
        self.ref[lst, by : by + h, bx : bx + w] = ref
        self.refctx[lst, by : by + h, bx : bx + w] = ref

    def set_refctx(self, lst, bx, by, w, h, ref):
        """Early ref visibility for the CABAC ref_idx context only."""
        self.refctx[lst, by : by + h, bx : bx + w] = ref

    def set_intra(self, bx, by):
        """Mark a 4x4 MB footprint as intra (no vectors, but 'decoded')."""
        self.ref[:, by : by + 4, bx : bx + 4] = NO_LIST
        self.refctx[:, by : by + 4, bx : bx + 4] = NO_LIST
        self.mv[:, by : by + 4, bx : bx + 4] = 0

    # ----------------------------------------------------------- prediction

    def neighbors(self, lst: int, bx: int, by: int, w: int):
        """A (left), B (top), C (top-right with D top-left fallback) for the
        partition whose top-left 4x4 cell is (bx, by) and width w cells."""
        a_mv, a_ref = self.cell(lst, bx - 1, by)
        b_mv, b_ref = self.cell(lst, bx, by - 1)
        c_mv, c_ref = self.cell(lst, bx + w, by - 1)
        if c_ref == UNAVAILABLE:
            c_mv, c_ref = self.cell(lst, bx - 1, by - 1)
        return (a_mv, a_ref), (b_mv, b_ref), (c_mv, c_ref)

    def predict(
        self,
        lst: int,
        ref_idx: int,
        bx: int,
        by: int,
        w: int,
        h: int,
        part_shape: str = "",
        part_idx: int = 0,
    ) -> tuple[int, int]:
        """mvpLX per 8.4.1.3. part_shape in {'', '16x8', '8x16'} selects the
        directional shortcuts for those full-MB partition shapes."""
        (a_mv, a_ref), (b_mv, b_ref), (c_mv, c_ref) = self.neighbors(lst, bx, by, w)
        if part_shape == "16x8":
            if part_idx == 0 and b_ref == ref_idx:
                return b_mv
            if part_idx == 1 and a_ref == ref_idx:
                return a_mv
        elif part_shape == "8x16":
            if part_idx == 0 and a_ref == ref_idx:
                return a_mv
            if part_idx == 1 and c_ref == ref_idx:
                return c_mv
        match = (
            (1 if a_ref == ref_idx else 0)
            + (1 if b_ref == ref_idx else 0)
            + (1 if c_ref == ref_idx else 0)
        )
        if match == 1:
            if a_ref == ref_idx:
                return a_mv
            if b_ref == ref_idx:
                return b_mv
            return c_mv
        if (
            match == 0
            and b_ref == UNAVAILABLE
            and c_ref == UNAVAILABLE
            and a_ref != UNAVAILABLE
        ):
            return a_mv
        mx = _median(a_mv[0], b_mv[0], c_mv[0])
        my = _median(a_mv[1], b_mv[1], c_mv[1])
        return mx, my

    def skip_mv(self, bx: int, by: int) -> tuple[int, int]:
        """P_Skip luma vector, spec 8.4.1.1 (refIdxL0 = 0)."""
        a_mv, a_ref = self.cell(0, bx - 1, by)
        b_mv, b_ref = self.cell(0, bx, by - 1)
        if (
            a_ref == UNAVAILABLE
            or b_ref == UNAVAILABLE
            or (a_ref == 0 and a_mv == (0, 0))
            or (b_ref == 0 and b_mv == (0, 0))
        ):
            return 0, 0
        return self.predict(0, 0, bx, by, 4, 4)


def _median(a, b, c):
    return a + b + c - min(a, b, c) - max(a, b, c)
