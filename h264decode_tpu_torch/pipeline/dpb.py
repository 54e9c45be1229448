"""Decoded picture buffer: POC derivation (spec 8.2.1), reference marking
(8.2.5, incl. sliding window + MMCO), reference list construction (8.2.4).

Host-side picture management (SURVEY.md L8). Pixel planes referenced here
live on device in the TPU pipeline; this module only tracks metadata and
ordering. frame_mbs_only streams (no field pairs) for now.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from ..syntax.slice_header import SliceHeader
from ..syntax.sps import SPS


@dataclass(eq=False)  # identity equality: planes are arrays, uid is identity
class Picture:
    """One reference picture with planes + marking state."""

    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray
    frame_num: int
    poc: int
    uid: int  # global decode counter; used for deblock bS picture identity
    is_ref: bool = True
    long_term: bool = False
    long_term_idx: int = -1
    frame_num_wrap: int = 0
    pic_num: int = 0
    # field coding (PAFF): -1 = frame picture, 0 = top field, 1 = bottom
    parity: int = -1
    # field order counts of a frame picture (8.2.1); poc == min(top, bottom)
    top_poc: int = 0
    bottom_poc: int = 0
    # per-MB field flags of an MBAFF source picture (colocated derivation
    # 8.4.1.2.1 needs the colocated pair's coding); None = no field MBs
    col_mb_field: np.ndarray | None = None
    pair: "Picture | None" = None  # complementary field of the same frame
    # colocated motion (spec 8.4.1.2.1), 4x4 granularity, filled by the
    # decoder when the picture completes: L0-preferred mv/ref selection
    col_mv: np.ndarray | None = None  # [4h, 4w, 2] int32
    col_ref_idx: np.ndarray | None = None  # [4h, 4w] int8 (-1 = intra/none)
    col_ref_uid: np.ndarray | None = None  # [4h, 4w] int32 (-1 = none)
    # referenced FIELD parity per colocated part (-1 = frame reference):
    # MBAFF-field temporal direct maps refIdxCol into the current field
    # list by (frame uid, parity) — spec 8.4.1.2.2/8.4.1.2.3
    col_ref_parity: np.ndarray | None = None  # [4h, 4w] int8
    # the picture's entropy task (a Future, done once its engine calls, the
    # engine's finish and its colocated arrays are); None for a picture
    # that never had one (the gray placeholder of seed_missing_ref)
    decoded: Future | None = None

    def planes(self):
        return self.y, self.cb, self.cr

    def field(self, parity: int) -> "Picture":
        """A field view of a frame picture (every other row), for field
        pictures referencing earlier frame-coded pictures (spec 8.4.2.1)."""
        if self.parity == parity:
            return self
        assert self.parity == -1, "field() on a frame picture only"
        f = Picture(
            y=np.ascontiguousarray(np.asarray(self.y)[parity::2]),
            cb=np.ascontiguousarray(np.asarray(self.cb)[parity::2]),
            cr=np.ascontiguousarray(np.asarray(self.cr)[parity::2]),
            frame_num=self.frame_num,
            poc=self.bottom_poc if parity else self.top_poc,
            uid=self.uid,
            long_term=self.long_term,
            long_term_idx=self.long_term_idx,
            parity=parity,
        )
        return f


# the colocated arrays of every reference picture: (name, dtype, trailing shape)
_COL_ARRAYS = (("col_ref_idx", np.int8, ()), ("col_mv", np.int32, (2,)),
               ("col_ref_uid", np.int32, ()))


def colocated_motion(ft, motion, out: dict) -> dict:
    """The colocated-motion arrays of a decoded reference picture (spec
    8.4.1.2.1), by their Picture field names: `out`'s arrays of
    _COL_ARRAYS, each written straight into the dtype and layout the
    entropy engine takes, with no copy after. Per 4x4 cell the L0 motion
    where L0 has a vector, else L1's, else none (refIdxCol -1, mvCol 0);
    per 8x8 part the referenced picture's uid, L0's where L0 is used.
    col_mb_field and the referenced field parities (col_ref_parity) only
    for a picture with field MBs: a later slice reads the parity only at a
    field MB of its colocated picture. Only a reference picture can be
    RefPicList1[0] of a later B slice, the one reader of these arrays."""
    ref0, ref1 = motion.ref
    has0 = ref0 >= 0
    ri = out["col_ref_idx"]
    np.maximum(ref1, -1, out=ri)  # L1's, or -1 (from -1 or -2) for none
    np.copyto(ri, ref0, where=has0)
    # a cell's (x, y) pair as one 64-bit word: one mask selects both
    w0, w1 = motion.mv.view(np.int64)[..., 0]
    mv = out["col_mv"].view(np.int64)[..., 0]
    np.copyto(mv, w1)
    np.copyto(mv, w0, where=has0)
    mv[ri < 0] = 0
    # per 8x8 part: all ones where L0 refers to no picture
    none0 = ft.ref_pic.reshape(-1)[:-4] >> 31
    _parts_to_cells(_l0_else_l1(ft.ref_pic, none0), ft, out["col_ref_uid"])
    out["col_mb_field"] = out["col_ref_parity"] = None
    if ft.mb_field.any():
        out["col_mb_field"] = ft.mb_field.astype(np.uint8)
        out["col_ref_parity"] = _parts_to_cells(
            _l0_else_l1(ft.ref_parity, none0.astype(np.int8)), ft,
            np.empty(ref0.shape, np.int8))
    return out


def fill_colocated(pic: Picture, ft, motion) -> None:
    """colocated_motion of the decoded reference picture `pic` into the
    arrays DPB.colocated_arrays gave it, and its field arrays onto it."""
    out = colocated_motion(ft, motion, {name: getattr(pic, name) for name, *_ in _COL_ARRAYS})
    pic.col_mb_field, pic.col_ref_parity = out["col_mb_field"], out["col_ref_parity"]


def _l0_else_l1(per_list: np.ndarray, none0: np.ndarray) -> np.ndarray:
    """[nMB, 2, 4] per-list values of the 8x8 parts -> [nMB, 4]: L0's, or
    L1's where none0 (all ones, per_list's dtype) is set. Bitwise over the
    flat array, where each part's L1 entry lies 4 after its L0 one: a
    [nMB, 4] view would make numpy loop over 4 values at a time."""
    flat = per_list.reshape(-1)
    out = np.empty_like(flat)
    np.bitwise_or(flat[:-4] & ~none0, flat[4:] & none0, out=out[:-4])
    return out.reshape(-1, 8)[:, :4]


def _parts_to_cells(parts: np.ndarray, ft, out: np.ndarray) -> np.ndarray:
    """[nMB, 4] per-8x8-part values (raster in the MB) -> `out`, the
    [4h, 4w] cell grid, each part's value in its 2x2 cells."""
    mb_h, mb_w = ft.mb_h, ft.mb_w
    rows = out.reshape(mb_h, 2, 2, mb_w * 2, 2)  # [mby, part y, cell y, part x, cell x]
    rows[:, :, 0] = parts.reshape(mb_h, mb_w, 2, 2).transpose(0, 2, 1, 3).reshape(
        mb_h, 2, mb_w * 2)[..., None]
    rows[:, :, 1] = rows[:, :, 0]
    return out


class POCContext:
    """PicOrderCnt derivation, spec 8.2.1 (types 0, 1 and 2)."""

    def __init__(self, sps: SPS):
        self.sps = sps
        self.prev_poc_msb = 0
        self.prev_poc_lsb = 0
        self.prev_frame_num = 0
        self.prev_frame_num_offset = 0
        self.last_field_pocs = (0, 0)  # (top, bottom) of the last frame

    def compute(self, hdr: SliceHeader) -> int:
        sps = self.sps
        t = sps.pic_order_cnt_type
        if hdr.idr_pic_flag:
            self.prev_poc_msb = 0
            self.prev_poc_lsb = 0
            self.prev_frame_num_offset = 0
            self.prev_frame_num = 0
        if t == 0:
            max_lsb = sps.max_pic_order_cnt_lsb
            lsb = hdr.pic_order_cnt_lsb
            if lsb < self.prev_poc_lsb and (self.prev_poc_lsb - lsb) >= max_lsb // 2:
                msb = self.prev_poc_msb + max_lsb
            elif lsb > self.prev_poc_lsb and (lsb - self.prev_poc_lsb) > max_lsb // 2:
                msb = self.prev_poc_msb - max_lsb
            else:
                msb = self.prev_poc_msb
            poc = msb + lsb
            if hdr.nal_ref_idc:
                self.prev_poc_msb = msb
                self.prev_poc_lsb = lsb
            if not hdr.field_pic_flag:
                # frame picture: TopFieldOrderCnt = poc, BottomFieldOrderCnt
                # = poc + delta_pic_order_cnt_bottom (8-2/8-3); PicOrderCnt
                # of the frame is their min (8.2.1). Field POCs feed MBAFF
                # field-MB implicit weights and temporal direct.
                bottom = poc + hdr.delta_pic_order_cnt_bottom
                self.last_field_pocs = (poc, bottom)
                return min(poc, bottom)
            self.last_field_pocs = (poc, poc)
            return poc
        # frame_num_offset shared by types 1 and 2 (8-7/8-12)
        if hdr.frame_num < self.prev_frame_num:
            offset = self.prev_frame_num_offset + self.sps.max_frame_num
        else:
            offset = self.prev_frame_num_offset
        self.prev_frame_num_offset = offset
        self.prev_frame_num = hdr.frame_num
        if t == 1:
            num = len(sps.offset_for_ref_frame)
            abs_frame_num = offset + hdr.frame_num
            if hdr.nal_ref_idc == 0 and abs_frame_num > 0:
                abs_frame_num -= 1
            expected = 0
            if abs_frame_num > 0 and num > 0:
                cycle_sum = sum(sps.offset_for_ref_frame)
                cycles = (abs_frame_num - 1) // num
                in_cycle = (abs_frame_num - 1) % num
                expected = cycles * cycle_sum + sum(
                    sps.offset_for_ref_frame[: in_cycle + 1]
                )
            if hdr.nal_ref_idc == 0:
                expected += sps.offset_for_non_ref_pic
            d0, d1 = hdr.delta_pic_order_cnt
            if hdr.field_pic_flag and hdr.bottom_field_flag:
                expected += sps.offset_for_top_to_bottom_field
            if not hdr.field_pic_flag:
                top = expected + d0
                bottom = top + sps.offset_for_top_to_bottom_field + d1
                self.last_field_pocs = (top, bottom)
                return min(top, bottom)
            v = expected + d0
            self.last_field_pocs = (v, v)
            return v
        # type 2
        if hdr.nal_ref_idc == 0:
            v = 2 * (offset + hdr.frame_num) - 1
        else:
            v = 2 * (offset + hdr.frame_num)
        self.last_field_pocs = (v, v)
        return v


class DPB:
    """Reference picture store + list construction (frame coding)."""

    def __init__(self, sps: SPS):
        self.sps = sps
        self.pictures: list[Picture] = []
        self.max_long_term_idx = -1  # MaxLongTermFrameIdx (-1 = no long term)
        # colocated arrays handed out by colocated_arrays(), each set with
        # the entropy tasks that write or read it (anything with done());
        # a set is reused once no picture in the DPB holds it and none of
        # its tasks is in flight
        self._col_sets: list[tuple[dict, list]] = []

    def colocated_arrays(self, shape: tuple, writer) -> dict:
        """Arrays for the colocated motion (colocated_motion) of the
        reference picture being set up, whose entropy task `writer` fills
        them: a set of `shape` that no picture in the DPB holds and no task
        in flight writes or reads (hold_colocated), or a new one. Reused
        memory spares the page faults of new arrays. A B picture in flight
        may read the set of a picture that marking has since removed from
        the DPB (an IDR empties it), so the tasks count as holders too.
        Call on the decoding thread, which alone marks the DPB."""
        held = {id(p.col_ref_idx) for p in self.pictures}
        for arrays, tasks in self._col_sets:
            tasks[:] = [t for t in tasks if not t.done()]
            ri = arrays["col_ref_idx"]
            if id(ri) not in held and not tasks and ri.shape == shape:
                break
        else:
            arrays = {name: np.empty(shape + tail, dt) for name, dt, tail in _COL_ARRAYS}
            tasks = []
            self._col_sets.append((arrays, tasks))
        tasks.append(writer)
        return dict(arrays)

    def hold_colocated(self, pic: Picture, reader) -> None:
        """Keep pic's colocated arrays from reuse until `reader` (a later
        picture's entropy task, with done()) has ended."""
        for arrays, tasks in self._col_sets:
            if arrays["col_ref_idx"] is pic.col_ref_idx:
                tasks.append(reader)
                return

    def clear(self):
        self.pictures.clear()
        self.max_long_term_idx = -1

    def seed_missing_ref(self, hdr: SliceHeader, poc: int, uid: int) -> None:
        """Entry at a non-IDR access point (recovery-point SEI / broken
        link): synthesize one gray short-term reference so list construction
        and prediction proceed — the frame-level analogue of the spec's
        8.2.5.2 "non-existing" frame handling. Pixels are best-effort until
        the announced recovery point; with exact_match_flag they converge
        bit-exactly once the refresh wave completes."""
        H = self.sps.frame_height_in_mbs * 16
        W = self.sps.pic_width_in_mbs * 16
        cf = self.sps.chroma_array_type
        ch = H if cf in (2, 3) else H // 2
        cw = W if cf == 3 else W // 2
        p = Picture(
            y=np.full((H, W), 128, np.uint8),
            cb=np.full((ch, cw), 128, np.uint8),
            cr=np.full((ch, cw), 128, np.uint8),
            frame_num=(hdr.frame_num - 1) % max(1, self.sps.max_frame_num),
            poc=poc - 2,
            uid=uid,
        )
        h4, w4 = self.sps.frame_height_in_mbs * 4, self.sps.pic_width_in_mbs * 4
        p.col_mv = np.zeros((h4, w4, 2), np.int32)
        p.col_ref_idx = np.full((h4, w4), -1, np.int8)
        p.col_ref_uid = np.full((h4, w4), -1, np.int32)
        self.pictures.append(p)

    # ------------------------------------------------------------- ref lists

    def _update_pic_nums(self, cur_frame_num: int, cur_parity: int | None = None):
        """spec 8.2.4.1: FrameNumWrap / PicNum for short-term refs. When
        decoding a field (cur_parity 0/1), field PicNum = 2*FrameNumWrap + 1
        for same-parity fields, 2*FrameNumWrap otherwise."""
        mfn = self.sps.max_frame_num
        for p in self.pictures:
            if not p.long_term:
                p.frame_num_wrap = (
                    p.frame_num - mfn if p.frame_num > cur_frame_num else p.frame_num
                )
                if cur_parity is None:
                    p.pic_num = p.frame_num_wrap
                else:
                    p.pic_num = 2 * p.frame_num_wrap + (
                        1 if p.parity == cur_parity else 0
                    )

    # ---- field helpers (PAFF, spec 8.2.4.2.5) ----

    def _units(self, pics: list[Picture]) -> list[list[Picture]]:
        """Group into frame units: complementary field pairs, non-paired
        fields, and frame pictures."""
        units, done = [], set()
        for p in pics:
            if id(p) in done:
                continue
            done.add(id(p))
            if (
                p.parity >= 0
                and p.pair is not None
                and any(q is p.pair for q in pics)
            ):
                done.add(id(p.pair))
                units.append([p, p.pair])
            else:
                units.append([p])
        return units

    @staticmethod
    def _alternate_parity(units: list[list[Picture]], parity: int) -> list[Picture]:
        """8.2.4.2.5: from an ordered frame list, the field list alternates
        parity starting with the current field's parity; when one parity
        runs out, the rest of the other parity follows in order."""
        same, opp = [], []
        for u in units:
            if u[0].parity == -1:  # frame picture referenced by a field:
                same.append(u[0].field(parity))  # use its field views
                opp.append(u[0].field(1 - parity))
                continue
            for f in u:
                (same if f.parity == parity else opp).append(f)
        out, i, j, want_same = [], 0, 0, True
        while i < len(same) or j < len(opp):
            if (want_same and i < len(same)) or j >= len(opp):
                out.append(same[i])
                i += 1
            else:
                out.append(opp[j])
                j += 1
            want_same = not want_same
        return out

    def ref_list_p(self, hdr: SliceHeader) -> list[Picture]:
        """8.2.4.2.1/8.2.4.2.2: P list0 = short-term by PicNum/FrameNumWrap
        desc, long-term by idx asc; field decoding orders frame units then
        alternates parity (8.2.4.2.5); then 8.2.4.3 modifications."""
        n = hdr.num_ref_idx_l0_active_minus1 + 1
        if hdr.field_pic_flag:
            parity = int(hdr.bottom_field_flag)
            self._update_pic_nums(hdr.frame_num, parity)
            st_units = self._units(
                [p for p in self.pictures if not p.long_term]
            )
            st_units.sort(key=lambda u: -max(f.frame_num_wrap for f in u))
            lt_units = self._units([p for p in self.pictures if p.long_term])
            lt_units.sort(key=lambda u: min(f.long_term_idx for f in u))
            lst = self._alternate_parity(st_units, parity) + self._alternate_parity(
                lt_units, parity
            )
            return self._apply_modifications(lst, hdr.ref_pic_list_mod_l0, hdr, n)
        self._update_pic_nums(hdr.frame_num)
        st = sorted(
            (p for p in self.pictures if not p.long_term), key=lambda p: -p.pic_num
        )
        lt = sorted(
            (p for p in self.pictures if p.long_term), key=lambda p: p.long_term_idx
        )
        lst = st + lt
        return self._apply_modifications(lst, hdr.ref_pic_list_mod_l0, hdr, n)

    def ref_lists_b(self, hdr: SliceHeader, cur_poc: int) -> tuple[list[Picture], list[Picture]]:
        """8.2.4.2.3/8.2.4.2.4: B list0/list1 from POC ordering; field
        decoding orders frame units by POC then alternates parity; then
        modifications."""
        if hdr.field_pic_flag:
            parity = int(hdr.bottom_field_flag)
            self._update_pic_nums(hdr.frame_num, parity)
            st_units = self._units(
                [p for p in self.pictures if not p.long_term]
            )
            lt_units = self._units([p for p in self.pictures if p.long_term])
            lt_units.sort(key=lambda u: min(f.long_term_idx for f in u))

            def upoc(u):
                return max(f.poc for f in u)

            before = sorted(
                (u for u in st_units if upoc(u) <= cur_poc), key=lambda u: -upoc(u)
            )
            after = sorted(
                (u for u in st_units if upoc(u) > cur_poc), key=upoc
            )
            lt = self._alternate_parity(lt_units, parity)
            l0 = self._alternate_parity(before + after, parity) + lt
            l1 = self._alternate_parity(after + before, parity) + lt
        else:
            self._update_pic_nums(hdr.frame_num)
            st = [p for p in self.pictures if not p.long_term]
            lt = sorted(
                (p for p in self.pictures if p.long_term),
                key=lambda p: p.long_term_idx,
            )
            before = sorted((p for p in st if p.poc <= cur_poc), key=lambda p: -p.poc)
            after = sorted((p for p in st if p.poc > cur_poc), key=lambda p: p.poc)
            l0 = before + after + lt
            l1 = after + before + lt
        # 8.2.4.2.3: if l1 has >1 entries and equals l0, swap its first two
        if len(l1) > 1 and [p.uid for p in l1] == [p.uid for p in l0]:
            l1 = [l1[1], l1[0]] + l1[2:]
        return (
            self._apply_modifications(
                l0, hdr.ref_pic_list_mod_l0, hdr, hdr.num_ref_idx_l0_active_minus1 + 1
            ),
            self._apply_modifications(
                l1, hdr.ref_pic_list_mod_l1, hdr, hdr.num_ref_idx_l1_active_minus1 + 1
            ),
        )

    def _sized(self, lst: list[Picture], n: int) -> list[Picture]:
        if not lst:
            return lst
        while len(lst) < n:
            lst.append(lst[-1])  # entries may repeat; invalid idx clamps
        return lst[:n]

    def _apply_modifications(self, lst, ops, hdr: SliceHeader, n_active: int):
        """8.2.4.3: re-order via modification_of_pic_nums_idc ops, with the
        exact insert-then-compact process of 8.2.4.3.1 — the SAME picture may
        legally appear at multiple indices (x264 weightp=2 relies on this)."""
        lst = self._sized(list(lst), n_active)
        if not ops:
            return lst
        field = hdr.field_pic_flag
        parity = int(hdr.bottom_field_flag)
        # field decoding: MaxPicNum = 2*MaxFrameNum, CurrPicNum = 2*fn + 1
        max_pic_num = (2 if field else 1) * self.sps.max_frame_num
        curr_pic_num = 2 * hdr.frame_num + 1 if field else hdr.frame_num
        pic_num_pred = curr_pic_num
        ref_idx = 0
        for op in ops:
            if op.idc in (0, 1):
                diff = op.value + 1
                if op.idc == 0:
                    no_wrap = pic_num_pred - diff
                    if no_wrap < 0:
                        no_wrap += max_pic_num
                else:
                    no_wrap = pic_num_pred + diff
                    if no_wrap >= max_pic_num:
                        no_wrap -= max_pic_num
                pic_num_pred = no_wrap
                pic_num = no_wrap
                if pic_num > curr_pic_num:
                    pic_num -= max_pic_num
                match = next(
                    (p for p in self.pictures if not p.long_term and p.pic_num == pic_num),
                    None,
                )
            else:  # idc == 2: long-term (field LongTermPicNum = 2*idx + same)
                def ltpn(p):
                    if not field:
                        return p.long_term_idx
                    return 2 * p.long_term_idx + (1 if p.parity == parity else 0)

                match = next(
                    (
                        p
                        for p in self.pictures
                        if p.long_term and ltpn(p) == op.value
                    ),
                    None,
                )
            if match is None:
                raise ValueError("ref_pic_list_modification references absent picture")
            # insert at ref_idx (list grows to n+1), then drop any LATER
            # occurrence of the same picture, then truncate back to n
            lst = lst[:ref_idx] + [match] + lst[ref_idx:]
            ref_idx += 1
            head, tail = lst[:ref_idx], [p for p in lst[ref_idx:] if p is not match]
            lst = (head + tail)[:n_active + 1]
        return lst[:n_active]

    # -------------------------------------------------------------- marking

    def _second_field_of(self, pic: Picture) -> Picture | None:
        """The complementary first field already in the DPB, if `pic` is the
        second field of a reference field pair (same frame_num, opposite
        parity, most recently marked and still unpaired) — spec 8.2.5.1."""
        if pic.parity < 0 or not self.pictures:
            return None
        q = self.pictures[-1]
        if (
            q.parity >= 0
            and q.pair is None
            and q.parity != pic.parity
            and q.frame_num == pic.frame_num
        ):
            return q
        return None

    def mark(self, pic: Picture, hdr: SliceHeader):
        """8.2.5: decoded reference picture marking (frames and fields)."""
        m = hdr.dec_ref_pic_marking
        first = self._second_field_of(pic)
        if first is not None:
            if hdr.idr_pic_flag:
                # 8.2.5.1: an IDR picture (the second IDR field included)
                # marks ALL reference pictures unused — the first field of
                # the pair stops being referenceable (libavcodec agrees;
                # pinned by tests/test_paff.py P-field prediction)
                self.clear()
                if m is not None and m.long_term_reference_flag:
                    pic.long_term = True
                    pic.long_term_idx = 0
                    self.max_long_term_idx = 0
                self.pictures.append(pic)
                return
            # second field of a reference pair: completes the frame unit —
            # no window eviction
            pic.pair = first
            first.pair = pic
            pic.long_term = first.long_term
            pic.long_term_idx = first.long_term_idx
            self.pictures.append(pic)
            return
        if hdr.idr_pic_flag:
            self.clear()
            if m is not None and m.long_term_reference_flag:
                pic.long_term = True
                pic.long_term_idx = 0
                self.max_long_term_idx = 0
            self.pictures.append(pic)
            return
        if hdr.nal_ref_idc == 0:
            return  # non-reference picture
        if m is not None and m.adaptive_ref_pic_marking_mode_flag:
            self._apply_mmco(pic, hdr, m.mmco_ops)
            if pic not in self.pictures:
                self.pictures.append(pic)
            return
        # sliding window (8.2.5.3): counts FRAME units (pairs count once)
        units = self._units(self.pictures)
        if len(units) >= max(1, self.sps.max_num_ref_frames):
            self._update_pic_nums(hdr.frame_num)
            st_units = [u for u in units if not u[0].long_term]
            if st_units:
                oldest = min(st_units, key=lambda u: max(f.frame_num_wrap for f in u))
                for f in oldest:
                    self.pictures.remove(f)
        self.pictures.append(pic)

    def _apply_mmco(self, pic: Picture, hdr: SliceHeader, ops):
        self._update_pic_nums(hdr.frame_num)
        for op in ops:
            if op.op == 1:  # unmark short-term
                pic_num = hdr.frame_num - (op.difference_of_pic_nums_minus1 + 1)
                self.pictures = [
                    p
                    for p in self.pictures
                    if p.long_term or p.pic_num != pic_num
                ]
            elif op.op == 2:  # unmark long-term by LongTermPicNum
                self.pictures = [
                    p
                    for p in self.pictures
                    if not p.long_term or p.long_term_idx != op.long_term_pic_num
                ]
            elif op.op == 3:  # short-term -> long-term
                pic_num = hdr.frame_num - (op.difference_of_pic_nums_minus1 + 1)
                for p in self.pictures:
                    if p.long_term and p.long_term_idx == op.long_term_frame_idx:
                        self.pictures.remove(p)
                        break
                for p in self.pictures:
                    if not p.long_term and p.pic_num == pic_num:
                        p.long_term = True
                        p.long_term_idx = op.long_term_frame_idx
            elif op.op == 4:  # MaxLongTermFrameIdx
                self.max_long_term_idx = op.max_long_term_frame_idx_plus1 - 1
                self.pictures = [
                    p
                    for p in self.pictures
                    if not p.long_term or p.long_term_idx <= self.max_long_term_idx
                ]
            elif op.op == 5:  # reset
                self.clear()
                pic.poc = 0
                pic.frame_num = 0
            elif op.op == 6:  # current -> long-term
                for p in list(self.pictures):
                    if p.long_term and p.long_term_idx == op.long_term_frame_idx:
                        self.pictures.remove(p)
                pic.long_term = True
                pic.long_term_idx = op.long_term_frame_idx
