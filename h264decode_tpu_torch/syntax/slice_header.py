"""Slice header — full slice_header() per spec 7.3.3 including
ref_pic_list_modification (7.3.3.1), pred_weight_table (7.3.3.2) and
dec_ref_pic_marking (7.3.3.3).

Capability parity with /root/reference/h264/slice.go:835-1048, fixing its
skipped frame_num parse (h264/slice.go:865-866).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from math import ceil, log2

from ..bitstream.bitreader import BitReader
from .nal import NalUnit
from .pps import PPS
from .sps import SPS

# Table 7-6 slice_type
SLICE_P = 0
SLICE_B = 1
SLICE_I = 2
SLICE_SP = 3
SLICE_SI = 4

SLICE_TYPE_NAMES = {0: "P", 1: "B", 2: "I", 3: "SP", 4: "SI"}


def slice_type_mod5(slice_type: int) -> int:
    """slice_type 5..9 means 'all slices in this picture have this type'."""
    return slice_type % 5


@dataclass
class RefPicListModOp:
    """One ref_pic_list_modification entry (spec 7.3.3.1)."""

    idc: int  # modification_of_pic_nums_idc: 0,1 short-term; 2 long-term
    value: int  # abs_diff_pic_num_minus1 (idc 0/1) or long_term_pic_num (idc 2)


@dataclass
class PredWeight:
    """Per-ref explicit weights (spec 7.3.3.2)."""

    luma_weight: int
    luma_offset: int
    chroma_weight: tuple[int, int]
    chroma_offset: tuple[int, int]


@dataclass
class PredWeightTable:
    luma_log2_weight_denom: int = 0
    chroma_log2_weight_denom: int = 0
    l0: list[PredWeight] = field(default_factory=list)
    l1: list[PredWeight] = field(default_factory=list)


@dataclass
class MMCOOp:
    """memory_management_control_operation entry (spec 7.3.3.3 / 8.2.5.4)."""

    op: int
    difference_of_pic_nums_minus1: int = 0
    long_term_pic_num: int = 0
    long_term_frame_idx: int = 0
    max_long_term_frame_idx_plus1: int = 0


@dataclass
class DecRefPicMarking:
    # IDR path
    no_output_of_prior_pics_flag: bool = False
    long_term_reference_flag: bool = False
    # non-IDR path
    adaptive_ref_pic_marking_mode_flag: bool = False
    mmco_ops: list[MMCOOp] = field(default_factory=list)


@dataclass
class SliceHeader:
    first_mb_in_slice: int = 0
    slice_type: int = 0
    pic_parameter_set_id: int = 0
    colour_plane_id: int = 0
    frame_num: int = 0
    field_pic_flag: bool = False
    bottom_field_flag: bool = False
    idr_pic_id: int = 0
    pic_order_cnt_lsb: int = 0
    delta_pic_order_cnt_bottom: int = 0
    delta_pic_order_cnt: tuple[int, int] = (0, 0)
    redundant_pic_cnt: int = 0
    direct_spatial_mv_pred_flag: bool = False
    num_ref_idx_active_override_flag: bool = False
    num_ref_idx_l0_active_minus1: int = 0
    num_ref_idx_l1_active_minus1: int = 0
    ref_pic_list_mod_l0: list[RefPicListModOp] | None = None
    ref_pic_list_mod_l1: list[RefPicListModOp] | None = None
    pred_weight_table: PredWeightTable | None = None
    dec_ref_pic_marking: DecRefPicMarking | None = None
    cabac_init_idc: int = 0
    slice_qp_delta: int = 0
    sp_for_switch_flag: bool = False
    slice_qs_delta: int = 0
    disable_deblocking_filter_idc: int = 0
    slice_alpha_c0_offset_div2: int = 0
    slice_beta_offset_div2: int = 0
    slice_group_change_cycle: int = 0
    # context carried for downstream stages
    nal_ref_idc: int = 0
    idr_pic_flag: bool = False
    data_bit_offset: int = 0  # bit position where slice_data() starts

    @property
    def type(self) -> int:
        return slice_type_mod5(self.slice_type)

    @property
    def type_name(self) -> str:
        return SLICE_TYPE_NAMES[self.type]

    @property
    def is_i(self) -> bool:
        return self.type == SLICE_I

    @property
    def is_p(self) -> bool:
        return self.type == SLICE_P

    @property
    def is_b(self) -> bool:
        return self.type == SLICE_B

    @property
    def is_sp(self) -> bool:
        return self.type == SLICE_SP

    @property
    def is_si(self) -> bool:
        return self.type == SLICE_SI

    @property
    def mbaff_frame_flag(self) -> bool:
        # derived with the active SPS by the caller; stored below at parse
        return self._mbaff

    _mbaff: bool = False

    def slice_qs(self, pps: PPS) -> int:
        """QSy for SP/SI slices (spec 7-31)."""
        return 26 + pps.pic_init_qs_minus26 + self.slice_qs_delta

    def slice_qp(self, pps: PPS) -> int:
        """SliceQPy, spec 7-30."""
        return 26 + pps.pic_init_qp_minus26 + self.slice_qp_delta


def _parse_ref_pic_list_mod(r: BitReader) -> list[RefPicListModOp] | None:
    if not r.flag():  # ref_pic_list_modification_flag
        return None
    ops: list[RefPicListModOp] = []
    while True:
        idc = r.ue()
        if idc == 3:
            break
        ops.append(RefPicListModOp(idc=idc, value=r.ue()))
    return ops


def _parse_pred_weight_entry(r: BitReader, chroma: bool, denoms) -> PredWeight:
    luma_denom, chroma_denom = denoms
    lw, lo = 1 << luma_denom, 0
    cw, co = (1 << chroma_denom, 1 << chroma_denom), (0, 0)
    if r.flag():  # luma_weight_lX_flag
        lw = r.se()
        lo = r.se()
    if chroma and r.flag():  # chroma_weight_lX_flag
        cw0, co0 = r.se(), r.se()
        cw1, co1 = r.se(), r.se()
        cw, co = (cw0, cw1), (co0, co1)
    return PredWeight(luma_weight=lw, luma_offset=lo, chroma_weight=cw, chroma_offset=co)


def parse_slice_header(
    rbsp: bytes,
    nal: NalUnit,
    sps_map: dict[int, SPS],
    pps_map: dict[int, PPS],
) -> tuple[SliceHeader, SPS, PPS, BitReader]:
    """Parse slice_header(); returns (header, active SPS, active PPS, reader
    positioned at the start of slice_data())."""
    r = BitReader(rbsp)
    h = SliceHeader()
    h.nal_ref_idc = nal.ref_idc
    h.idr_pic_flag = nal.is_idr
    h.first_mb_in_slice = r.ue()
    h.slice_type = r.ue()
    h.pic_parameter_set_id = r.ue()
    pps = pps_map.get(h.pic_parameter_set_id)
    if pps is None:
        raise ValueError(f"slice references unknown PPS {h.pic_parameter_set_id}")
    sps = sps_map.get(pps.seq_parameter_set_id)
    if sps is None:
        raise ValueError(f"PPS references unknown SPS {pps.seq_parameter_set_id}")
    if sps.separate_colour_plane_flag:
        h.colour_plane_id = r.u(2)
    h.frame_num = r.u(sps.log2_max_frame_num_minus4 + 4)
    if not sps.frame_mbs_only_flag:
        h.field_pic_flag = r.flag()
        if h.field_pic_flag:
            h.bottom_field_flag = r.flag()
    h._mbaff = sps.mb_adaptive_frame_field_flag and not h.field_pic_flag
    if h.idr_pic_flag:
        h.idr_pic_id = r.ue()
    if sps.pic_order_cnt_type == 0:
        h.pic_order_cnt_lsb = r.u(sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
        if pps.bottom_field_pic_order_in_frame_present_flag and not h.field_pic_flag:
            h.delta_pic_order_cnt_bottom = r.se()
    elif sps.pic_order_cnt_type == 1 and not sps.delta_pic_order_always_zero_flag:
        d0 = r.se()
        d1 = 0
        if pps.bottom_field_pic_order_in_frame_present_flag and not h.field_pic_flag:
            d1 = r.se()
        h.delta_pic_order_cnt = (d0, d1)
    if pps.redundant_pic_cnt_present_flag:
        h.redundant_pic_cnt = r.ue()
    st = h.type
    if st == SLICE_B:
        h.direct_spatial_mv_pred_flag = r.flag()
    if st in (SLICE_P, SLICE_SP, SLICE_B):
        h.num_ref_idx_l0_active_minus1 = pps.num_ref_idx_l0_default_active_minus1
        h.num_ref_idx_l1_active_minus1 = pps.num_ref_idx_l1_default_active_minus1
        h.num_ref_idx_active_override_flag = r.flag()
        if h.num_ref_idx_active_override_flag:
            h.num_ref_idx_l0_active_minus1 = r.ue()
            if st == SLICE_B:
                h.num_ref_idx_l1_active_minus1 = r.ue()
    # ref_pic_list_modification (7.3.3.1); MVC streams use _mvc variant (H.7.3.3.1.1)
    if st not in (SLICE_I, SLICE_SI):
        h.ref_pic_list_mod_l0 = _parse_ref_pic_list_mod(r)
    if st == SLICE_B:
        h.ref_pic_list_mod_l1 = _parse_ref_pic_list_mod(r)
    if (pps.weighted_pred_flag and st in (SLICE_P, SLICE_SP)) or (
        pps.weighted_bipred_idc == 1 and st == SLICE_B
    ):
        t = PredWeightTable()
        t.luma_log2_weight_denom = r.ue()
        chroma = sps.chroma_array_type != 0
        if chroma:
            t.chroma_log2_weight_denom = r.ue()
        denoms = (t.luma_log2_weight_denom, t.chroma_log2_weight_denom)
        for _ in range(h.num_ref_idx_l0_active_minus1 + 1):
            t.l0.append(_parse_pred_weight_entry(r, chroma, denoms))
        if st == SLICE_B:
            for _ in range(h.num_ref_idx_l1_active_minus1 + 1):
                t.l1.append(_parse_pred_weight_entry(r, chroma, denoms))
        h.pred_weight_table = t
    if nal.ref_idc != 0:
        m = DecRefPicMarking()
        if h.idr_pic_flag:
            m.no_output_of_prior_pics_flag = r.flag()
            m.long_term_reference_flag = r.flag()
        else:
            m.adaptive_ref_pic_marking_mode_flag = r.flag()
            if m.adaptive_ref_pic_marking_mode_flag:
                while True:
                    op = r.ue()
                    if op == 0:
                        break
                    e = MMCOOp(op=op)
                    if op in (1, 3):
                        e.difference_of_pic_nums_minus1 = r.ue()
                    if op == 2:
                        e.long_term_pic_num = r.ue()
                    if op in (3, 6):
                        e.long_term_frame_idx = r.ue()
                    if op == 4:
                        e.max_long_term_frame_idx_plus1 = r.ue()
                    m.mmco_ops.append(e)
        h.dec_ref_pic_marking = m
    if pps.entropy_coding_mode_flag and st not in (SLICE_I, SLICE_SI):
        h.cabac_init_idc = r.ue()
    h.slice_qp_delta = r.se()
    if st in (SLICE_SP, SLICE_SI):
        if st == SLICE_SP:
            h.sp_for_switch_flag = r.flag()
        h.slice_qs_delta = r.se()
    if pps.deblocking_filter_control_present_flag:
        h.disable_deblocking_filter_idc = r.ue()
        if h.disable_deblocking_filter_idc != 1:
            h.slice_alpha_c0_offset_div2 = r.se()
            h.slice_beta_offset_div2 = r.se()
    if pps.num_slice_groups > 1 and pps.slice_group_map_type in (3, 4, 5):
        pic_size_in_map_units = sps.pic_width_in_mbs * sps.pic_height_in_map_units
        rate = pps.slice_group_change_rate_minus1 + 1
        # Ceil(Log2(PicSizeInMapUnits / SliceGroupChangeRate + 1)) with REAL
        # division (spec 7.4.3): smallest b with 2^b * rate >= size + rate
        bits = 1
        while (1 << bits) * rate < pic_size_in_map_units + rate:
            bits += 1
        h.slice_group_change_cycle = r.u(bits)
    h.data_bit_offset = r.pos
    return h, sps, pps, r
