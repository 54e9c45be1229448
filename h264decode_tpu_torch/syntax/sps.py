"""Sequence parameter set parsing — full seq_parameter_set_rbsp() per spec
section 7.3.2.1.1, including scaling matrices, VUI and HRD parameters.

Capability parity with /root/reference/h264/sps.go:192-437 (plus the
profile predicates of /root/reference/h264/rbsp.go:44-82), with derived
dimension math per spec 7.4.2.1.1 / Table 6-1.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..bitstream.bitreader import BitReader

# profile_idc values (spec A.2)
PROFILE_BASELINE = 66
PROFILE_MAIN = 77
PROFILE_EXTENDED = 88
PROFILE_HIGH = 100
PROFILE_HIGH10 = 110
PROFILE_HIGH422 = 122
PROFILE_HIGH444_PREDICTIVE = 244
PROFILE_CAVLC444_INTRA = 44
PROFILE_SCALABLE_BASELINE = 83
PROFILE_SCALABLE_HIGH = 86
PROFILE_STEREO_HIGH = 128
PROFILE_MULTIVIEW_HIGH = 118

# profiles whose SPS carries chroma_format_idc etc. (spec 7.3.2.1.1 gate)
_EXTENDED_PROFILE_IDCS = frozenset(
    {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135}
)

# Default scaling lists, spec Tables 7-3 / 7-4 (zig-zag order).
DEFAULT_4x4_INTRA = (6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42)
DEFAULT_4x4_INTER = (10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34)
DEFAULT_8x8_INTRA = (
    6, 10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23,
    23, 23, 23, 23, 23, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27,
    27, 27, 27, 27, 29, 29, 29, 29, 29, 29, 29, 31, 31, 31, 31, 31,
    31, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38, 38, 40, 40, 42,
)
DEFAULT_8x8_INTER = (
    9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21,
    21, 21, 21, 21, 21, 22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24,
    24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27,
    27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33, 35,
)
FLAT_16 = (16,) * 16
FLAT_64 = (16,) * 64


def parse_scaling_list(r: BitReader, size: int) -> tuple[list[int], bool]:
    """scaling_list(), spec 7.3.2.1.1.1. Returns (list, use_default_flag)."""
    scaling = [0] * size
    last_scale, next_scale = 8, 8
    use_default = False
    for j in range(size):
        if next_scale != 0:
            delta = r.se()
            next_scale = (last_scale + delta + 256) % 256
            use_default = j == 0 and next_scale == 0
        scaling[j] = last_scale if next_scale == 0 else next_scale
        last_scale = scaling[j]
    return scaling, use_default


@dataclass
class HRDParams:
    """hrd_parameters(), spec E.1.2 (parity: h264/sps.go:197-216)."""

    cpb_cnt_minus1: int = 0
    bit_rate_scale: int = 0
    cpb_size_scale: int = 0
    bit_rate_value_minus1: list[int] = field(default_factory=list)
    cpb_size_value_minus1: list[int] = field(default_factory=list)
    cbr_flag: list[bool] = field(default_factory=list)
    initial_cpb_removal_delay_length_minus1: int = 0
    cpb_removal_delay_length_minus1: int = 0
    dpb_output_delay_length_minus1: int = 0
    time_offset_length: int = 0

    @classmethod
    def parse(cls, r: BitReader) -> "HRDParams":
        h = cls()
        h.cpb_cnt_minus1 = r.ue()
        h.bit_rate_scale = r.u(4)
        h.cpb_size_scale = r.u(4)
        for _ in range(h.cpb_cnt_minus1 + 1):
            h.bit_rate_value_minus1.append(r.ue())
            h.cpb_size_value_minus1.append(r.ue())
            h.cbr_flag.append(r.flag())
        h.initial_cpb_removal_delay_length_minus1 = r.u(5)
        h.cpb_removal_delay_length_minus1 = r.u(5)
        h.dpb_output_delay_length_minus1 = r.u(5)
        h.time_offset_length = r.u(5)
        return h


@dataclass
class VUIParams:
    """vui_parameters(), spec E.1.1 (parity: h264/sps.go:283-430)."""

    aspect_ratio_info_present_flag: bool = False
    aspect_ratio_idc: int = 0
    sar_width: int = 0
    sar_height: int = 0
    overscan_info_present_flag: bool = False
    overscan_appropriate_flag: bool = False
    video_signal_type_present_flag: bool = False
    video_format: int = 5
    video_full_range_flag: bool = False
    colour_description_present_flag: bool = False
    colour_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    chroma_loc_info_present_flag: bool = False
    chroma_sample_loc_type_top_field: int = 0
    chroma_sample_loc_type_bottom_field: int = 0
    timing_info_present_flag: bool = False
    num_units_in_tick: int = 0
    time_scale: int = 0
    fixed_frame_rate_flag: bool = False
    nal_hrd: HRDParams | None = None
    vcl_hrd: HRDParams | None = None
    low_delay_hrd_flag: bool = False
    pic_struct_present_flag: bool = False
    bitstream_restriction_flag: bool = False
    motion_vectors_over_pic_boundaries_flag: bool = True
    max_bytes_per_pic_denom: int = 2
    max_bits_per_mb_denom: int = 1
    log2_max_mv_length_horizontal: int = 15
    log2_max_mv_length_vertical: int = 15
    max_num_reorder_frames: int = 0
    max_dec_frame_buffering: int = 0

    @classmethod
    def parse(cls, r: BitReader) -> "VUIParams":
        v = cls()
        v.aspect_ratio_info_present_flag = r.flag()
        if v.aspect_ratio_info_present_flag:
            v.aspect_ratio_idc = r.u(8)
            if v.aspect_ratio_idc == 255:  # Extended_SAR
                v.sar_width = r.u(16)
                v.sar_height = r.u(16)
        v.overscan_info_present_flag = r.flag()
        if v.overscan_info_present_flag:
            v.overscan_appropriate_flag = r.flag()
        v.video_signal_type_present_flag = r.flag()
        if v.video_signal_type_present_flag:
            v.video_format = r.u(3)
            v.video_full_range_flag = r.flag()
            v.colour_description_present_flag = r.flag()
            if v.colour_description_present_flag:
                v.colour_primaries = r.u(8)
                v.transfer_characteristics = r.u(8)
                v.matrix_coefficients = r.u(8)
        v.chroma_loc_info_present_flag = r.flag()
        if v.chroma_loc_info_present_flag:
            v.chroma_sample_loc_type_top_field = r.ue()
            v.chroma_sample_loc_type_bottom_field = r.ue()
        v.timing_info_present_flag = r.flag()
        if v.timing_info_present_flag:
            v.num_units_in_tick = r.u(32)
            v.time_scale = r.u(32)
            v.fixed_frame_rate_flag = r.flag()
        nal_hrd_present = r.flag()
        if nal_hrd_present:
            v.nal_hrd = HRDParams.parse(r)
        vcl_hrd_present = r.flag()
        if vcl_hrd_present:
            v.vcl_hrd = HRDParams.parse(r)
        if nal_hrd_present or vcl_hrd_present:
            v.low_delay_hrd_flag = r.flag()
        v.pic_struct_present_flag = r.flag()
        v.bitstream_restriction_flag = r.flag()
        if v.bitstream_restriction_flag:
            v.motion_vectors_over_pic_boundaries_flag = r.flag()
            v.max_bytes_per_pic_denom = r.ue()
            v.max_bits_per_mb_denom = r.ue()
            v.log2_max_mv_length_horizontal = r.ue()
            v.log2_max_mv_length_vertical = r.ue()
            v.max_num_reorder_frames = r.ue()
            v.max_dec_frame_buffering = r.ue()
        return v


#: Table A-1 MaxDpbMbs per level_idc (levels 1.0 .. 6.2)
_MAX_DPB_MBS = {
    10: 396, 11: 900, 12: 2376, 13: 2376, 20: 2376, 21: 4752, 22: 8100,
    30: 8100, 31: 18000, 32: 20480, 40: 32768, 41: 32768, 42: 34816,
    50: 110400, 51: 184320, 52: 184320, 60: 696320, 61: 1392640,
    62: 2785280,
}


@dataclass
class SPS:
    profile_idc: int = 0
    constraint_set0_flag: bool = False
    constraint_set1_flag: bool = False
    constraint_set2_flag: bool = False
    constraint_set3_flag: bool = False
    constraint_set4_flag: bool = False
    constraint_set5_flag: bool = False
    level_idc: int = 0
    seq_parameter_set_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane_flag: bool = False
    bit_depth_luma_minus8: int = 0
    bit_depth_chroma_minus8: int = 0
    qpprime_y_zero_transform_bypass_flag: bool = False
    seq_scaling_matrix_present_flag: bool = False
    # scaling_lists_4x4[0..5][16], scaling_lists_8x8[0..5][64] (fall-back applied)
    scaling_lists_4x4: list[list[int]] = field(default_factory=list)
    scaling_lists_8x8: list[list[int]] = field(default_factory=list)
    log2_max_frame_num_minus4: int = 0
    pic_order_cnt_type: int = 0
    log2_max_pic_order_cnt_lsb_minus4: int = 0
    delta_pic_order_always_zero_flag: bool = False
    offset_for_non_ref_pic: int = 0
    offset_for_top_to_bottom_field: int = 0
    offset_for_ref_frame: list[int] = field(default_factory=list)
    max_num_ref_frames: int = 0
    gaps_in_frame_num_value_allowed_flag: bool = False
    pic_width_in_mbs_minus1: int = 0
    pic_height_in_map_units_minus1: int = 0
    frame_mbs_only_flag: bool = True
    mb_adaptive_frame_field_flag: bool = False
    direct_8x8_inference_flag: bool = False
    frame_cropping_flag: bool = False
    frame_crop_left_offset: int = 0
    frame_crop_right_offset: int = 0
    frame_crop_top_offset: int = 0
    frame_crop_bottom_offset: int = 0
    vui: VUIParams | None = None

    # ---- derived values (spec 7.4.2.1.1, Table 6-1) ----

    @property
    def max_dpb_frames(self) -> int:
        """MaxDpbFrames, spec A.3.1 eq. (A-2) with Table A-1 MaxDpbMbs."""
        mbs_per_frame = max(1, self.pic_width_in_mbs * self.frame_height_in_mbs)
        lvl = self.level_idc
        if lvl == 11 and self.constraint_set3_flag:
            lvl = 10  # level 1b shares level 1.0's MaxDpbMbs
        max_dpb_mbs = _MAX_DPB_MBS.get(lvl)
        if max_dpb_mbs is None:  # round up to the next defined level
            higher = [v for k, v in sorted(_MAX_DPB_MBS.items()) if k >= lvl]
            max_dpb_mbs = higher[0] if higher else _MAX_DPB_MBS[62]
        return max(1, min(max_dpb_mbs // mbs_per_frame, 16))

    @property
    def max_num_reorder(self) -> int:
        """Output reordering depth: VUI max_num_reorder_frames when signalled
        (E.2.1), else the conservative MaxDpbFrames default (spec E.2.1
        inference rule), else 0 for profiles without B slices."""
        if self.vui is not None and self.vui.bitstream_restriction_flag:
            return self.vui.max_num_reorder_frames
        if self.profile_idc in (66, 83, 86) or (
            self.profile_idc == 100 and self.constraint_set4_flag
            and self.constraint_set5_flag
        ):
            return 0
        return self.max_dpb_frames

    @property
    def chroma_array_type(self) -> int:
        return 0 if self.separate_colour_plane_flag else self.chroma_format_idc

    @property
    def sub_width_c(self) -> int:
        return {1: 2, 2: 2, 3: 1}.get(self.chroma_format_idc, 0)

    @property
    def sub_height_c(self) -> int:
        return {1: 2, 2: 1, 3: 1}.get(self.chroma_format_idc, 0)

    @property
    def pic_width_in_mbs(self) -> int:
        return self.pic_width_in_mbs_minus1 + 1

    @property
    def pic_height_in_map_units(self) -> int:
        return self.pic_height_in_map_units_minus1 + 1

    @property
    def frame_height_in_mbs(self) -> int:
        return (2 - int(self.frame_mbs_only_flag)) * self.pic_height_in_map_units

    @property
    def width(self) -> int:
        """Cropped luma width (spec 7.4.2.1.1 crop equations)."""
        w = self.pic_width_in_mbs * 16
        crop_x = self.sub_width_c if self.chroma_array_type in (1, 2) else 1
        return w - crop_x * (self.frame_crop_left_offset + self.frame_crop_right_offset)

    @property
    def height(self) -> int:
        h = self.frame_height_in_mbs * 16
        crop_y = (self.sub_height_c if self.chroma_array_type in (1, 2) else 1) * (
            2 - int(self.frame_mbs_only_flag)
        )
        return h - crop_y * (self.frame_crop_top_offset + self.frame_crop_bottom_offset)

    @property
    def max_frame_num(self) -> int:
        return 1 << (self.log2_max_frame_num_minus4 + 4)

    @property
    def max_pic_order_cnt_lsb(self) -> int:
        return 1 << (self.log2_max_pic_order_cnt_lsb_minus4 + 4)

    @property
    def bit_depth_luma(self) -> int:
        return 8 + self.bit_depth_luma_minus8

    @property
    def bit_depth_chroma(self) -> int:
        return 8 + self.bit_depth_chroma_minus8

    # profile predicates (parity: /root/reference/h264/rbsp.go:44-82)
    @property
    def is_constrained_baseline(self) -> bool:
        return self.profile_idc == PROFILE_BASELINE and self.constraint_set1_flag

    @property
    def is_constrained_high(self) -> bool:
        return (
            self.profile_idc == PROFILE_HIGH
            and self.constraint_set4_flag
            and self.constraint_set5_flag
        )

    @property
    def is_high10_intra(self) -> bool:
        return self.profile_idc == PROFILE_HIGH10 and self.constraint_set3_flag


def _default_scaling_matrices() -> tuple[list[list[int]], list[list[int]]]:
    """Flat-16 lists when seq_scaling_matrix_present_flag is 0 (spec 7.4.2.1.1)."""
    return [list(FLAT_16) for _ in range(6)], [list(FLAT_64) for _ in range(6)]


def parse_scaling_matrices(
    r: BitReader,
    n8x8: int,
    fallback_4x4: list[list[int]],
    fallback_8x8: list[list[int]],
) -> tuple[list[list[int]], list[list[int]]]:
    """Parse the seq/pic scaling list block with fall-back rule A/B
    (spec Table 7-2). `fallback_4x4/8x8` provide the rule-A fallbacks
    (flat for SPS, the SPS-derived lists for PPS)."""
    lists_4x4: list[list[int]] = []
    lists_8x8: list[list[int]] = []
    for i in range(6 + n8x8):
        present = r.flag()
        if i < 6:
            if present:
                scaling, use_default = parse_scaling_list(r, 16)
                if use_default:
                    scaling = list(DEFAULT_4x4_INTRA if i < 3 else DEFAULT_4x4_INTER)
            else:
                if i in (0, 3):
                    scaling = list(fallback_4x4[i])
                else:
                    scaling = list(lists_4x4[i - 1])
            lists_4x4.append(scaling)
        else:
            j = i - 6
            if present:
                scaling, use_default = parse_scaling_list(r, 64)
                if use_default:
                    scaling = list(DEFAULT_8x8_INTRA if j % 2 == 0 else DEFAULT_8x8_INTER)
            else:
                if j in (0, 1):
                    scaling = list(fallback_8x8[j])
                else:
                    scaling = list(lists_8x8[j - 2])
            lists_8x8.append(scaling)
    while len(lists_8x8) < 6:
        lists_8x8.append(list(FLAT_64))
    return lists_4x4, lists_8x8


def parse_sps(rbsp: bytes) -> SPS:
    """seq_parameter_set_rbsp(), spec 7.3.2.1."""
    r = BitReader(rbsp)
    s = SPS()
    s.profile_idc = r.u(8)
    s.constraint_set0_flag = r.flag()
    s.constraint_set1_flag = r.flag()
    s.constraint_set2_flag = r.flag()
    s.constraint_set3_flag = r.flag()
    s.constraint_set4_flag = r.flag()
    s.constraint_set5_flag = r.flag()
    r.u(2)  # reserved_zero_2bits
    s.level_idc = r.u(8)
    s.seq_parameter_set_id = r.ue()
    s.scaling_lists_4x4, s.scaling_lists_8x8 = _default_scaling_matrices()
    if s.profile_idc in _EXTENDED_PROFILE_IDCS:
        s.chroma_format_idc = r.ue()
        if s.chroma_format_idc == 3:
            s.separate_colour_plane_flag = r.flag()
        s.bit_depth_luma_minus8 = r.ue()
        s.bit_depth_chroma_minus8 = r.ue()
        # spec 7.4.2.1.1: both in 0..6. Reject here so hostile depths never
        # reach downstream shift arithmetic (native engine PCM reads would
        # otherwise do br_u(r, depth) with an unbounded width)
        if not (0 <= s.bit_depth_luma_minus8 <= 6):
            raise ValueError(
                f"bit_depth_luma_minus8 {s.bit_depth_luma_minus8} out of range"
            )
        if not (0 <= s.bit_depth_chroma_minus8 <= 6):
            raise ValueError(
                f"bit_depth_chroma_minus8 {s.bit_depth_chroma_minus8} out of range"
            )
        s.qpprime_y_zero_transform_bypass_flag = r.flag()
        s.seq_scaling_matrix_present_flag = r.flag()
        if s.seq_scaling_matrix_present_flag:
            n8x8 = 6 if s.chroma_format_idc == 3 else 2
            # SPS fall-back rule A uses the default lists (Table 7-2)
            fb4 = [list(DEFAULT_4x4_INTRA), None, None, list(DEFAULT_4x4_INTER), None, None]
            fb8 = [list(DEFAULT_8x8_INTRA), list(DEFAULT_8x8_INTER)]
            s.scaling_lists_4x4, s.scaling_lists_8x8 = parse_scaling_matrices(
                r, n8x8, fb4, fb8
            )
    s.log2_max_frame_num_minus4 = r.ue()
    s.pic_order_cnt_type = r.ue()
    if s.pic_order_cnt_type == 0:
        s.log2_max_pic_order_cnt_lsb_minus4 = r.ue()
    elif s.pic_order_cnt_type == 1:
        s.delta_pic_order_always_zero_flag = r.flag()
        s.offset_for_non_ref_pic = r.se()
        s.offset_for_top_to_bottom_field = r.se()
        n = r.ue()
        s.offset_for_ref_frame = [r.se() for _ in range(n)]
    s.max_num_ref_frames = r.ue()
    s.gaps_in_frame_num_value_allowed_flag = r.flag()
    s.pic_width_in_mbs_minus1 = r.ue()
    s.pic_height_in_map_units_minus1 = r.ue()
    s.frame_mbs_only_flag = r.flag()
    if not s.frame_mbs_only_flag:
        s.mb_adaptive_frame_field_flag = r.flag()
    s.direct_8x8_inference_flag = r.flag()
    s.frame_cropping_flag = r.flag()
    if s.frame_cropping_flag:
        s.frame_crop_left_offset = r.ue()
        s.frame_crop_right_offset = r.ue()
        s.frame_crop_top_offset = r.ue()
        s.frame_crop_bottom_offset = r.ue()
    if r.flag():  # vui_parameters_present_flag
        s.vui = VUIParams.parse(r)
    return s
