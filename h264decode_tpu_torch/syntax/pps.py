"""Picture parameter set — full pic_parameter_set_rbsp() per spec 7.3.2.2,
including FMO slice-group parameters and the PPS scaling-matrix block.

Capability parity with /root/reference/h264/pps.go:40-133.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from math import ceil, log2

from ..bitstream.bitreader import BitReader
from .sps import SPS, parse_scaling_matrices


@dataclass
class PPS:
    pic_parameter_set_id: int = 0
    seq_parameter_set_id: int = 0
    entropy_coding_mode_flag: bool = False  # 0=CAVLC, 1=CABAC
    bottom_field_pic_order_in_frame_present_flag: bool = False
    num_slice_groups_minus1: int = 0
    slice_group_map_type: int = 0
    run_length_minus1: list[int] = field(default_factory=list)
    top_left: list[int] = field(default_factory=list)
    bottom_right: list[int] = field(default_factory=list)
    slice_group_change_direction_flag: bool = False
    slice_group_change_rate_minus1: int = 0
    pic_size_in_map_units_minus1: int = 0
    slice_group_id: list[int] = field(default_factory=list)
    num_ref_idx_l0_default_active_minus1: int = 0
    num_ref_idx_l1_default_active_minus1: int = 0
    weighted_pred_flag: bool = False
    weighted_bipred_idc: int = 0
    pic_init_qp_minus26: int = 0
    pic_init_qs_minus26: int = 0
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present_flag: bool = False
    constrained_intra_pred_flag: bool = False
    redundant_pic_cnt_present_flag: bool = False
    transform_8x8_mode_flag: bool = False
    pic_scaling_matrix_present_flag: bool = False
    scaling_lists_4x4: list[list[int]] | None = None
    scaling_lists_8x8: list[list[int]] | None = None
    second_chroma_qp_index_offset: int = 0

    @property
    def num_slice_groups(self) -> int:
        return self.num_slice_groups_minus1 + 1

    @property
    def pic_init_qp(self) -> int:
        return self.pic_init_qp_minus26 + 26

    def effective_scaling_4x4(self, sps: SPS) -> list[list[int]]:
        return self.scaling_lists_4x4 if self.scaling_lists_4x4 else sps.scaling_lists_4x4

    def effective_scaling_8x8(self, sps: SPS) -> list[list[int]]:
        return self.scaling_lists_8x8 if self.scaling_lists_8x8 else sps.scaling_lists_8x8


def parse_pps(rbsp: bytes, sps_map: dict[int, SPS]) -> PPS:
    """pic_parameter_set_rbsp(), spec 7.3.2.2. `sps_map` supplies the active
    SPS for the scaling-list fall-back rule B and the chroma format."""
    r = BitReader(rbsp)
    p = PPS()
    p.pic_parameter_set_id = r.ue()
    p.seq_parameter_set_id = r.ue()
    sps = sps_map.get(p.seq_parameter_set_id)
    if sps is None:
        raise ValueError(f"PPS references unknown SPS id {p.seq_parameter_set_id}")
    p.entropy_coding_mode_flag = r.flag()
    p.bottom_field_pic_order_in_frame_present_flag = r.flag()
    p.num_slice_groups_minus1 = r.ue()
    if p.num_slice_groups_minus1 > 0:
        p.slice_group_map_type = r.ue()
        if p.slice_group_map_type == 0:
            p.run_length_minus1 = [r.ue() for _ in range(p.num_slice_groups)]
        elif p.slice_group_map_type == 2:
            # spec: iGroup in [0, num_slice_groups_minus1) — last group implicit
            p.top_left, p.bottom_right = [], []
            for _ in range(p.num_slice_groups_minus1):
                p.top_left.append(r.ue())
                p.bottom_right.append(r.ue())
        elif p.slice_group_map_type in (3, 4, 5):
            p.slice_group_change_direction_flag = r.flag()
            p.slice_group_change_rate_minus1 = r.ue()
        elif p.slice_group_map_type == 6:
            p.pic_size_in_map_units_minus1 = r.ue()
            bits = max(1, ceil(log2(p.num_slice_groups)))
            p.slice_group_id = [
                r.u(bits) for _ in range(p.pic_size_in_map_units_minus1 + 1)
            ]
    p.num_ref_idx_l0_default_active_minus1 = r.ue()
    p.num_ref_idx_l1_default_active_minus1 = r.ue()
    p.weighted_pred_flag = r.flag()
    p.weighted_bipred_idc = r.u(2)
    p.pic_init_qp_minus26 = r.se()
    p.pic_init_qs_minus26 = r.se()
    p.chroma_qp_index_offset = r.se()
    p.deblocking_filter_control_present_flag = r.flag()
    p.constrained_intra_pred_flag = r.flag()
    p.redundant_pic_cnt_present_flag = r.flag()
    p.second_chroma_qp_index_offset = p.chroma_qp_index_offset
    if r.more_rbsp_data():
        p.transform_8x8_mode_flag = r.flag()
        p.pic_scaling_matrix_present_flag = r.flag()
        if p.pic_scaling_matrix_present_flag:
            n8x8 = (
                (6 if sps.chroma_format_idc == 3 else 2)
                if p.transform_8x8_mode_flag
                else 0
            )
            # Table 7-2: fall-back rule B (SPS lists) when the SPS carried
            # scaling matrices, else fall-back rule A (default lists)
            if sps.seq_scaling_matrix_present_flag:
                fb4, fb8 = sps.scaling_lists_4x4, sps.scaling_lists_8x8
            else:
                from .sps import (
                    DEFAULT_4x4_INTER,
                    DEFAULT_4x4_INTRA,
                    DEFAULT_8x8_INTER,
                    DEFAULT_8x8_INTRA,
                )

                fb4 = [list(DEFAULT_4x4_INTRA), None, None, list(DEFAULT_4x4_INTER), None, None]
                fb8 = [list(DEFAULT_8x8_INTRA), list(DEFAULT_8x8_INTER)]
            p.scaling_lists_4x4, p.scaling_lists_8x8 = parse_scaling_matrices(
                r, n8x8, fb4, fb8
            )
        p.second_chroma_qp_index_offset = r.se()
    return p
