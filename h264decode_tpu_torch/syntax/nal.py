"""NAL unit header parsing (spec section 7.3.1, 7.4.1; Table 7-1).

Parity with /root/reference/h264/nalUnit.go:75-131 and frame.go:5-94,
including the SVC (Annex G), MVC (Annex H) and 3D-AVC (Annex J) header
extensions the reference parses.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..bitstream.annexb import strip_emulation_prevention
from ..bitstream.bitreader import BitReader

# Table 7-1 nal_unit_type values
NAL_UNSPECIFIED = 0
NAL_SLICE_NON_IDR = 1
NAL_SLICE_PART_A = 2
NAL_SLICE_PART_B = 3
NAL_SLICE_PART_C = 4
NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9
NAL_END_OF_SEQ = 10
NAL_END_OF_STREAM = 11
NAL_FILLER = 12
NAL_SPS_EXT = 13
NAL_PREFIX = 14
NAL_SUBSET_SPS = 15
NAL_DPS = 16
NAL_AUX_SLICE = 19
NAL_SLICE_EXT = 20
NAL_SLICE_EXT_DEPTH = 21

NAL_TYPE_NAMES = {
    0: "Unspecified",
    1: "Coded slice of a non-IDR picture",
    2: "Coded slice data partition A",
    3: "Coded slice data partition B",
    4: "Coded slice data partition C",
    5: "Coded slice of an IDR picture",
    6: "Supplemental enhancement information (SEI)",
    7: "Sequence parameter set",
    8: "Picture parameter set",
    9: "Access unit delimiter",
    10: "End of sequence",
    11: "End of stream",
    12: "Filler data",
    13: "Sequence parameter set extension",
    14: "Prefix NAL unit",
    15: "Subset sequence parameter set",
    16: "Depth parameter set",
    19: "Coded slice of an auxiliary coded picture without partitioning",
    20: "Coded slice extension",
    21: "Coded slice extension for depth/3D-AVC view components",
}


@dataclass
class SvcExtension:
    """nal_unit_header_svc_extension(), spec G.7.3.1.1."""

    idr_flag: bool = False
    priority_id: int = 0
    no_inter_layer_pred_flag: bool = False
    dependency_id: int = 0
    quality_id: int = 0
    temporal_id: int = 0
    use_ref_base_pic_flag: bool = False
    discardable_flag: bool = False
    output_flag: bool = False


@dataclass
class MvcExtension:
    """nal_unit_header_mvc_extension(), spec H.7.3.1.1."""

    non_idr_flag: bool = False
    priority_id: int = 0
    view_id: int = 0
    temporal_id: int = 0
    anchor_pic_flag: bool = False
    inter_view_flag: bool = False


@dataclass
class Avc3dExtension:
    """nal_unit_header_3davc_extension(), spec J.7.3.1.1."""

    view_idx: int = 0
    depth_flag: bool = False
    non_idr_flag: bool = False
    temporal_id: int = 0
    anchor_pic_flag: bool = False
    inter_view_flag: bool = False


@dataclass
class NalUnit:
    ref_idc: int
    type: int
    rbsp: bytes
    svc: SvcExtension | None = None
    mvc: MvcExtension | None = None
    avc3d: Avc3dExtension | None = None
    header_bytes: int = 1

    @property
    def name(self) -> str:
        return NAL_TYPE_NAMES.get(self.type, "Reserved")

    @property
    def is_idr(self) -> bool:
        return self.type == NAL_SLICE_IDR

    @property
    def is_vcl(self) -> bool:
        return 1 <= self.type <= 5 or self.type in (19, 20, 21)


def parse_nal_unit(nal: bytes) -> NalUnit:
    """Parse one raw NAL unit (no start code) into header + RBSP."""
    r = BitReader(nal)
    forbidden = r.u(1)
    if forbidden:
        raise ValueError("forbidden_zero_bit set")
    ref_idc = r.u(2)
    nal_type = r.u(5)
    svc = mvc = avc3d = None
    header_bytes = 1
    if nal_type in (NAL_PREFIX, NAL_SLICE_EXT, NAL_SLICE_EXT_DEPTH):
        # spec 7.3.1: one of the three extension headers follows
        if nal_type != NAL_SLICE_EXT_DEPTH and r.flag():  # svc_extension_flag
            svc = SvcExtension(
                idr_flag=r.flag(),
                priority_id=r.u(6),
                no_inter_layer_pred_flag=r.flag(),
                dependency_id=r.u(3),
                quality_id=r.u(4),
                temporal_id=r.u(3),
                use_ref_base_pic_flag=r.flag(),
                discardable_flag=r.flag(),
                output_flag=r.flag(),
            )
            r.u(2)  # reserved_three_2bits
            header_bytes = 4
        elif nal_type == NAL_SLICE_EXT_DEPTH and r.flag():  # avc_3d_extension_flag
            avc3d = Avc3dExtension(
                view_idx=r.u(8),
                depth_flag=r.flag(),
                non_idr_flag=r.flag(),
                temporal_id=r.u(3),
                anchor_pic_flag=r.flag(),
                inter_view_flag=r.flag(),
            )
            header_bytes = 3
        else:
            mvc = MvcExtension(
                non_idr_flag=r.flag(),
                priority_id=r.u(6),
                view_id=r.u(10),
                temporal_id=r.u(3),
                anchor_pic_flag=r.flag(),
                inter_view_flag=r.flag(),
            )
            r.u(1)  # reserved_one_bit
            header_bytes = 4
    rbsp = strip_emulation_prevention(nal[header_bytes:])
    return NalUnit(
        ref_idc=ref_idc,
        type=nal_type,
        rbsp=rbsp,
        svc=svc,
        mvc=mvc,
        avc3d=avc3d,
        header_bytes=header_bytes,
    )
