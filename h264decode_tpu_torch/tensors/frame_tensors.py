"""The host-to-TPU data contract: per-frame struct-of-arrays tensors.

The reference interleaves parse and (unimplemented) decode per macroblock
(/root/reference/h264/slice.go:599-828). We instead entropy-decode a whole
frame into these dense SoA tensors on the host, then run the fully parallel
pixel pipeline on TPU (SURVEY.md section 7.1 two-phase design).

All coefficient arrays are stored in SCAN order (zig-zag); the de-zigzag is
a free gather fused into the dequant kernel on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# spec Table 8-13: 4x4 zig-zag scan (frame coding): scan index -> raster index
ZIGZAG_4x4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15], np.int32)
# spec Table 8-13 (field): 4x4 coefficient scan for FIELD-coded macroblocks
# (PAFF field pictures and MBAFF field MB pairs); validated against
# libavcodec by a single-coefficient probe (tests/test_field_scan.py)
FIELD_SCAN_4x4 = np.array(
    [0, 4, 1, 8, 12, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15], np.int32
)
# spec Table 8-14 (field): 8x8 field scan — extracted from the system
# libavcodec rodata (h264_slice.o `field_scan8x8`) like the entropy tables
# (tools/extract_tables.py culture; hand-transcription is how the reference
# corrupted its CABAC tables, SURVEY.md section 8)
FIELD_SCAN_8x8 = np.array(
    [
        0, 8, 16, 1, 9, 24, 32, 17, 2, 25, 40, 48, 56, 33, 10, 3,
        18, 41, 49, 57, 26, 11, 4, 19, 34, 42, 50, 58, 27, 12, 5, 20,
        35, 43, 51, 59, 28, 13, 6, 21, 36, 44, 52, 60, 29, 14, 22, 37,
        45, 53, 61, 30, 7, 15, 38, 46, 54, 62, 23, 31, 39, 47, 55, 63,
    ],
    np.int32,
)
# spec Table 8-14: 8x8 zig-zag scan (frame coding)
ZIGZAG_8x8 = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    ],
    np.int32,
)

# spec 6.4.3: luma4x4BlkIdx -> (x, y) in 4-px units within the MB
LUMA_BLK_XY = (
    (0, 0), (1, 0), (0, 1), (1, 1),
    (2, 0), (3, 0), (2, 1), (3, 1),
    (0, 2), (1, 2), (0, 3), (1, 3),
    (2, 2), (3, 2), (2, 3), (3, 3),
)
# chroma 4x4 blocks (4:2:0), raster within the 8x8 plane
CHROMA_BLK_XY = ((0, 0), (1, 0), (0, 1), (1, 1))
# chroma 4x4 blocks (4:2:2), raster within the 8x16 plane (spec 6.4.7)
CHROMA_BLK_XY_422 = (
    (0, 0), (1, 0), (0, 1), (1, 1),
    (0, 2), (1, 2), (0, 3), (1, 3),
)
# spec 8.5.4: 4:2:2 chroma DC inverse scan — list index k -> (row, col) of
# the 4x2 DC array. Verified against libavcodec by single-coefficient
# probe streams (tests/test_chroma422.py::test_dc_scan_probe).
CHROMA422_DC_SCAN = ((0, 0), (1, 0), (0, 1), (2, 0), (3, 0), (1, 1), (2, 1), (3, 1))
# luma8x8BlkIdx -> (x, y) in 8-px units
LUMA8_BLK_XY = ((0, 0), (1, 0), (0, 1), (1, 1))

# macroblock classes (ours, not spec numbering)
MB_I_NXN = 0
MB_I_16X16 = 1
MB_I_PCM = 2
MB_P = 3
MB_P_SKIP = 4
MB_B = 5
MB_B_SKIP = 6
MB_B_DIRECT = 7
MB_SI = 8  # SI macroblock (Intra_4x4 prediction + 8.6.2 reconstruction)

# intra 16x16 pred modes (spec 8.3.3)
I16_VERT, I16_HOR, I16_DC, I16_PLANE = 0, 1, 2, 3
# intra chroma pred modes (spec 8.3.4)
CH_DC, CH_HOR, CH_VERT, CH_PLANE = 0, 1, 2, 3


@dataclass
class FrameTensors:
    """Dense per-frame syntax/residual tensors, host side (numpy).

    nMB = mb_w * mb_h, raster MB order. Inter fields are meaningful only
    for P/B macroblocks; intra fields only for intra macroblocks.
    """

    mb_w: int
    mb_h: int
    # ChromaArrayType geometry: 1 = 4:2:0 (default, also used for mono),
    # 2 = 4:2:2 (8x16 chroma MBs: 8 AC blocks + 8-coeff DC per component),
    # 3 = 4:4:4 (chroma coded luma-style per component: c444_* arrays)
    chroma_format: int = 1

    mb_class: np.ndarray = None  # [nMB] int8, MB_* above
    transform_8x8: np.ndarray = None  # [nMB] bool
    qp: np.ndarray = None  # [nMB] int8: luma QP for the MB (delta-accumulated)
    cbp: np.ndarray = None  # [nMB] uint8: luma | chroma<<4

    # intra
    intra4x4_modes: np.ndarray = None  # [nMB,16] int8 (also 8x8 modes in [.,0:4])
    intra16_mode: np.ndarray = None  # [nMB] int8, -1 if not I16x16
    chroma_mode: np.ndarray = None  # [nMB] int8

    # residuals, scan order
    luma_ac: np.ndarray = None  # [nMB,16,16] int16 (4x4 blocks; 8x8 in [.,b,0:64] packed via luma8_ac)
    luma_dc: np.ndarray = None  # [nMB,16] int16 (I16x16 DC)
    luma8_ac: np.ndarray = None  # [nMB,4,64] int16 (8x8 transform blocks), lazily allocated
    chroma_dc: np.ndarray = None  # [nMB,2,4] int16
    chroma_ac: np.ndarray = None  # [nMB,2,4,16] int16
    # 4:4:4 (ChromaArrayType 3) chroma residuals, luma-shaped per component
    # (spec 7.3.5.3.1: residual_luma invoked for Cb and Cr). Allocated only
    # when chroma_format == 3; comp index 0 = Cb, 1 = Cr.
    c444_dc: np.ndarray = None  # [nMB,2,16] int16 (I16x16 DC per component)
    c444_ac: np.ndarray = None  # [nMB,2,16,16] int16
    c444_8x8: np.ndarray = None  # [nMB,2,4,64] int16, lazily allocated
    c444_nnz: np.ndarray = None  # [2, mb_h*4, mb_w*4] int8 per 4x4 block

    # inter
    mv: np.ndarray = None  # [nMB,2,16,2] int16: list, 4x4 blk (raster), (x,y) in 1/4 px
    ref_idx: np.ndarray = None  # [nMB,2,4] int8: list, 8x8 part; -1 = unused
    pred_flags: np.ndarray = None  # [nMB,2,4] uint8: list used per 8x8 part
    ref_pic: np.ndarray = None  # [nMB,2,4] int32: global picture uid per part (-1)
    # [nMB,2,4] int8: referenced FIELD parity for MBAFF field MBs (0 top,
    # 1 bottom); -1 = frame reference (frame MBs, PAFF handled by list)
    ref_parity: np.ndarray = None

    # deblocking inputs
    mbaff: bool = False  # picture uses MBAFF coding (pair-ordered scan)
    field_pic: bool = False  # picture is a PAFF field picture
    mb_field: np.ndarray = None  # [nMB] bool (MBAFF per-MB field flag)
    slice_id: np.ndarray = None  # [nMB] int32
    # MB belongs to an SP/SI slice: 8.7.2.1 forces intra-strength bS
    # (4 at MB edges / 3 internal) for ALL MBs of such slices
    sp_slice_mb: np.ndarray = None  # [nMB] bool
    # per-MB deblock parameters from the owning slice header
    disable_deblock: np.ndarray = None  # [nMB] int8 (0,1,2)
    alpha_off: np.ndarray = None  # [nMB] int8 (FilterOffsetA)
    beta_off: np.ndarray = None  # [nMB] int8

    # PCM raw samples (rare): dict mb_addr -> (y[16,16], cb[8,8], cr[8,8])
    pcm_samples: dict = field(default_factory=dict)
    # MB addresses in bitstream decode order (differs from raster under FMO)
    decode_order: list = field(default_factory=list)
    # the rows of the residual arrays that can hold a level, by key of
    # _CODED_ROWS, as the wire build found them (GpuDecoder): reset()
    # clears only these rows of the arrays it names, fills the rest
    coded: dict | None = None

    # bookkeeping used during entropy decode (total_coeff for CAVLC nC,
    # coded_block_flag for CABAC contexts) and deblock strength derivation
    luma_nnz: np.ndarray = None  # [mb_h*4, mb_w*4] int8 per 4x4 block
    chroma_nnz: np.ndarray = None  # [2, mb_h*2, mb_w*2] int8
    cbf_dc: np.ndarray = None  # [nMB, 3] int8: luma/cb/cr DC coded_block_flag

    # the wire build's sparse index (pipeline/gpu_pipeline.py): key ->
    # (array, values in a row of it), the rows as _coded_block_masks finds
    # the ones that can hold a nonzero level
    _CODED_ROWS = {"l": ("luma_ac", 16), "c": ("chroma_ac", 16),
                   "ld": ("luma_dc", 16), "l8": ("luma8_ac", 64)}

    def _layout(self) -> list:
        """(name, shape, dtype, fresh value) of every array this class
        makes; the lazy 8x8 arrays (ensure_luma8, ensure_c444_8x8) last."""
        n, h4, w4 = self.n_mbs, self.mb_h * 4, self.mb_w * 4
        out = [
            ("mb_class", (n,), np.int8, -1),
            ("transform_8x8", (n,), bool, 0),
            ("qp", (n,), np.int8, 0),
            ("cbp", (n,), np.uint8, 0),
            ("intra4x4_modes", (n, 16), np.int8, 2),  # default DC
            ("intra16_mode", (n,), np.int8, -1),
            ("chroma_mode", (n,), np.int8, 0),
            ("luma_ac", (n, 16, 16), np.int16, 0),
            ("luma_dc", (n, 16), np.int16, 0),
            ("chroma_dc", (n, 2, self.ch_dc_n), np.int16, 0),
            ("chroma_ac", (n, 2, self.ch_blks, 16), np.int16, 0),
            ("mv", (n, 2, 16, 2), np.int16, 0),
            ("ref_idx", (n, 2, 4), np.int8, -1),
            ("pred_flags", (n, 2, 4), np.uint8, 0),
            ("ref_pic", (n, 2, 4), np.int32, -1),
            ("ref_parity", (n, 2, 4), np.int8, -1),
            ("mb_field", (n,), bool, 0),
            ("slice_id", (n,), np.int32, -1),
            ("sp_slice_mb", (n,), bool, 0),
            ("disable_deblock", (n,), np.int8, 0),
            ("alpha_off", (n,), np.int8, 0),
            ("beta_off", (n,), np.int8, 0),
            ("cbf_dc", (n, 3), np.int8, 0),
            ("luma_nnz", (h4, w4), np.int8, 0),
        ]
        if self.chroma_format == 3:
            out += [
                ("c444_dc", (n, 2, 16), np.int16, 0),
                ("c444_ac", (n, 2, 16, 16), np.int16, 0),
                ("c444_nnz", (2, h4, w4), np.int8, 0),
            ]
        # NOTE: for chroma_format 3 the c444_* grids above are the
        # authoritative chroma storage; chroma_dc/chroma_ac/chroma_nnz are
        # still allocated (generic skip/PCM paths touch them) but their
        # contents are DEAD for 4:4:4 — reconstruction and deblocking read
        # only c444_*.
        out.append(("chroma_nnz", (2, self.mb_h * self.ch_rows, self.mb_w * 2), np.int8, 0))
        out.append(("luma8_ac", (n, 4, 64), np.int16, 0))
        out.append(("c444_8x8", (n, 2, 4, 64), np.int16, 0))
        return out

    def __post_init__(self):
        for name, shape, dtype, value in self._layout()[:-2]:
            if getattr(self, name) is None:
                setattr(self, name, np.zeros(shape, dtype) if value == 0
                        else np.full(shape, value, dtype))

    def reset(self, inter: bool = True) -> None:
        """Return every array to its fresh value in place and empty the PCM
        samples and the decode order: the entropy engine then reads this
        FrameTensors as a freshly made one. The arrays that `coded` covers
        are cleared at its rows only, the rest filled whole. inter=False:
        no MB was inter predicted, so no motion vector was written."""
        rows = {name: (key, width) for key, (name, width) in self._CODED_ROWS.items()}
        coded = self.coded or {}
        for name, _, _, value in self._layout():
            a = getattr(self, name)
            if a is None or (name == "mv" and not inter):
                continue
            key, width = rows.get(name, (None, 0))
            if key in coded:
                a.reshape(-1, width)[coded[key]] = 0
            else:
                a[...] = value
        self.pcm_samples = {}
        self.decode_order = []
        self.coded = None

    @property
    def n_mbs(self) -> int:
        return self.mb_w * self.mb_h

    # -------- chroma geometry (per component, per MB) --------
    @property
    def ch_blks(self) -> int:
        """Chroma AC 4x4 blocks per component (4 at 4:2:0, 8 at 4:2:2)."""
        return 8 if self.chroma_format == 2 else 4

    @property
    def ch_dc_n(self) -> int:
        """Chroma DC coefficients per component (4 / 8)."""
        return 8 if self.chroma_format == 2 else 4

    @property
    def ch_rows(self) -> int:
        """Chroma 4x4 block rows per MB (2 at 4:2:0, 4 at 4:2:2)."""
        return 4 if self.chroma_format == 2 else 2

    @property
    def ch_mb_h(self) -> int:
        """Chroma MB height in samples (MbHeightC: 8 / 16)."""
        return 16 if self.chroma_format in (2, 3) else 8

    @property
    def ch_blk_xy(self):
        return CHROMA_BLK_XY_422 if self.chroma_format == 2 else CHROMA_BLK_XY

    def ensure_luma8(self):
        if self.luma8_ac is None:
            self.luma8_ac = np.zeros((self.n_mbs, 4, 64), np.int16)
        return self.luma8_ac

    def ensure_c444_8x8(self):
        if self.c444_8x8 is None:
            self.c444_8x8 = np.zeros((self.n_mbs, 2, 4, 64), np.int16)
        return self.c444_8x8

    def mb_xy(self, addr: int) -> tuple[int, int]:
        return addr % self.mb_w, addr // self.mb_w
