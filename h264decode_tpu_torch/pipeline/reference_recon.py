"""Reference pixel reconstruction — plain numpy, decode-order sequential,
shaped 1:1 after ITU-T H.264 sections 8.3 (intra prediction) and 8.5
(transform/dequant). This is the correctness oracle for the TPU kernels
(kernels/ must match it bit-for-bit, and it must match libavcodec).

The reference repo has none of this layer (SURVEY.md L7: "pixel
reconstruction — missing"). Output is the PRE-deblocking picture; the
deblocking filter (8.7) is applied by pipeline/deblock_ref.py.
"""

from __future__ import annotations

import numpy as np

from ..syntax.pps import PPS
from ..syntax.sps import SPS
from ..tensors.frame_tensors import (
    CHROMA_BLK_XY,
    LUMA_BLK_XY,
    MB_I_16X16,
    MB_I_NXN,
    MB_I_PCM,
    ZIGZAG_4x4,
    ZIGZAG_8x8,
    FrameTensors,
)

# spec 8.5.9: normAdjust4x4 v-matrix (rows m = qP % 6; cols: position class)
NORM_ADJUST_4x4 = np.array(
    [
        [10, 16, 13],
        [11, 18, 14],
        [13, 20, 16],
        [14, 23, 18],
        [16, 25, 20],
        [18, 29, 23],
    ],
    np.int32,
)
# position class for 4x4: (i,j) both even -> 0, both odd -> 1, else 2
_POS_CLASS_4x4 = np.array(
    [[0 if (i % 2 == 0 and j % 2 == 0) else 1 if (i % 2 and j % 2) else 2
      for j in range(4)] for i in range(4)],
    np.int32,
)

# spec Table 8-15: QPc from qPI (values >= 30)
CHROMA_QP_TABLE = np.array(
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38,
     39, 39, 39, 39],
    np.int32,
)

# spec 8.5.9: normAdjust8x8 v-matrix: rows m, cols position class 0..5
NORM_ADJUST_8x8 = np.array(
    [
        [20, 18, 32, 19, 25, 24],
        [22, 19, 35, 21, 28, 26],
        [26, 23, 42, 24, 33, 31],
        [28, 25, 45, 26, 35, 33],
        [32, 28, 51, 30, 40, 38],
        [36, 32, 58, 34, 46, 43],
    ],
    np.int32,
)


def _pos_class_8x8(i, j):
    if i % 4 == 0 and j % 4 == 0:
        return 0
    if i % 2 == 1 and j % 2 == 1:
        return 1
    if i % 4 == 2 and j % 4 == 2:
        return 2
    if (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
        return 3
    if (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
        return 4
    return 5


_POS_CLASS_8x8 = np.array(
    [[_pos_class_8x8(i, j) for j in range(8)] for i in range(8)], np.int32
)


def chroma_qp(qp_y: int, offset: int, bd_off_c: int = 0) -> int:
    """Table 8-15 QPc. `bd_off_c` = QpBdOffsetC (6*(BitDepthC-8)): high-bit-
    depth streams clip qPI into [-QpBdOffsetC, 51] and the EFFECTIVE QP'c
    (= QPc + QpBdOffsetC, what dequant consumes) is returned."""
    qpi = max(-bd_off_c, min(51, qp_y + offset))
    qpc = int(qpi if qpi < 30 else CHROMA_QP_TABLE[qpi - 30])
    return qpc + bd_off_c


def level_scale_4x4(weight_scale_zz, m: int) -> np.ndarray:
    """LevelScale4x4(m, i, j) = weightScale(i,j) * normAdjust4x4(m, i, j).
    `weight_scale_zz` is the 16-entry scaling list in zig-zag order."""
    ws = np.zeros(16, np.int32)
    ws[ZIGZAG_4x4] = np.asarray(weight_scale_zz, np.int32)
    ws = ws.reshape(4, 4)
    return ws * NORM_ADJUST_4x4[m][_POS_CLASS_4x4]


def level_scale_8x8(weight_scale_zz, m: int) -> np.ndarray:
    ws = np.zeros(64, np.int32)
    ws[ZIGZAG_8x8] = np.asarray(weight_scale_zz, np.int32)
    ws = ws.reshape(8, 8)
    return ws * NORM_ADJUST_8x8[m][_POS_CLASS_8x8]


def dezigzag_4x4(scan16) -> np.ndarray:
    out = np.zeros(16, np.int32)
    out[ZIGZAG_4x4] = scan16
    return out.reshape(4, 4)


def descan_4x4(scan16, field: bool) -> np.ndarray:
    """Inverse 4x4 coefficient scan (spec 8.5.6 / Table 8-13): zig-zag for
    frame-coded macroblocks, field scan for field-coded ones (PAFF pictures,
    MBAFF field pairs)."""
    if not field:
        return dezigzag_4x4(scan16)
    from ..tensors.frame_tensors import FIELD_SCAN_4x4

    out = np.zeros(16, np.int32)
    out[FIELD_SCAN_4x4] = scan16
    return out.reshape(4, 4)


def dequant_4x4_ac(c: np.ndarray, ls: np.ndarray, qp: int) -> np.ndarray:
    """spec 8.5.12.1 for a 4x4 residual block (raster c, int32)."""
    if qp >= 24:
        return (c * ls) << (qp // 6 - 4)
    return (c * ls + (1 << (3 - qp // 6))) >> (4 - qp // 6)


def idct_4x4(d: np.ndarray) -> np.ndarray:
    """spec 8.5.12.2: integer inverse core transform; output residual r."""
    d = d.astype(np.int32)
    # horizontal (rows)
    e0 = d[:, 0] + d[:, 2]
    e1 = d[:, 0] - d[:, 2]
    e2 = (d[:, 1] >> 1) - d[:, 3]
    e3 = d[:, 1] + (d[:, 3] >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=1)
    # vertical (columns)
    g0 = f[0] + f[2]
    g1 = f[0] - f[2]
    g2 = (f[1] >> 1) - f[3]
    g3 = f[1] + (f[3] >> 1)
    h = np.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], axis=0)
    return (h + 32) >> 6


def hadamard_4x4(c: np.ndarray) -> np.ndarray:
    """spec 8.5.10 luma DC transform."""
    h4 = np.array(
        [[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int32
    )
    return h4 @ c.astype(np.int32) @ h4


def luma_dc_dequant(f: np.ndarray, ls00: int, qp: int) -> np.ndarray:
    """spec 8.5.10 scaling of the 4x4 DC transform output."""
    if qp >= 36:
        return (f * ls00) << (qp // 6 - 6)
    return (f * ls00 + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def chroma_dc_dequant(c: np.ndarray, ls00: int, qpc: int) -> np.ndarray:
    """spec 8.5.11 (4:2:0): 2x2 transform + scaling."""
    h2 = np.array([[1, 1], [1, -1]], np.int32)
    f = h2 @ c.astype(np.int32) @ h2
    return ((f * ls00) << (qpc // 6)) >> 5


def chroma_dc_dequant_422(c: np.ndarray, ls4_by_m, qpc: int) -> np.ndarray:
    """spec 8.5.11 (4:2:2): 2x4 chroma DC transform + scaling at
    qP.DC = QPc + 3 with the luma-DC (8.5.10-style) rounding — calibrated
    against libavcodec by single-coefficient probe streams across QPs
    (tests/test_chroma422.py). `c` is the 4-row x 2-col DC array;
    `ls4_by_m` is the per-m list of LevelScale4x4 matrices."""
    h4 = np.array(
        [[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int32
    )
    h2 = np.array([[1, 1], [1, -1]], np.int32)
    f = h4 @ c.astype(np.int32) @ h2
    qp_dc = qpc + 3
    ls00 = int(ls4_by_m[qp_dc % 6][0, 0])
    if qp_dc >= 36:
        return (f * ls00) << (qp_dc // 6 - 6)
    return (f * ls00 + (1 << (5 - qp_dc // 6))) >> (6 - qp_dc // 6)


def idct_8x8(d: np.ndarray) -> np.ndarray:
    """spec 8.5.12.3: 8x8 inverse transform."""
    d = d.astype(np.int32)

    def pass1(a):  # operates along axis 1 (rows)
        e = np.empty_like(a)
        e[:, 0] = a[:, 0] + a[:, 4]
        e[:, 1] = -a[:, 3] + a[:, 5] - a[:, 7] - (a[:, 7] >> 1)
        e[:, 2] = a[:, 0] - a[:, 4]
        e[:, 3] = a[:, 1] + a[:, 7] - a[:, 3] - (a[:, 3] >> 1)
        e[:, 4] = (a[:, 2] >> 1) - a[:, 6]
        e[:, 5] = -a[:, 1] + a[:, 7] + a[:, 5] + (a[:, 5] >> 1)
        e[:, 6] = a[:, 2] + (a[:, 6] >> 1)
        e[:, 7] = a[:, 3] + a[:, 5] + a[:, 1] + (a[:, 1] >> 1)
        f = np.empty_like(a)
        f[:, 0] = e[:, 0] + e[:, 6]
        f[:, 1] = e[:, 1] + (e[:, 7] >> 2)
        f[:, 2] = e[:, 2] + e[:, 4]
        f[:, 3] = e[:, 3] + (e[:, 5] >> 2)
        f[:, 4] = e[:, 2] - e[:, 4]
        f[:, 5] = (e[:, 3] >> 2) - e[:, 5]
        f[:, 6] = e[:, 0] - e[:, 6]
        f[:, 7] = e[:, 7] - (e[:, 1] >> 2)
        g = np.empty_like(a)
        g[:, 0] = f[:, 0] + f[:, 7]
        g[:, 1] = f[:, 2] + f[:, 5]
        g[:, 2] = f[:, 4] + f[:, 3]
        g[:, 3] = f[:, 6] + f[:, 1]
        g[:, 4] = f[:, 6] - f[:, 1]
        g[:, 5] = f[:, 4] - f[:, 3]
        g[:, 6] = f[:, 2] - f[:, 5]
        g[:, 7] = f[:, 0] - f[:, 7]
        return g

    g = pass1(d)
    h = pass1(g.T).T
    return (h + 32) >> 6


def clip1(x, mx: int = 255):
    return np.clip(x, 0, mx)


# ---------------------------------------------------------------------------
# Intra prediction (spec 8.3)
# ---------------------------------------------------------------------------


def intra4x4_predict(mode: int, left, top, topright, corner,
                     mid: int = 128) -> np.ndarray:
    """spec 8.3.1.2.1-9. left: 4 samples or None; top: 4 or None; topright: 4
    (already substituted if unavailable); corner: scalar or None.
    Returns [4,4] int32 prediction."""
    p = np.zeros((4, 4), np.int32)
    if mode == 0:  # Vertical
        p[:, :] = top[None, :]
    elif mode == 1:  # Horizontal
        p[:, :] = np.asarray(left)[:, None]
    elif mode == 2:  # DC
        if top is not None and left is not None:
            dc = (int(np.sum(top)) + int(np.sum(left)) + 4) >> 3
        elif top is not None:
            dc = (int(np.sum(top)) + 2) >> 2
        elif left is not None:
            dc = (int(np.sum(left)) + 2) >> 2
        else:
            dc = mid
        p[:, :] = dc
    elif mode == 3:  # Diagonal Down-Left (8.3.1.2.4)
        t = np.concatenate([top, topright]).astype(np.int32)
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    p[y, x] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    k = x + y
                    p[y, x] = (t[k] + 2 * t[k + 1] + t[k + 2] + 2) >> 2
    elif mode == 4:  # Diagonal Down-Right (8.3.1.2.5)
        t = np.asarray(top, np.int32)
        l = np.asarray(left, np.int32)
        m = int(corner)
        for y in range(4):
            for x in range(4):
                if x > y:
                    k = x - y
                    a = t[k - 2] if k - 2 >= 0 else m
                    b = t[k - 1] if k - 1 >= 0 else m
                    p[y, x] = (a + 2 * b + t[k] + 2) >> 2
                elif x < y:
                    k = y - x
                    a = l[k - 2] if k - 2 >= 0 else m
                    b = l[k - 1] if k - 1 >= 0 else m
                    p[y, x] = (a + 2 * b + l[k] + 2) >> 2
                else:
                    p[y, x] = (t[0] + 2 * m + l[0] + 2) >> 2
    elif mode == 5:  # Vertical-Right (8.3.1.2.6)
        t = np.asarray(top, np.int32)
        l = np.asarray(left, np.int32)
        m = int(corner)
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    k = x - (y >> 1)
                    a = t[k - 1] if k - 1 >= 0 else m
                    p[y, x] = (a + t[k] + 1) >> 1
                elif z >= 0:
                    k = x - (y >> 1)
                    a = t[k - 2] if k - 2 >= 0 else m
                    b = t[k - 1] if k - 1 >= 0 else m
                    p[y, x] = (a + 2 * b + t[k] + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * m + t[0] + 2) >> 2
                else:
                    p[y, x] = (l[y - 1] + 2 * l[y - 2] + (l[y - 3] if y - 3 >= 0 else m) + 2) >> 2
    elif mode == 6:  # Horizontal-Down (8.3.1.2.7)
        t = np.asarray(top, np.int32)
        l = np.asarray(left, np.int32)
        m = int(corner)
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    k = y - (x >> 1)
                    a = l[k - 1] if k - 1 >= 0 else m
                    p[y, x] = (a + l[k] + 1) >> 1
                elif z >= 0:
                    k = y - (x >> 1)
                    a = l[k - 2] if k - 2 >= 0 else m
                    b = l[k - 1] if k - 1 >= 0 else m
                    p[y, x] = (a + 2 * b + l[k] + 2) >> 2
                elif z == -1:
                    p[y, x] = (t[0] + 2 * m + l[0] + 2) >> 2
                else:
                    p[y, x] = (t[x - 1] + 2 * t[x - 2] + (t[x - 3] if x - 3 >= 0 else m) + 2) >> 2
    elif mode == 7:  # Vertical-Left (8.3.1.2.8)
        t = np.concatenate([top, topright]).astype(np.int32)
        for y in range(4):
            for x in range(4):
                k = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (t[k] + t[k + 1] + 1) >> 1
                else:
                    p[y, x] = (t[k] + 2 * t[k + 1] + t[k + 2] + 2) >> 2
    elif mode == 8:  # Horizontal-Up (8.3.1.2.9)
        l = np.asarray(left, np.int32)
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z > 5:
                    p[y, x] = l[3]
                elif z == 5:
                    p[y, x] = (l[2] + 3 * l[3] + 2) >> 2
                elif z % 2 == 0:
                    k = y + (x >> 1)
                    p[y, x] = (l[k] + l[k + 1] + 1) >> 1
                else:
                    k = y + (x >> 1)
                    p[y, x] = (l[k] + 2 * l[k + 1] + l[k + 2] + 2) >> 2
    else:
        raise ValueError(f"bad intra4x4 mode {mode}")
    return p


def intra16x16_predict(mode: int, left, top, corner,
                       mid: int = 128, mx: int = 255) -> np.ndarray:
    """spec 8.3.3: Intra_16x16 prediction. left/top are 16-sample arrays or
    None; corner scalar or None."""
    p = np.zeros((16, 16), np.int32)
    if mode == 0:  # V
        p[:, :] = top[None, :]
    elif mode == 1:  # H
        p[:, :] = np.asarray(left)[:, None]
    elif mode == 2:  # DC
        if top is not None and left is not None:
            dc = (int(np.sum(top)) + int(np.sum(left)) + 16) >> 5
        elif top is not None:
            dc = (int(np.sum(top)) + 8) >> 4
        elif left is not None:
            dc = (int(np.sum(left)) + 8) >> 4
        else:
            dc = mid
        p[:, :] = dc
    elif mode == 3:  # Plane (8.3.3.4)
        t = np.asarray(top, np.int64)
        l = np.asarray(left, np.int64)
        m = int(corner)
        hsum = sum((x + 1) * (int(t[8 + x]) - (int(t[6 - x]) if 6 - x >= 0 else m)) for x in range(8))
        vsum = sum((y + 1) * (int(l[8 + y]) - (int(l[6 - y]) if 6 - y >= 0 else m)) for y in range(8))
        a = 16 * (int(l[15]) + int(t[15]))
        b = (5 * hsum + 32) >> 6
        c = (5 * vsum + 32) >> 6
        yy, xx = np.mgrid[0:16, 0:16]
        p = clip1((a + b * (xx - 7) + c * (yy - 7) + 16) >> 5, mx)
    return p


def intra_chroma_predict(mode: int, left, top, corner, avail_l4,
                         h: int = 8, mid: int = 128,
                         mx: int = 255) -> np.ndarray:
    """spec 8.3.4 on the 8-wide x `h`-tall chroma component (h = 8 for
    4:2:0, 16 for 4:2:2). avail_l4 is unused (left/top arrays or None
    encode availability uniformly)."""
    p = np.zeros((h, 8), np.int32)
    if mode == 0:  # DC, per 4x4 sub-block (8.3.4.1)
        for by in range(h // 4):
            for bx in range(2):
                t = top[bx * 4 : bx * 4 + 4] if top is not None else None
                l = left[by * 4 : by * 4 + 4] if left is not None else None
                if (bx == 0 and by == 0) or (bx > 0 and by > 0):
                    # corner + interior blocks: average both if available
                    if t is not None and l is not None:
                        dc = (int(np.sum(t)) + int(np.sum(l)) + 4) >> 3
                    elif t is not None:
                        dc = (int(np.sum(t)) + 2) >> 2
                    elif l is not None:
                        dc = (int(np.sum(l)) + 2) >> 2
                    else:
                        dc = mid
                elif bx > 0:  # top-row right blocks: prefer top
                    if t is not None:
                        dc = (int(np.sum(t)) + 2) >> 2
                    elif l is not None:
                        dc = (int(np.sum(l)) + 2) >> 2
                    else:
                        dc = mid
                else:  # left-column lower blocks: prefer left
                    if l is not None:
                        dc = (int(np.sum(l)) + 2) >> 2
                    elif t is not None:
                        dc = (int(np.sum(t)) + 2) >> 2
                    else:
                        dc = mid
                p[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = dc
    elif mode == 1:  # Horizontal
        p[:, :] = np.asarray(left)[:, None]
    elif mode == 2:  # Vertical
        p[:, :] = top[None, :]
    elif mode == 3:  # Plane (8.3.4.4; yCF = 4 at 4:2:2)
        t = np.asarray(top, np.int64)
        l = np.asarray(left, np.int64)
        m = int(corner)
        ycf = 4 if h == 16 else 0  # spec yCF: 0 (4:2:0) / 4 (4:2:2)
        hsum = sum(
            (x + 1) * (int(t[4 + x]) - (int(t[2 - x]) if 2 - x >= 0 else m))
            for x in range(4)
        )
        vsum = sum(
            (y + 1)
            * (
                int(l[4 + ycf + y])
                - (int(l[2 + ycf - y]) if 2 + ycf - y >= 0 else m)
            )
            for y in range(4 + ycf)
        )
        a = 16 * (int(l[h - 1]) + int(t[7]))
        b = (34 * hsum + 32) >> 6
        c = ((34 - 29 * (1 if h == 16 else 0)) * vsum + 32) >> 6
        yy, xx = np.mgrid[0:h, 0:8]
        p = clip1((a + b * (xx - 3) + c * (yy - 3 - ycf) + 16) >> 5, mx)
    return p


# ---------------------------------------------------------------------------
# SP/SI switching pictures (spec 8.6)
#
# SP/SI reconstruction happens in the TRANSFORM domain: the prediction is
# forward-transformed, quantized to the level domain, the received levels
# are added there, and the sum is (re)quantized at QS before the normal
# scaling + inverse transform. This is what makes bitstream switching
# drift-free (Karczewicz & Kurceren, "The SP- and SI-Frames Design for
# H.264/AVC", IEEE TCSVT 2003). The reference parses sp_for_switch_flag /
# slice_qs_delta and stops (/root/reference/h264/slice.go:1021-1028).
#
# Fixed-point realization notes: quantization uses the canonical MF matrix
# with round-half-up (the 8.6 rounding, JM's rshift_rnd_sf); the w-domain
# re-quantization uses round(2^15 / normAdjust) so that requant(dequant(L))
# is the identity for in-range levels. libavcodec does not implement 8.6
# and no JM binary is available in this environment, so exact-rounding
# parity is validated by an independent transcription of this chain in
# tests/test_spsi.py rather than by a conformance oracle.
# ---------------------------------------------------------------------------

# encoder-side quant matrix MF (rows m = qP % 6; cols: position class as
# _POS_CLASS_4x4): MF[m][c] ~= 2^15 * PF(c)^2 / Qstep(m)
QUANT_MF_4x4 = np.array(
    [
        [13107, 5243, 8066],
        [11916, 4660, 7490],
        [10082, 4194, 6554],
        [9362, 3647, 5825],
        [8192, 3355, 5243],
        [7282, 2893, 4559],
    ],
    np.int64,
)
# w-domain re-quantizer: inverse of the 8.5 dequant scale (flat lists)
REQUANT_W_4x4 = np.round(2.0**15 / NORM_ADJUST_4x4).astype(np.int64)

_FWD_4x4 = np.array(
    [[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]], np.int64
)


def forward_4x4(x: np.ndarray) -> np.ndarray:
    """Raw integer core transform (the encoder-side pair of idct_4x4)."""
    return _FWD_4x4 @ x.astype(np.int64) @ _FWD_4x4.T


def sp_quant_4x4(t: np.ndarray, qp: int) -> np.ndarray:
    """Quantize raw transform coefficients to levels at qp (8.6 rounding:
    round-half-up, no deadzone)."""
    mf = QUANT_MF_4x4[qp % 6][_POS_CLASS_4x4]
    qbits = 15 + qp // 6
    return np.sign(t) * ((np.abs(t) * mf + (1 << (qbits - 1))) >> qbits)


def sp_dequant_4x4(L: np.ndarray, qp: int) -> np.ndarray:
    """8.5-style scaling with flat lists: w = L * normAdjust << (qp/6)."""
    v = NORM_ADJUST_4x4[qp % 6][_POS_CLASS_4x4].astype(np.int64)
    return (L * v) << (qp // 6)


def sp_requant_4x4(w: np.ndarray, qs: int) -> np.ndarray:
    """Re-quantize 8.5-scaled (w-domain) coefficients at qs."""
    rw = REQUANT_W_4x4[qs % 6][_POS_CLASS_4x4]
    qbits = 15 + qs // 6
    return np.sign(w) * ((np.abs(w) * rw + (1 << (qbits - 1))) >> qbits)


def sp_luma_block(pred: np.ndarray, levels_raster: np.ndarray,
                  qp: int, qs: int, switching: bool) -> np.ndarray:
    """One 4x4 luma block of an SP (inter) or SI/switching-SP MB: returns
    the reconstructed residual+prediction samples BEFORE clipping."""
    t = forward_4x4(pred)
    if switching:
        # 8.6.1.2 (sp_for_switch_flag=1) / 8.6.2 (SI): levels are in the
        # QS-quantized domain already
        ls = sp_quant_4x4(t, qs) + levels_raster
    else:
        lt = sp_quant_4x4(t, qp) + levels_raster  # QP level domain
        w_qp = sp_dequant_4x4(lt, qp)
        ls = sp_requant_4x4(w_qp, qs)
    w = sp_dequant_4x4(ls, qs)
    return idct_4x4(w.astype(np.int64))


def sp_chroma_comp(pred: np.ndarray, dc_levels: np.ndarray,
                   ac_levels_raster: np.ndarray, qpc: int, qsc: int,
                   switching: bool) -> np.ndarray:
    """One 8x8 chroma component of an SP/SI MB. dc_levels: [4] in raster
    2x2 order; ac_levels_raster: [4][4x4] per block (position 0 ignored)."""
    h2 = np.array([[1, 1], [1, -1]], np.int64)
    t = np.stack([
        forward_4x4(pred[(k // 2) * 4 : (k // 2) * 4 + 4,
                         (k % 2) * 4 : (k % 2) * 4 + 4])
        for k in range(4)
    ])
    dc_t = h2 @ t[:, 0, 0].reshape(2, 2) @ h2

    def quant_dc(d, q):
        mf = int(QUANT_MF_4x4[q % 6][0])
        qbits = 15 + q // 6
        return np.sign(d) * ((np.abs(d) * mf + (1 << qbits)) >> (qbits + 1))

    def dequant_dc(L, q):
        v = int(NORM_ADJUST_4x4[q % 6][0])
        return (L * v) << (q // 6 + 1)

    def requant_dc(d, q):
        # round-half-up at the (qbits+1)-bit shift (JM rshift_rnd_sf):
        # addend is half the divisor, so requant_dc(dequant_dc(L)) == L
        rw = int(REQUANT_W_4x4[q % 6][0])
        qbits = 15 + q // 6
        return np.sign(d) * ((np.abs(d) * rw + (1 << qbits)) >> (qbits + 1))

    if switching:
        ldc = quant_dc(dc_t, qsc) + dc_levels.reshape(2, 2)
    else:
        lt = quant_dc(dc_t, qpc) + dc_levels.reshape(2, 2)
        ldc = requant_dc(dequant_dc(lt, qpc), qsc)
    # final DC scaling per 8.5.11 (flat): H2 . L . H2, * 16V << qsc/6 >> 5
    dcs = chroma_dc_dequant(ldc, 16 * int(NORM_ADJUST_4x4[qsc % 6][0]), qsc)
    out = np.empty((8, 8), np.int64)
    for k in range(4):
        if switching:
            ls = sp_quant_4x4(t[k], qsc) + ac_levels_raster[k]
        else:
            lt = sp_quant_4x4(t[k], qpc) + ac_levels_raster[k]
            ls = sp_requant_4x4(sp_dequant_4x4(lt, qpc), qsc)
        w = sp_dequant_4x4(ls, qsc)
        w[0, 0] = dcs[k // 2, k % 2]
        out[(k // 2) * 4 : (k // 2) * 4 + 4, (k % 2) * 4 : (k % 2) * 4 + 4] = (
            idct_4x4(w)
        )
    return out
