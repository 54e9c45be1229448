"""Batched dequant + inverse transforms (spec 8.5), plain torch, exact int32.

Counterpart of h264decode_tpu/kernels/transform.py: every block of the frame
is transformed at once. All arithmetic is int32 adds, multiplies and shifts
(`>>` on negative int32 is arithmetic, as the spec requires); the 2x2/4x4 DC
Hadamards are written out as butterflies because CUDA has no integer matmul.

Residual tensors arrive in SCAN order as the host entropy stage emits them
(tensors/frame_tensors.py); the de-zigzag is a fixed-permutation gather.
"""

from __future__ import annotations

import numpy as np
import torch

from ..pipeline.reference_recon import (
    NORM_ADJUST_4x4,
    NORM_ADJUST_8x8,
    _POS_CLASS_4x4,
    _POS_CLASS_8x8,
)
from ..tensors.frame_tensors import CHROMA422_DC_SCAN, LUMA_BLK_XY, ZIGZAG_4x4, ZIGZAG_8x8
from .device_tables import device_table

# inverse permutations: raster position -> scan index
_DEZIG4 = np.zeros(16, np.int64)
_DEZIG4[ZIGZAG_4x4] = np.arange(16)
_DEZIG8 = np.zeros(64, np.int64)
_DEZIG8[ZIGZAG_8x8] = np.arange(64)

# raster 4x4 position within the MB -> z-order block index
_Z_OF_RASTER = np.zeros(16, np.int64)
for _z, (_bx, _by) in enumerate(LUMA_BLK_XY):
    _Z_OF_RASTER[_by * 4 + _bx] = _z
_ZX = np.array([bx for bx, by in LUMA_BLK_XY], np.int64)
_ZY = np.array([by for bx, by in LUMA_BLK_XY], np.int64)

# Table 8-15: QPc from clipped qPI
CHROMA_QP_TAB = np.concatenate(
    [
        np.arange(30),
        np.array(
            [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38,
             39, 39, 39, 39],
            np.int32,
        ),
    ]
).astype(np.int32)


def level_scale_tables_4x4(weight_scale_zz) -> np.ndarray:
    """LevelScale4x4 for all 6 qp%6 values: [6, 4, 4] int32 (host numpy,
    a per-SPS/PPS constant)."""
    ws = np.zeros(16, np.int32)
    ws[ZIGZAG_4x4] = np.asarray(weight_scale_zz, np.int32)
    ws = ws.reshape(4, 4)
    return ws[None] * NORM_ADJUST_4x4[:, _POS_CLASS_4x4]


def level_scale_tables_8x8(weight_scale_zz) -> np.ndarray:
    ws = np.zeros(64, np.int32)
    ws[ZIGZAG_8x8] = np.asarray(weight_scale_zz, np.int32)
    ws = ws.reshape(8, 8)
    return ws[None] * NORM_ADJUST_8x8[:, _POS_CLASS_8x8]


def _idx(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return device_table(a, like.device)


def dezigzag4(scan: torch.Tensor) -> torch.Tensor:
    """[..., 16] scan order -> [..., 4, 4] raster."""
    return scan[..., _idx(_DEZIG4, scan)].reshape(*scan.shape[:-1], 4, 4)


def dezigzag8(scan: torch.Tensor) -> torch.Tensor:
    return scan[..., _idx(_DEZIG8, scan)].reshape(*scan.shape[:-1], 8, 8)


def idct4x4(d: torch.Tensor) -> torch.Tensor:
    """spec 8.5.12.2 batched over leading dims: [..., 4, 4] -> residual."""
    d = d.to(torch.int32)
    e0 = d[..., :, 0] + d[..., :, 2]
    e1 = d[..., :, 0] - d[..., :, 2]
    e2 = (d[..., :, 1] >> 1) - d[..., :, 3]
    e3 = d[..., :, 1] + (d[..., :, 3] >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    g0 = f[..., 0, :] + f[..., 2, :]
    g1 = f[..., 0, :] - f[..., 2, :]
    g2 = (f[..., 1, :] >> 1) - f[..., 3, :]
    g3 = f[..., 1, :] + (f[..., 3, :] >> 1)
    h = torch.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], dim=-2)
    return (h + 32) >> 6


def _idct8_1d(a: torch.Tensor) -> torch.Tensor:
    """One 8-point pass along the last axis."""
    e0 = a[..., 0] + a[..., 4]
    e1 = -a[..., 3] + a[..., 5] - a[..., 7] - (a[..., 7] >> 1)
    e2 = a[..., 0] - a[..., 4]
    e3 = a[..., 1] + a[..., 7] - a[..., 3] - (a[..., 3] >> 1)
    e4 = (a[..., 2] >> 1) - a[..., 6]
    e5 = -a[..., 1] + a[..., 7] + a[..., 5] + (a[..., 5] >> 1)
    e6 = a[..., 2] + (a[..., 6] >> 1)
    e7 = a[..., 3] + a[..., 5] + a[..., 1] + (a[..., 1] >> 1)
    f0 = e0 + e6
    f1 = e1 + (e7 >> 2)
    f2 = e2 + e4
    f3 = e3 + (e5 >> 2)
    f4 = e2 - e4
    f5 = (e3 >> 2) - e5
    f6 = e0 - e6
    f7 = e7 - (e1 >> 2)
    return torch.stack(
        [f0 + f7, f2 + f5, f4 + f3, f6 + f1, f6 - f1, f4 - f3, f2 - f5, f0 - f7],
        dim=-1,
    )


def idct8x8(d: torch.Tensor) -> torch.Tensor:
    """spec 8.5.12.3 batched: [..., 8, 8]."""
    g = _idct8_1d(d.to(torch.int32))  # rows
    h = _idct8_1d(g.transpose(-1, -2)).transpose(-1, -2)  # columns
    return (h + 32) >> 6


def hadamard4x4(c: torch.Tensor) -> torch.Tensor:
    """spec 8.5.10 luma DC transform H c H, batched [..., 4, 4]."""

    def pass_(a):  # H @ a along dim -2
        s0, s1, s2, s3 = a[..., 0, :], a[..., 1, :], a[..., 2, :], a[..., 3, :]
        return torch.stack(
            [s0 + s1 + s2 + s3, s0 + s1 - s2 - s3, s0 - s1 - s2 + s3,
             s0 - s1 + s2 - s3],
            dim=-2,
        )

    c = c.to(torch.int32)
    return pass_(pass_(c).transpose(-1, -2)).transpose(-1, -2)


def hadamard2x2(c: torch.Tensor) -> torch.Tensor:
    """[[1,1],[1,-1]] c [[1,1],[1,-1]] batched [..., 2, 2]."""
    a, b = c[..., 0, 0], c[..., 0, 1]
    cc, d = c[..., 1, 0], c[..., 1, 1]
    return torch.stack(
        [torch.stack([a + b + cc + d, a - b + cc - d], -1),
         torch.stack([a + b - cc - d, a - b - cc + d], -1)],
        dim=-2,
    )


def chroma_qp(qp_y: torch.Tensor, offset: int, bd_off_c: int = 0) -> torch.Tensor:
    """Table 8-15 QPc; qPI clips into [-QpBdOffsetC, 51] and the effective
    QP'c = QPc + QpBdOffsetC (what dequant consumes) is returned."""
    qpi = torch.clamp(qp_y.to(torch.int32) + offset, -bd_off_c, 51)
    if bd_off_c == 0:  # 8 bits: qPI is in 0..51, where the table is QPc
        return _idx(CHROMA_QP_TAB, qpi)[qpi.long()]
    qpc = _idx(CHROMA_QP_TAB, qpi)[torch.clamp(qpi, 0, 51).long()]
    return torch.where(qpi < 30, qpi, qpc) + bd_off_c


def blocks_to_plane(blocks: torch.Tensor, mb_h: int, mb_w: int) -> torch.Tensor:
    """[nMB, 16, 4, 4] per-4x4-block values (z-order within MB) -> [16*mb_h,
    16*mb_w] plane."""
    b = blocks[:, _idx(_Z_OF_RASTER, blocks)]  # [nMB, 16(raster), 4, 4]
    b = b.reshape(mb_h, mb_w, 4, 4, 4, 4)  # mby, mbx, by, bx, y, x
    b = b.permute(0, 2, 4, 1, 3, 5)  # mby, by, y, mbx, bx, x
    return b.reshape(mb_h * 16, mb_w * 16)


def blocks8_to_plane(blocks: torch.Tensor, mb_h: int, mb_w: int) -> torch.Tensor:
    """[nMB, 4, 8, 8] (raster 8x8 blocks) -> [16*mb_h, 16*mb_w]."""
    b = blocks.reshape(mb_h, mb_w, 2, 2, 8, 8).permute(0, 2, 4, 1, 3, 5)
    return b.reshape(mb_h * 16, mb_w * 16)


def chroma_blocks_to_plane(blocks: torch.Tensor, mb_h: int, mb_w: int) -> torch.Tensor:
    """[nMB, 4(raster), 4, 4] chroma 4x4 blocks -> [8*mb_h, 8*mb_w]."""
    b = blocks.reshape(mb_h, mb_w, 2, 2, 4, 4).permute(0, 2, 4, 1, 3, 5)
    return b.reshape(mb_h * 8, mb_w * 8)


def chroma_blocks_to_plane_422(blocks: torch.Tensor, mb_h: int, mb_w: int) -> torch.Tensor:
    """[nMB, 8(raster 2x4), 4, 4] 4:2:2 chroma blocks -> [16*mb_h, 8*mb_w]."""
    b = blocks.reshape(mb_h, mb_w, 4, 2, 4, 4).permute(0, 2, 4, 1, 3, 5)
    return b.reshape(mb_h * 16, mb_w * 8)


def _sel_m(tab_mb: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """tab_mb: [nMB, 6, ...]; qp: [nMB] -> [nMB, 1, ...] rows at qp % 6."""
    rows = torch.arange(tab_mb.shape[0], device=tab_mb.device)
    return tab_mb[rows, (qp % 6).long()].unsqueeze(1)


def _dequant(c, ls, qp, shift_hi):
    """Shared 8.5.12.1 / 8.5.13.1 scaling: qp >= 6*shift_hi shifts left,
    below rounds right. c: [nMB, B, k, k]; ls: [nMB, 1, k, k]."""
    qp_div6 = (qp // 6).reshape(-1, 1, 1, 1)
    hi = (c * ls) << torch.clamp(qp_div6 - shift_hi, min=0)
    rnd = torch.ones_like(qp_div6) << torch.clamp(shift_hi - 1 - qp_div6, min=0)
    lo = (c * ls + rnd) >> torch.clamp(shift_hi - qp_div6, min=0)
    return torch.where(qp_div6 >= shift_hi, hi, lo)


def luma_residual_plane(
    luma_ac: torch.Tensor,  # [nMB, 16, 16] scan order (z-order blocks)
    luma_dc: torch.Tensor,  # [nMB, 16] scan order
    luma8_ac: torch.Tensor,  # [nMB, 4, 64] scan order
    qp: torch.Tensor,  # [nMB]
    is_i16: torch.Tensor,  # [nMB] bool
    is_t8: torch.Tensor,  # [nMB] bool
    intra: torch.Tensor,  # [nMB] bool (selects intra vs inter scaling lists)
    ls4: torch.Tensor,  # [2, 6, 4, 4]: [intra/inter][m]
    ls8: torch.Tensor,  # [2, 6, 8, 8]
    mb_h: int,
    mb_w: int,
) -> torch.Tensor:
    """Full luma residual plane for every MB at once (spec 8.5.12/8.5.13)."""
    qp = qp.to(torch.int32)
    i4 = intra.reshape(-1, 1, 1, 1)
    ls4_mb = torch.where(i4, ls4[0], ls4[1])  # [nMB, 6, 4, 4]
    d = _dequant(dezigzag4(luma_ac.to(torch.int32)), _sel_m(ls4_mb, qp), qp, 4)
    # Intra16x16 DC path (8.5.10)
    f = hadamard4x4(dezigzag4(luma_dc.to(torch.int32)))  # [nMB, 4, 4]
    ls00 = _sel_m(ls4_mb[:, :, 0, 0], qp)  # [nMB, 1]
    qd = (qp // 6).reshape(-1, 1, 1)
    hi = (f * ls00[:, :, None]) << torch.clamp(qd - 6, min=0)
    rnd = torch.ones_like(qd) << torch.clamp(5 - qd, min=0)
    lo = (f * ls00[:, :, None] + rnd) >> torch.clamp(6 - qd, min=0)
    dcy = torch.where(qd >= 6, hi, lo)  # [nMB, 4, 4]
    dc_per_block = dcy[:, _idx(_ZY, dcy), _idx(_ZX, dcy)]  # [nMB, 16] z-order
    d = d.clone()
    d[:, :, 0, 0] = torch.where(is_i16[:, None], dc_per_block, d[:, :, 0, 0])
    plane4 = blocks_to_plane(idct4x4(d), mb_h, mb_w)
    # 8x8 path
    ls8_mb = torch.where(i4, ls8[0], ls8[1])
    d8 = _dequant(dezigzag8(luma8_ac.to(torch.int32)), _sel_m(ls8_mb, qp), qp, 6)
    plane8 = blocks8_to_plane(idct8x8(d8), mb_h, mb_w)
    t8_mask = is_t8.reshape(mb_h, 1, mb_w, 1).expand(mb_h, 16, mb_w, 16)
    return torch.where(t8_mask.reshape(mb_h * 16, mb_w * 16), plane8, plane4)


def chroma_residual_planes(
    chroma_dc: torch.Tensor,  # [nMB, 2, 4] scan
    chroma_ac: torch.Tensor,  # [nMB, 2, 4, 16] scan (raster blocks)
    qp: torch.Tensor,  # [nMB] luma qp
    intra: torch.Tensor,  # [nMB] bool
    ls4: torch.Tensor,  # [2(intra/inter), 2(cb/cr), 6, 4, 4]
    qp_offsets: tuple[int, int],
    mb_h: int,
    mb_w: int,
    bd: int = 8,
):
    """Residual planes for Cb and Cr, 4:2:0 (spec 8.5.11 + 8.5.12); qp is
    the raw QPY, bd the chroma bit depth."""
    out = []
    i4 = intra.reshape(-1, 1, 1, 1)
    for comp in range(2):
        qpc = chroma_qp(qp, int(qp_offsets[comp]), 6 * (bd - 8))  # [nMB] QP'c
        ls = torch.where(i4, ls4[0, comp], ls4[1, comp])  # [nMB, 6, 4, 4]
        f = hadamard2x2(chroma_dc[:, comp].to(torch.int32).reshape(-1, 2, 2))
        ls00 = _sel_m(ls[:, :, 0, 0], qpc)[:, :, None]  # [nMB, 1, 1]
        dcc = ((f * ls00) << (qpc // 6).reshape(-1, 1, 1)) >> 5
        c = dezigzag4(chroma_ac[:, comp].to(torch.int32))  # [nMB, 4, 4, 4]
        d = _dequant(c, _sel_m(ls, qpc), qpc, 4).clone()
        d[:, :, 0, 0] = dcc.reshape(-1, 4)  # raster 2x2 = block raster order
        out.append(chroma_blocks_to_plane(idct4x4(d), mb_h, mb_w))
    return out[0], out[1]


# 4:2:2 chroma DC scan position -> raster position in the [4, 2] DC grid
_DC422_PERM = np.zeros(8, np.int64)
for _k, (_i, _j) in enumerate(CHROMA422_DC_SCAN):
    _DC422_PERM[_i * 2 + _j] = _k


def chroma_residual_planes_422(
    chroma_dc: torch.Tensor,  # [nMB, 2, 8] spec 8.5.4 inverse-scan order
    chroma_ac: torch.Tensor,  # [nMB, 2, 8, 16] scan (raster 2x4 blocks)
    qp: torch.Tensor,  # [nMB] luma qp
    intra: torch.Tensor,  # [nMB] bool
    ls4: torch.Tensor,  # [2(intra/inter), 2(cb/cr), 6, 4, 4]
    qp_offsets: tuple[int, int],
    mb_h: int,
    mb_w: int,
    bd: int = 8,
):
    """4:2:2 residual planes for Cb and Cr: 8 blocks per MB component with
    the 2x4 DC transform at qP,DC = QP'c + 3 (spec 8.5.11.1-2 for
    ChromaArrayType 2), written out as butterflies."""
    out = []
    i4 = intra.reshape(-1, 1, 1, 1)
    for comp in range(2):
        qpc = chroma_qp(qp, int(qp_offsets[comp]), 6 * (bd - 8))
        ls = torch.where(i4, ls4[0, comp], ls4[1, comp])  # [nMB, 6, 4, 4]
        c = chroma_dc[:, comp].to(torch.int32)[:, _idx(_DC422_PERM, qp)].reshape(-1, 4, 2)
        c0, c1, c2, c3 = c[:, 0], c[:, 1], c[:, 2], c[:, 3]  # rows of [nMB, 2]
        g = torch.stack([c0 + c1 + c2 + c3, c0 + c1 - c2 - c3, c0 - c1 - c2 + c3,
                         c0 - c1 + c2 - c3], dim=1)  # H4 @ c
        f = torch.stack([g[..., 0] + g[..., 1], g[..., 0] - g[..., 1]], dim=-1)  # @ H2
        qp_dc = qpc + 3
        ls00 = _sel_m(ls[:, :, 0, 0], qp_dc)[:, :, None]  # [nMB, 1, 1]
        dv6 = (qp_dc // 6).reshape(-1, 1, 1)
        hi = (f * ls00) << torch.clamp(dv6 - 6, min=0)
        rnd = torch.ones_like(dv6) << torch.clamp(5 - dv6, min=0)
        lo = (f * ls00 + rnd) >> torch.clamp(6 - dv6, min=0)
        dcc = torch.where(dv6 >= 6, hi, lo)  # [nMB, 4, 2]
        d = _dequant(dezigzag4(chroma_ac[:, comp].to(torch.int32)), _sel_m(ls, qpc), qpc,
                     4).clone()
        d[:, :, 0, 0] = dcc.reshape(-1, 8)  # raster 2x4 = block order
        out.append(chroma_blocks_to_plane_422(idct4x4(d), mb_h, mb_w))
    return out[0], out[1]
