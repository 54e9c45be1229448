"""Vectorized (numpy) derivation of per-edge deblocking parameters from
FrameTensors: boundary strengths (spec 8.7.2.1) and threshold indices
(8.7.2.2) for every 4x4 cell edge at once. Output feeds the device kernel
kernels/deblock.py; bit-exact against the per-line oracle pipeline/deblock.py.

Hot path of the host stage — everything is reshape/broadcast expansion
(no gathers) plus flat boolean algebra.
"""

from __future__ import annotations

import numpy as np

from ..syntax.pps import PPS
from ..syntax.sps import SPS
from ..tensors.frame_tensors import FrameTensors
from .reference_recon import CHROMA_QP_TABLE


def _chroma_qp_vec(qp, offset):
    qpi = np.clip(qp.astype(np.int32) + offset, 0, 51)
    return np.where(qpi < 30, qpi, CHROMA_QP_TABLE[np.clip(qpi - 30, 0, 21)])


def _mb_to_cells(a, mb_h, mb_w):
    """[nMB] -> [4*mb_h, 4*mb_w] by replication."""
    return np.broadcast_to(
        a.reshape(mb_h, 1, mb_w, 1), (mb_h, 4, mb_w, 4)
    ).reshape(mb_h * 4, mb_w * 4)


def _blk_to_cells(a, mb_h, mb_w):
    """[nMB, 16] (raster 4x4 within MB) -> [4*mb_h, 4*mb_w]."""
    return (
        a.reshape(mb_h, mb_w, 4, 4).transpose(0, 2, 1, 3).reshape(mb_h * 4, mb_w * 4)
    )


def _part_to_cells(a, mb_h, mb_w):
    """[nMB, 4] (2x2 parts) -> [4*mb_h, 4*mb_w]."""
    g = a.reshape(mb_h, mb_w, 2, 2).transpose(0, 2, 1, 3)  # [mb_h,2,mb_w,2]
    return np.broadcast_to(
        g.reshape(mb_h, 2, 1, mb_w, 2, 1), (mb_h, 2, 2, mb_w, 2, 2)
    ).reshape(mb_h * 4, mb_w * 4)


def _shift(a, dy, dx):
    """out[y, x] = a[y+dy, x+dx]; edge rows/cols replicate (masked anyway)."""
    out = a
    if dx == -1:
        out = np.concatenate([out[:, :1], out[:, :-1]], axis=1)
    if dy == -1:
        out = np.concatenate([out[:1], out[:-1]], axis=0)
    return out


def prepare_deblock(ft: FrameTensors, sps: SPS, pps: PPS) -> dict:
    """All per-edge parameters for the device deblock kernel."""
    mb_h, mb_w = ft.mb_h, ft.mb_w
    H4, W4 = mb_h * 4, mb_w * 4
    cls = _mb_to_cells(ft.mb_class, mb_h, mb_w)
    intra = cls < 3
    qp = _mb_to_cells(ft.qp.astype(np.int32), mb_h, mb_w)
    t8 = _mb_to_cells(ft.transform_8x8, mb_h, mb_w)
    slc = _mb_to_cells(ft.slice_id, mb_h, mb_w)
    disable = _mb_to_cells(ft.disable_deblock, mb_h, mb_w)
    a_off = _mb_to_cells(ft.alpha_off.astype(np.int32), mb_h, mb_w)
    b_off = _mb_to_cells(ft.beta_off.astype(np.int32), mb_h, mb_w)
    nnz = ft.luma_nnz > 0
    blk8 = nnz.reshape(mb_h * 2, 2, mb_w * 2, 2).any(axis=(1, 3))
    nnz8 = np.repeat(np.repeat(blk8, 2, 0), 2, 1)
    coded = np.where(t8, nnz8, nnz)

    any_inter = bool((ft.mb_class >= 3).any())
    if any_inter:
        u = [None, None]
        r = [None, None]
        mx = [None, None]
        my = [None, None]
        for lst in range(2):
            r[lst] = _part_to_cells(ft.ref_pic[:, lst, :], mb_h, mb_w)
            u[lst] = r[lst] >= 0
            mx[lst] = _blk_to_cells(ft.mv[:, lst, :, 0].astype(np.int32), mb_h, mb_w)
            my[lst] = _blk_to_cells(ft.mv[:, lst, :, 1].astype(np.int32), mb_h, mb_w)

    prep = {}
    for direction in ("v", "h"):
        if direction == "v":
            dy, dx = 0, -1
            pos = np.broadcast_to(np.arange(W4) % 4, (H4, W4))
            at_edge = np.broadcast_to(np.arange(W4) == 0, (H4, W4))
        else:
            dy, dx = -1, 0
            pos = np.broadcast_to((np.arange(H4) % 4)[:, None], (H4, W4))
            at_edge = np.broadcast_to((np.arange(H4) == 0)[:, None], (H4, W4))

        bs = np.zeros((H4, W4), np.int32)
        if any_inter:
            # motion-derived bS (spec 8.7.2.1 tail): P = shifted neighbor
            u0p, u1p = _shift(u[0], dy, dx), _shift(u[1], dy, dx)
            np_ = u0p.astype(np.int32) + u1p
            nq = u[0].astype(np.int32) + u[1]
            r0p, r1p = _shift(r[0], dy, dx), _shift(r[1], dy, dx)
            mx0p, my0p = _shift(mx[0], dy, dx), _shift(my[0], dy, dx)
            mx1p, my1p = _shift(mx[1], dy, dx), _shift(my[1], dy, dx)

            def far(ax, ay, bx, by):
                return (np.abs(ax - bx) >= 4) | (np.abs(ay - by) >= 4)

            bs = (np_ != nq).astype(np.int32)
            single = (np_ == 1) & (nq == 1)
            sp_r = np.where(u0p, r0p, r1p)
            sq_r = np.where(u[0], r[0], r[1])
            sp_mx = np.where(u0p, mx0p, mx1p)
            sp_my = np.where(u0p, my0p, my1p)
            sq_mx = np.where(u[0], mx[0], mx[1])
            sq_my = np.where(u[0], my[0], my[1])
            bs = np.where(
                single & ((sp_r != sq_r) | far(sp_mx, sp_my, sq_mx, sq_my)), 1, bs
            )
            bi = (np_ == 2) & (nq == 2)
            if bi.any():
                sets_eq = ((r0p == r[0]) & (r1p == r[1])) | (
                    (r0p == r[1]) & (r1p == r[0])
                )
                bs = np.where(bi & ~sets_eq, 1, bs)
                same_ref = r0p == r1p
                straight = ~far(mx0p, my0p, mx[0], my[0]) & ~far(
                    mx1p, my1p, mx[1], my[1]
                )
                crossed = ~far(mx0p, my0p, mx[1], my[1]) & ~far(
                    mx1p, my1p, mx[0], my[0]
                )
                bs = np.where(
                    bi & sets_eq & same_ref & ~(straight | crossed), 1, bs
                )
                d_ok = np.where(r0p == r[0], straight, crossed)
                bs = np.where(bi & sets_eq & ~same_ref & ~d_ok, 1, bs)

        p_intra = _shift(intra, dy, dx)
        p_coded = _shift(coded, dy, dx)
        p_slice = _shift(slc, dy, dx)
        p_qp = _shift(qp, dy, dx)
        mb_boundary = pos == 0
        bs = np.where(coded | p_coded, 2, bs)
        bs = np.where(intra | p_intra, np.where(mb_boundary, 4, 3), bs)
        exists = np.where(mb_boundary, ~at_edge, np.where(t8, pos == 2, True))
        exists &= disable != 1
        exists &= ~((disable == 2) & mb_boundary & (p_slice != slc))
        bs = np.where(exists, bs, 0)

        qp_av = (p_qp + qp + 1) >> 1
        prep[f"bs_{direction}"] = bs
        prep[f"ia_{direction}"] = np.clip(qp_av + a_off, 0, 51).astype(np.int32)
        prep[f"ib_{direction}"] = np.clip(qp_av + b_off, 0, 51).astype(np.int32)
        ca, cbt = [], []
        for off in (pps.chroma_qp_index_offset, pps.second_chroma_qp_index_offset):
            qpc_p = _chroma_qp_vec(p_qp, off)
            qpc_q = _chroma_qp_vec(qp, off)
            qpc_av = (qpc_p + qpc_q + 1) >> 1
            ca.append(np.clip(qpc_av + a_off, 0, 51).astype(np.int32))
            cbt.append(np.clip(qpc_av + b_off, 0, 51).astype(np.int32))
        prep[f"ca_{direction}"] = np.stack(ca)
        prep[f"cb_{direction}"] = np.stack(cbt)
    return prep
