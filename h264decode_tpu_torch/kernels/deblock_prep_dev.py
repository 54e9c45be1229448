"""Derivation of the deblock edge parameters on the device, plain torch.

Counterpart of h264decode_tpu/kernels/deblock_prep_dev.py (itself the twin
of pipeline/deblock_prep.py): boundary strength per 4x4 cell edge from the
coded status, MVs and ring-slot picture identities, and indexA/indexB for
luma and both chroma components. The outputs feed kernels/deblock.py and
kernels/deblock_cuda.py directly; every grid is int32 [H4, W4] (chroma
thresholds [2, H4, W4]). For 4:2:2 (chroma_all_h_edges) it also emits
bs_hc, the horizontal bS without the 8x8-transform suppression: 4:2:2
chroma has a transform edge every 4 chroma rows, at every luma cell row.
"""

from __future__ import annotations

import torch

from .device_tables import device_table
from .transform import CHROMA_QP_TAB


def _mb_to_cells(a: torch.Tensor, mb_h: int, mb_w: int) -> torch.Tensor:
    return a.reshape(mb_h, 1, mb_w, 1).expand(mb_h, 4, mb_w, 4).reshape(
        mb_h * 4, mb_w * 4
    )


def _part_to_cells(a: torch.Tensor, mb_h: int, mb_w: int) -> torch.Tensor:
    """[nMB, 4] (2x2 8x8 partitions, raster) -> [4*mb_h, 4*mb_w]."""
    g = a.reshape(mb_h, mb_w, 2, 2).permute(0, 2, 1, 3)
    return g.reshape(mb_h, 2, 1, mb_w, 2, 1).expand(mb_h, 2, 2, mb_w, 2, 2).reshape(
        mb_h * 4, mb_w * 4
    )


def _blk_to_cells(a: torch.Tensor, mb_h: int, mb_w: int) -> torch.Tensor:
    """[nMB, 16] (raster 4x4 within MB) -> [4*mb_h, 4*mb_w]."""
    return a.reshape(mb_h, mb_w, 4, 4).permute(0, 2, 1, 3).reshape(mb_h * 4, mb_w * 4)


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """The neighbour across the edge (left for dx=-1, above for dy=-1);
    row/column 0 repeats itself (those edges are masked by `exists`)."""
    out = a
    if dx == -1:
        out = torch.cat([out[:, :1], out[:, :-1]], dim=1)
    if dy == -1:
        out = torch.cat([out[:1], out[:-1]], dim=0)
    return out


def _cqp(qp: torch.Tensor, offset: int) -> torch.Tensor:
    qpi = torch.clamp(qp + offset, 0, 51)
    return device_table(CHROMA_QP_TAB, qp.device)[qpi.long()]


def deblock_prep_device(
    mb_cls,  # [nMB] int32
    qp_mb,  # [nMB] int32
    t8_mb,  # [nMB] bool
    slice_mb,  # [nMB] int32
    disable_mb,  # [nMB] int32
    aoff_mb,  # [nMB] int32
    boff_mb,  # [nMB] int32
    nnz,  # [H4, W4] int32 (>0 = coded 4x4 cell)
    ref_pic,  # [nMB, 2, 4] int32 (used when slot_cells is None)
    mv,  # [2, H4, W4, 2] int32 (per-cell final MVs)
    qp_offsets,  # (cb_off, cr_off)
    mb_h: int,
    mb_w: int,
    slot_cells=None,  # optional [2, H4, W4] ref slots
    chroma_all_h_edges: bool = False,  # 4:2:2: also emit "bs_hc"
) -> dict:
    H4, W4 = mb_h * 4, mb_w * 4
    dev = qp_mb.device
    qp_mb = qp_mb.to(torch.int32)
    cls = _mb_to_cells(mb_cls, mb_h, mb_w)
    intra = cls < 3
    qp = _mb_to_cells(qp_mb, mb_h, mb_w)
    cqp_cells = [
        _mb_to_cells(_cqp(qp_mb, int(off)), mb_h, mb_w) for off in qp_offsets
    ]
    t8 = _mb_to_cells(t8_mb, mb_h, mb_w)
    slc = _mb_to_cells(slice_mb, mb_h, mb_w)
    disable = _mb_to_cells(disable_mb, mb_h, mb_w)
    a_off = _mb_to_cells(aoff_mb, mb_h, mb_w).to(torch.int32)
    b_off = _mb_to_cells(boff_mb, mb_h, mb_w).to(torch.int32)
    nz = nnz > 0
    blk8 = nz.reshape(mb_h * 2, 2, mb_w * 2, 2).any(dim=3).any(dim=1)
    nnz8 = blk8.repeat_interleave(2, 0).repeat_interleave(2, 1)
    coded = torch.where(t8, nnz8, nz)

    if slot_cells is not None:
        r = [slot_cells[0], slot_cells[1]]
    else:
        r = [_part_to_cells(ref_pic[:, lst, :], mb_h, mb_w) for lst in range(2)]
    u = [r[0] >= 0, r[1] >= 0]
    mvx = [mv[0, ..., 0], mv[1, ..., 0]]
    mvy = [mv[0, ..., 1], mv[1, ..., 1]]

    def far(ax, ay, bx, by):
        return ((ax - bx).abs() >= 4) | ((ay - by).abs() >= 4)

    prep = {}
    for direction in ("v", "h"):
        if direction == "v":
            dy, dx = 0, -1
            pos = (torch.arange(W4, device=dev) % 4).expand(H4, W4)
            at_edge = (torch.arange(W4, device=dev) == 0).expand(H4, W4)
        else:
            dy, dx = -1, 0
            pos = (torch.arange(H4, device=dev) % 4)[:, None].expand(H4, W4)
            at_edge = (torch.arange(H4, device=dev) == 0)[:, None].expand(H4, W4)

        u0p, u1p = _shift(u[0], dy, dx), _shift(u[1], dy, dx)
        np_ = u0p.to(torch.int32) + u1p.to(torch.int32)
        nq = u[0].to(torch.int32) + u[1].to(torch.int32)
        r0p, r1p = _shift(r[0], dy, dx), _shift(r[1], dy, dx)
        mx0p, my0p = _shift(mvx[0], dy, dx), _shift(mvy[0], dy, dx)
        mx1p, my1p = _shift(mvx[1], dy, dx), _shift(mvy[1], dy, dx)

        one = torch.ones((), dtype=torch.int32, device=dev)
        bs = (np_ != nq).to(torch.int32)
        single = (np_ == 1) & (nq == 1)
        sp_r = torch.where(u0p, r0p, r1p)
        sq_r = torch.where(u[0], r[0], r[1])
        sp_mx = torch.where(u0p, mx0p, mx1p)
        sp_my = torch.where(u0p, my0p, my1p)
        sq_mx = torch.where(u[0], mvx[0], mvx[1])
        sq_my = torch.where(u[0], mvy[0], mvy[1])
        bs = torch.where(
            single & ((sp_r != sq_r) | far(sp_mx, sp_my, sq_mx, sq_my)), one, bs
        )
        bi = (np_ == 2) & (nq == 2)
        sets_eq = ((r0p == r[0]) & (r1p == r[1])) | ((r0p == r[1]) & (r1p == r[0]))
        bs = torch.where(bi & ~sets_eq, one, bs)
        same_ref = r0p == r1p
        straight = ~far(mx0p, my0p, mvx[0], mvy[0]) & ~far(mx1p, my1p, mvx[1], mvy[1])
        crossed = ~far(mx0p, my0p, mvx[1], mvy[1]) & ~far(mx1p, my1p, mvx[0], mvy[0])
        bs = torch.where(bi & sets_eq & same_ref & ~(straight | crossed), one, bs)
        d_ok = torch.where(r0p == r[0], straight, crossed)
        bs = torch.where(bi & sets_eq & ~same_ref & ~d_ok, one, bs)

        p_intra = _shift(intra, dy, dx)
        p_coded = _shift(coded, dy, dx)
        p_slice = _shift(slc, dy, dx)
        p_qp = _shift(qp, dy, dx)
        mb_boundary = pos == 0
        bs = torch.where(coded | p_coded, 2 * one, bs)
        bs = torch.where(
            intra | p_intra, torch.where(mb_boundary, 4 * one, 3 * one), bs
        )
        common = (disable != 1) & ~((disable == 2) & mb_boundary & (p_slice != slc))
        exists = torch.where(
            mb_boundary, ~at_edge, torch.where(t8, pos == 2, torch.ones_like(t8))
        )
        if direction == "h" and chroma_all_h_edges:
            exists_c = torch.where(mb_boundary, ~at_edge, torch.ones_like(t8)) & common
            prep["bs_hc"] = torch.where(exists_c, bs, 0 * one).contiguous()
        bs = torch.where(exists & common, bs, 0 * one)

        qp_av = (p_qp + qp + 1) >> 1
        prep[f"bs_{direction}"] = bs.contiguous()
        prep[f"ia_{direction}"] = torch.clamp(qp_av + a_off, 0, 51).contiguous()
        prep[f"ib_{direction}"] = torch.clamp(qp_av + b_off, 0, 51).contiguous()
        ca, cbt = [], []
        for cq in cqp_cells:
            qpc_av = (_shift(cq, dy, dx) + cq + 1) >> 1
            ca.append(torch.clamp(qpc_av + a_off, 0, 51))
            cbt.append(torch.clamp(qpc_av + b_off, 0, 51))
        prep[f"ca_{direction}"] = torch.stack(ca).to(torch.int32).contiguous()
        prep[f"cb_{direction}"] = torch.stack(cbt).to(torch.int32).contiguous()
    return prep


def expand_slot_mv(slot_parts, mv_parts, is_intra, mb_h: int, mb_w: int):
    """Expand the compact per-MB motion arrays to per-cell grids (JAX:
    kernels/deblock_prep_dev.py:173): slot_parts [n, 2, 4] -> slot [2, H4, W4]
    int32 (intra cells forced to -1), mv_parts [n, 2, 16, 2] -> mv
    [2, H4, W4, 2] int32. The row-band sharded step (dist/sharded.py) ships
    the compact form and expands it band by band."""
    intra_cell = _mb_to_cells(is_intra, mb_h, mb_w)
    sp = slot_parts.to(torch.int32)
    mp = mv_parts.to(torch.int32)
    slot = torch.stack([
        torch.where(intra_cell, -1, _part_to_cells(sp[:, lst], mb_h, mb_w)) for lst in range(2)
    ])
    mv = torch.stack([
        torch.stack([_blk_to_cells(mp[:, lst, :, c], mb_h, mb_w) for c in range(2)], dim=-1)
        for lst in range(2)
    ])
    return slot.contiguous(), mv.contiguous()
