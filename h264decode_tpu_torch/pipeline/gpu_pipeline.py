"""The per-frame GPU reconstruction program and its host glue.

Counterpart of h264decode_tpu/pipeline/tpu_pipeline.py. One call of
`frame_step` runs the whole device path for a frame: unpack the wire ->
residual transforms (kernels/transform) -> motion compensation from the DPB
ring (kernels/mc) -> intra (the CUDA kernels of kernels/intra_cuda) ->
bS and thresholds (kernels/deblock_prep_dev) -> deblocking (the CUDA
kernels of kernels/deblock_cuda) -> half-pel planes into the ring slot ->
one packed output plane [H + Hc, W] (Y on top, Cb | Cr below; 4:4:4:
[3H, W], Y, Cb, Cr stacked).

Formats on the device path, as in the JAX package: ChromaArrayType 1 (4:2:0)
and 2 (4:2:2, full-height chroma, Hc = H) and monochrome (run as 4:2:0;
its chroma planes hold the mid-gray convention), at one bit depth bd of
8..14 for luma and chroma, and 8-bit ChromaArrayType 3 (4:4:4), whose Cb
and Cr run the luma processes (_frame_core_444: per-component residuals,
luma MC from their own half-pel stacks, luma intra and the luma deblocking
filter, each kernel in one launch over the three planes). Samples are uint8
at 8 bits and int16 above (the same bits as uint16; torch has no CPU
arithmetic on uint16), and the host sees uint16 planes. High-bit-depth
4:4:4 and mixed luma/chroma depths decode on the host oracle.

The host side (GpuDecoder) drives entropy decoding into FrameTensors,
each picture's a task on worker threads beside the main thread (several
pictures at once, a B picture's waiting only for its colocated picture's),
builds the narrow per-frame wire and, on a worker thread while the main
thread sets up the next pictures, hands it to the frame program of
its signature (pipeline/frame_program.py: on a CUDA device frame_step
captured once in a CUDA graph per JAX jit signature, its static wire
buffer filled from one pinned staging buffer, the graph replayed), then
copies the packed plane back into pinned memory behind a CUDA event.
Everything runs on the GPU unless the caller asks for device="cpu", where
the kernel wrappers take their plain torch versions and the programs call
frame_step eagerly (the CPU tests do this).

The DPB ring is updated in place (torch tensors are mutable; the JAX
package re-feeds a functional ring).
"""

from __future__ import annotations

import contextlib
import sys
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from ..kernels import mc as mc_k
from ..kernels import transform as tr_k
from ..kernels.deblock_cuda import deblock_frame, deblock_planes, prep_444
from ..kernels.deblock_prep_dev import _mb_to_cells, deblock_prep_device
from ..kernels.intra import K_I4, K_I8, K_I16
from ..kernels.intra_cuda import intra_frame, intra_planes
from ..kernels.mc import sample_dtype
from ..syntax.pps import PPS
from ..syntax.sps import SPS
from ..tensors.frame_tensors import (
    LUMA_BLK_XY,
    MB_I_16X16,
    MB_I_NXN,
    MB_I_PCM,
    FrameTensors,
)
from ..utils.metrics import DecodeMetrics, timer
from . import frame_program
from .decoder import Decoder
from .dpb import Picture

# weight tables cover ref-list indices 0..R_W-1; the size grows (pow2) when
# a stream uses longer lists
R_W_DEFAULT = 16

# memory budget for the DPB rings on a CPU device: geometries whose rings
# would exceed it decode on the host oracle instead of failing in the
# allocator, as in the JAX package. On a CUDA device the budget is the
# card's memory, and a ring larger than that raises (see _ring_over_budget)
RING_BUDGET_MB = 6144

# pictures in flight on the recon worker (host prep + dispatch) while the
# main thread entropy-decodes the next one (as in the JAX package)
RECON_DEPTH = 3

_I32 = torch.int32


def _weight_cells(inp: dict, mb_h: int, mb_w: int):
    """Per-4x4-cell weighted-prediction parameters gathered from the small
    per-slice tables. A frame without weights ("w_tab" absent from the
    wire) gets the identity constants w=32/o=0/logWD=5, exact no-ops
    through mc.weighted_combine. Returns (luma(bi), chroma(comp, bi))
    getters of (w0, o0, w1, o1, lwd)."""
    if "w_tab" not in inp:
        def luma(bi):
            return 32, 0, 32, 0, 5

        def chroma(comp, bi):
            return 32, 0, 32, 0, 5

        return luma, chroma
    w_tab, o_tab = inp["w_tab"], inp["o_tab"]  # [S, 2, R]
    wc_tab, oc_tab = inp["wc_tab"], inp["oc_tab"]  # [S, 2, R, 2]
    lwd_tab = inp["lwd_tab"]  # [S, 2]
    pw0, pw1 = inp["pw0"], inp["pw1"]  # [S, R, R] bi weights (pair-indexed)
    pwc0, pwc1 = inp["pwc0"], inp["pwc1"]  # [S, R, R, 2]
    S, _, R = w_tab.shape
    sl = torch.clamp(_mb_to_cells(inp["slice_mb"], mb_h, mb_w), 0, S - 1).long()
    rc = inp["ridx_cells"]
    r0 = torch.clamp(rc[0], 0, R - 1).long()
    r1 = torch.clamp(rc[1], 0, R - 1).long()

    def pick(uni_tab, pair0, pair1, bi):
        u0 = uni_tab[sl, 0, r0]
        u1 = uni_tab[sl, 1, r1]
        return (torch.where(bi, pair0[sl, r0, r1], u0),
                torch.where(bi, pair1[sl, r0, r1], u1))

    def luma(bi):
        w0, w1 = pick(w_tab, pw0, pw1, bi)
        return w0, o_tab[sl, 0, r0], w1, o_tab[sl, 1, r1], lwd_tab[sl, 0]

    def chroma(comp, bi):
        w0, w1 = pick(wc_tab[..., comp], pwc0[..., comp], pwc1[..., comp], bi)
        return w0, oc_tab[sl, 0, r0, comp], w1, oc_tab[sl, 1, r1, comp], lwd_tab[sl, 1]

    return luma, chroma


def _rep(a, ry: int, rx: int):
    """Cell grid -> pixel grid (Python ints, the identity weights, pass)."""
    if not torch.is_tensor(a):
        return a
    return a.repeat_interleave(ry, 0).repeat_interleave(rx, 1)


def _residual_planes(inp: dict, mb_h: int, mb_w: int, has_l8: bool, cat: int = 1,
                     bd: int = 8):
    """The residual transforms (dequant, inverse DCT) of every MB: int32
    (ry, rcb, rcr). cat and bd as in _base_planes."""
    n = mb_h * mb_w
    dev = inp["qp"].device
    l8 = inp["luma8_ac"] if has_l8 else torch.zeros((n, 4, 64), dtype=_I32, device=dev)
    # QP'Y = QPY + QpBdOffsetY feeds luma dequant; chroma takes the raw QPY
    qp_y = inp["qp"] if bd == 8 else inp["qp"] + 6 * (bd - 8)
    ry = tr_k.luma_residual_plane(
        inp["luma_ac"], inp["luma_dc"], l8, qp_y, inp["is_i16"], inp["is_t8"],
        inp["is_intra"], inp["ls4_y"], inp["ls8_y"], mb_h, mb_w,
    )
    chroma_res = (tr_k.chroma_residual_planes_422 if cat == 2
                  else tr_k.chroma_residual_planes)
    rcb, rcr = chroma_res(
        inp["chroma_dc"], inp["chroma_ac"], inp["qp"], inp["is_intra"], inp["ls4_c"],
        inp["qp_offsets"], mb_h, mb_w, bd=bd,
    )
    return ry, rcb, rcr


def _base_planes(inp: dict, mb_h: int, mb_w: int, has_l8: bool, has_pcm: bool,
                 need_s2: bool = True, cat: int = 1, bd: int = 8):
    """Residual transforms + motion compensation (weighted, both lists
    masked) + PCM placement: every data-parallel pixel stage. Returns
    (base_y, base_cb, base_cr, ry, rcb, rcr) int32, where the base planes
    hold the inter + PCM content (zeros at intra MBs) and r* the residuals.
    cat: ChromaArrayType (2 = 4:2:2 with full-height chroma; 1 also for
    monochrome); bd: the bit depth of luma and chroma."""
    H, W = mb_h * 16, mb_w * 16
    ch_h = 16 if cat == 2 else 8
    Hc, Wc = mb_h * ch_h, mb_w * 8
    dev = inp["qp"].device
    mx = (1 << bd) - 1
    ry, rcb, rcr = _residual_planes(inp, mb_h, mb_w, has_l8, cat, bd)
    # both lists always evaluated, masked where unused
    slot, mv = inp["slot_cells"], inp["mv_cells"]
    use0_cell = slot[0] >= 0  # [H4, W4]
    use1_cell = slot[1] >= 0
    bi_cell = use0_cell & use1_cell
    luma_w, chroma_w = _weight_cells(inp, mb_h, mb_w)
    ring_y, ring_c = inp["ref_luma"], inp["ref_chroma"]
    p0y = mc_k.luma_mc(ring_y, slot[0], mv[0], H, W, need_s2)
    p1y = mc_k.luma_mc(ring_y, slot[1], mv[1], H, W, need_s2)
    w0, o0, w1, o1, lwd = (_rep(a, 4, 4) for a in luma_w(bi_cell))
    pred_y = mc_k.weighted_combine(p0y, p1y, _rep(use0_cell, 4, 4), _rep(use1_cell, 4, 4),
                                   w0, o0, w1, o1, lwd, mx)
    inter_y = torch.clamp(pred_y + ry, 0, mx)
    rv = ch_h // 4  # chroma rows per luma cell row
    use0c, use1c = _rep(use0_cell, rv, 2), _rep(use1_cell, rv, 2)
    p0cb, p0cr = mc_k.chroma_mc_pair(ring_c, slot[0], mv[0], Hc, Wc, cat)
    p1cb, p1cr = mc_k.chroma_mc_pair(ring_c, slot[1], mv[1], Hc, Wc, cat)
    inter_c = []
    for comp, (p0, p1, rc) in enumerate(((p0cb, p1cb, rcb), (p0cr, p1cr, rcr))):
        cw0, co0, cw1, co1, clwd = (_rep(a, rv, 2) for a in chroma_w(comp, bi_cell))
        pred = mc_k.weighted_combine(p0, p1, use0c, use1c, cw0, co0, cw1, co1, clwd, mx)
        inter_c.append(torch.clamp(pred + rc, 0, mx))

    # base planes: inter pixels + PCM pixels, zeros where intra fills
    inter_mb = (~inp["is_intra"]).reshape(mb_h, mb_w)
    im_y = _rep(inter_mb, 16, 16)
    im_c = _rep(inter_mb, ch_h, 8)
    zero = torch.zeros((), dtype=_I32, device=dev)
    pcm = [inp[k] if has_pcm else zero for k in ("pcm_y", "pcm_cb", "pcm_cr")]
    base_y = torch.where(im_y, inter_y, pcm[0])
    base_cb = torch.where(im_c, inter_c[0], pcm[1])
    base_cr = torch.where(im_c, inter_c[1], pcm[2])
    return base_y, base_cb, base_cr, ry, rcb, rcr


def _frame_core(inp: dict, mb_h: int, mb_w: int, has_l8: bool, has_pcm: bool,
                has_intra: bool = True, need_s2: bool = True, cat: int = 1, bd: int = 8):
    """The pixel path for one frame before deblocking: (y, cb, cr) in the
    sample dtype (uint8 at 8 bits, int16 above). has_intra=False (typical
    P/B frames code no intra MB) skips the serial intra kernels entirely."""
    base_y, base_cb, base_cr, ry, rcb, rcr = _base_planes(
        inp, mb_h, mb_w, has_l8, has_pcm, need_s2, cat, bd
    )
    mx = (1 << bd) - 1
    if has_intra:
        base_y, base_cb, base_cr = intra_frame(
            base_y, base_cb, base_cr, ry, rcb, rcr, inp["kind"], inp["modes4"],
            inp["i16mode"], inp["cmode"], inp["avl"], inp["avt"], inp["avtr"],
            inp["avtl"], mb_h, mb_w, 16 if cat == 2 else 8, 1 << (bd - 1), mx,
        )
    sdt = sample_dtype(mx)
    return base_y.to(sdt), base_cb.to(sdt), base_cr.to(sdt)


def _deblock_prep(inp: dict, mb_h: int, mb_w: int, cat: int = 1) -> dict:
    """Edge parameters of the frame: bS (picture identity is the ring slot:
    equal slot == same reference picture) and the thresholds, luma's from
    the raw QPY and chroma's from QPc with the PPS's offsets."""
    n = mb_h * mb_w
    return deblock_prep_device(
        inp["mb_cls"], inp["qp"], inp["is_t8"], inp["slice_arr"], inp["disable"],
        inp["aoff"], inp["boff"], inp["nnz_grid"],
        torch.zeros((n, 2, 4), dtype=_I32, device=inp["qp"].device),
        inp["mv_cells"], inp["qp_offsets"], mb_h, mb_w, slot_cells=inp["slot_cells"],
        chroma_all_h_edges=cat == 2,
    )


def _deblock_core(planes, inp: dict, mb_h: int, mb_w: int, cat: int = 1, bd: int = 8):
    """Edge-parameter derivation + the deblocking kernels; alpha, beta and
    tC0 scale by bd_scale."""
    y, cb, cr = planes
    return deblock_frame(y, cb, cr, _deblock_prep(inp, mb_h, mb_w, cat), mb_h, mb_w,
                         16 if cat == 2 else 8, 1 << (bd - 8), (1 << bd) - 1)


def _comp_qp_grids(inp: dict):
    """Per-MB QPc of Cb and Cr (Table 8-15 with the PPS's offsets, 8 bits),
    what the 4:4:4 luma-process chain dequantizes and deblocks them with."""
    cb_off, cr_off = inp["qp_offsets"]
    return tr_k.chroma_qp(inp["qp"], cb_off), tr_k.chroma_qp(inp["qp"], cr_off)


def _residual_planes_444(inp: dict, mb_h: int, mb_w: int, has_l8: bool) -> torch.Tensor:
    """The 8-bit ChromaArrayType 3 residual transforms: Y, Cb and Cr each
    through the luma process with its own QP'c and scaling lists. Returns
    int32 [3, H, W]."""
    n = mb_h * mb_w
    dev = inp["qp"].device
    qp_cb, qp_cr = _comp_qp_grids(inp)
    zero8 = torch.zeros((n, 4, 64), dtype=_I32, device=dev)
    c8 = inp["c444_8x8"] if has_l8 else torch.zeros((n, 2, 4, 64), dtype=_I32, device=dev)

    def residual(ac, dc, ac8, qp, ls4, ls8):
        return tr_k.luma_residual_plane(ac, dc, ac8, qp, inp["is_i16"], inp["is_t8"],
                                        inp["is_intra"], ls4, ls8, mb_h, mb_w)

    return torch.stack([
        residual(inp["luma_ac"], inp["luma_dc"], inp["luma8_ac"] if has_l8 else zero8,
                 inp["qp"], inp["ls4_y"], inp["ls8_y"]),
        residual(inp["c444_ac"][:, 0], inp["c444_dc"][:, 0], c8[:, 0], qp_cb,
                 inp["ls4_cb"], inp["ls8_cb"]),
        residual(inp["c444_ac"][:, 1], inp["c444_dc"][:, 1], c8[:, 1], qp_cr,
                 inp["ls4_cr"], inp["ls8_cr"]),
    ])


def _frame_core_444(inp: dict, mb_h: int, mb_w: int, has_l8: bool, has_pcm: bool,
                    has_intra: bool = True, need_s2: bool = True) -> torch.Tensor:
    """The 8-bit ChromaArrayType 3 pixel path before deblocking (spec
    7.3.5.3.1, 8.3.4.5, 8.4.2.2): Cb and Cr run the luma processes, each
    with its own QPc and scaling lists, luma quarter-pel MC from its own
    half-pel stacks with the chroma weights, and luma intra (one launch over
    the three planes). Returns uint8 [3, H, W] (Y, Cb, Cr)."""
    H, W = mb_h * 16, mb_w * 16
    dev = inp["qp"].device
    resid = _residual_planes_444(inp, mb_h, mb_w, has_l8)
    slot, mv = inp["slot_cells"], inp["mv_cells"]
    use0_cell = slot[0] >= 0
    use1_cell = slot[1] >= 0
    bi_cell = use0_cell & use1_cell
    luma_w, chroma_w = _weight_cells(inp, mb_h, mb_w)
    u0, u1 = _rep(use0_cell, 4, 4), _rep(use1_cell, 4, 4)
    # the chroma ring [R, 2, 4, Hp, Wp] viewed as 2R half-pel stacks: Cb of
    # slot s at 2s, Cr at 2s + 1 (a view; the MC gathers read it flat)
    ring_y, ring_c = inp["ref_luma"], inp["ref_chroma"]
    ring_cs = ring_c.reshape(-1, *ring_c.shape[2:])
    inter = []
    for comp in range(3):
        if comp == 0:
            ring, s0, s1, wts = ring_y, slot[0], slot[1], luma_w(bi_cell)
        else:  # an unused slot (-1) maps below 0: luma_mc clamps it, the masks drop it
            ring, wts = ring_cs, chroma_w(comp - 1, bi_cell)
            s0, s1 = 2 * slot[0] + comp - 1, 2 * slot[1] + comp - 1
        p0 = mc_k.luma_mc(ring, s0, mv[0], H, W, need_s2)
        p1 = mc_k.luma_mc(ring, s1, mv[1], H, W, need_s2)
        w0, o0, w1, o1, lwd = (_rep(a, 4, 4) for a in wts)
        pred = mc_k.weighted_combine(p0, p1, u0, u1, w0, o0, w1, o1, lwd)
        inter.append(torch.clamp(pred + resid[comp], 0, 255))
    im = _rep((~inp["is_intra"]).reshape(mb_h, mb_w), 16, 16)
    zero = torch.zeros((), dtype=_I32, device=dev)
    bases = torch.stack([torch.where(im, pl, inp[k] if has_pcm else zero)
                         for pl, k in zip(inter, ("pcm_y", "pcm_cb", "pcm_cr"))])
    if has_intra:
        bases = intra_planes(bases, resid, inp["kind"], inp["modes4"], inp["i16mode"],
                             inp["avl"], inp["avt"], inp["avtr"], inp["avtl"], mb_h, mb_w)
    return bases.to(torch.uint8)


def _deblock_core_444(planes: torch.Tensor, inp: dict, mb_h: int, mb_w: int) -> torch.Tensor:
    """ChromaArrayType 3 deblocking (chromaStyleFilteringFlag = 0): the luma
    filter on Y, Cb and Cr in one launch, with the bS of luma's coded
    status and motion on all three (as the JAX package derives it, from
    the luma nnz alone) and each plane's thresholds from its own QP."""
    prep = _deblock_prep(inp, mb_h, mb_w)
    return deblock_planes(planes, prep_444(prep), mb_h, mb_w)


def _densify_residuals(inp: dict, n: int, has_l8: bool):
    """Inverse of the host's sparse residual packing: scatter the coded
    blocks' levels into dense coefficient tensors (padded entries carry
    index 0 with all-zero levels, so the add is exact)."""
    dev = inp["qp"].device

    def dense(key, rows, width, shape):
        out = torch.zeros((rows, width), dtype=_I32, device=dev)
        out.index_add_(0, inp.pop(key + "_idx").long(), inp.pop(key + "_lev"))
        return out.reshape(shape)

    inp["luma_ac"] = dense("l", n * 16, 16, (n, 16, 16))
    inp["chroma_ac"] = dense("c", n * 8, 16, (n, 2, 4, 16))
    inp["luma_dc"] = dense("ld", n, 16, (n, 16))
    if has_l8:
        inp["luma8_ac"] = dense("l8", n * 4, 64, (n, 4, 64))


def _prepare_inp(wire: dict, dyn: dict, ring_y, ring_c, mb_h: int, mb_w: int,
                 flags: tuple) -> dict:
    """Expand the narrow wire into the _frame_core input contract: every
    array widened to int32 before any arithmetic, bit-packed flags ->
    booleans, nibble-packed intra modes, sparse residual densify, 8x8-cell
    motion expansion, ring binding."""
    has_l8, has_pcm, apply_db, sparse = flags[:4]
    inp = dict(dyn)
    for k, v in wire.items():
        if k != "slot_idx":
            inp[k] = v.to(_I32)
    f8 = inp.pop("flags8")
    m4n = inp.pop("modes4n")
    inp["modes4"] = torch.stack([m4n & 0x0F, m4n >> 4], -1).reshape(-1, 16) - 1
    if "slice_arr" not in inp:
        inp["slice_arr"] = inp["slice_mb"]
    for bit, name in enumerate(("is_i16", "is_t8", "is_intra", "avl", "avt", "avtr",
                                "avtl")):
        inp[name] = (f8 & (1 << bit)) != 0
    if "nnz_bits" in inp:
        nb = inp.pop("nnz_bits")
        shifts = torch.arange(7, -1, -1, dtype=_I32, device=nb.device)
        bits = (nb[:, None] >> shifts) & 1
        inp["nnz_grid"] = bits.reshape(-1)[: mb_h * 4 * mb_w * 4].reshape(mb_h * 4, mb_w * 4)
    if sparse:
        _densify_residuals(inp, mb_h * mb_w, has_l8)

    def rep2(a):  # [2, H8, W8, ...] -> [2, H4, W4, ...]
        return a.repeat_interleave(2, 1).repeat_interleave(2, 2)

    if "mv8_cells" in inp:
        inp["mv_cells"] = rep2(inp.pop("mv8_cells"))
    inp["slot_cells"] = rep2(inp.pop("slot_cells8"))
    if "ridx_cells8" in inp:
        inp["ridx_cells"] = rep2(inp.pop("ridx_cells8"))
    inp["ref_luma"] = ring_y
    inp["ref_chroma"] = ring_c
    return inp


def _put(ring: torch.Tensor, slot, value: torch.Tensor) -> None:
    """ring[slot] = value. slot is an int or a 0-d int64 tensor on the
    ring's device: the slot as data, as the JAX frame_step reads
    wire["slot_idx"]. Indexing with a tensor would turn it into a Python
    int (a host synchronisation, which a CUDA graph cannot capture);
    index_copy_ reads it on the device."""
    if isinstance(slot, int):
        ring[slot] = value
    else:
        ring.index_copy_(0, slot.view(1), value.unsqueeze(0))


def frame_step(wire: dict, ring_y: torch.Tensor, ring_c: torch.Tensor, dyn: dict,
               mb_h: int, mb_w: int, flags: tuple, slot) -> torch.Tensor:
    """The whole per-frame device program: reconstruct -> deblock ->
    half-pel planes into ring slot `slot` (in place) -> packed output.

    flags = (has_l8, has_pcm, apply_deblock, sparse, has_intra, need_s2,
    cat, bd): cat is the ChromaArrayType the frame runs as (1, 2 for 4:2:2,
    or 3 for 8-bit 4:4:4), bd the bit depth. ring_y: [R, 4, H+2*PAD,
    W+2*PAD] {G, b, h, j} stacks; ring_c: [R, 2, Hc+2*PAD, Wc+2*PAD] padded
    Cb/Cr (Hc = H/2, or H for 4:2:2), or for 4:4:4 [R, 2, 4, H+2*PAD,
    W+2*PAD] Cb and Cr half-pel stacks, both in the sample dtype (uint8 at 8
    bits, int16 above). slot: an int, or a 0-d int64 tensor on the rings'
    device (what the frame programs of pipeline/frame_program.py pass, so
    that one captured program serves every slot); wire["slot_idx"], which a
    wire converted from the JAX package carries, is not read. Returns the
    packed [H + Hc, W] plane ([3H, W] for 4:4:4) in the sample dtype."""
    has_l8, has_pcm, apply_db, sparse, has_intra, need_s2, cat, bd = flags
    inp = _prepare_inp(wire, dyn, ring_y, ring_c, mb_h, mb_w, flags)
    if cat == 3:
        planes = _frame_core_444(inp, mb_h, mb_w, has_l8, has_pcm, has_intra, need_s2)
        if apply_db:
            planes = _deblock_core_444(planes, inp, mb_h, mb_w)
        _put(ring_y, slot, mc_k.half_pel_planes(planes[0]))
        _put(ring_c[:, 0], slot, mc_k.half_pel_planes(planes[1]))
        _put(ring_c[:, 1], slot, mc_k.half_pel_planes(planes[2]))
        return planes.reshape(3 * mb_h * 16, mb_w * 16)
    y, cb, cr = _frame_core(inp, mb_h, mb_w, has_l8, has_pcm, has_intra, need_s2, cat, bd)
    if apply_db:
        y, cb, cr = _deblock_core((y, cb, cr), inp, mb_h, mb_w, cat, bd)
    _put(ring_y, slot, mc_k.half_pel_planes(y, (1 << bd) - 1))
    _put(ring_c[:, 0], slot, mc_k.chroma_pad(cb))
    _put(ring_c[:, 1], slot, mc_k.chroma_pad(cr))
    return torch.cat([y, torch.cat([cb, cr], dim=1)], dim=0)


class _PackedFrame:
    """One decoded frame as a single packed buffer [H + Hc, W] (Y on top;
    Cb | Cr side by side below; Hc = H/2, or H for 4:2:2), or [3H, W] for
    4:4:4 (Y, Cb, Cr full-size, stacked). On the GPU the
    device->host copy into pinned memory is enqueued at dispatch behind
    `done` (frame computed) and ends at `copied`; every read waits for
    `copied` first. int16 samples (above 8 bits) come out as uint16 planes."""

    def __init__(self, host: torch.Tensor, H: int, W: int,
                 metrics: DecodeMetrics | None, done=None, copied=None):
        self._host = host
        self._H = H
        self._W = W
        self._done = done
        self._copied = copied
        self._planes = None
        self._metrics = metrics

    def _wait(self, event, stage: str):
        if event is None:
            return
        with timer(self._metrics, stage):
            event.synchronize()

    def block_until_ready(self):
        """Wait for the frame to be COMPUTED on the device (not copied),
        timed as the `device` stage."""
        self._wait(self._done, "device")
        return self

    def fetch(self):
        if self._planes is None:
            self._wait(self._copied, "download")
            a = self._host.numpy()
            if a.dtype == np.int16:
                a = a.view(np.uint16)
            if self._metrics is not None:
                self._metrics.count("bytes_down", a.nbytes)
            H, W = self._H, self._W
            if a.shape[0] == 3 * H:  # 4:4:4
                self._planes = (a[:H], a[H : 2 * H], a[2 * H :])
            else:
                self._planes = (a[:H], a[H:, : W // 2], a[H:, W // 2 :])
            self._host = None
        return self._planes


class _PlaneView:
    """numpy-coercible view of one plane of a _PackedFrame."""

    def __init__(self, frame: _PackedFrame, idx: int):
        self._frame = frame
        self._idx = idx

    def __array__(self, dtype=None, copy=None):
        a = self._frame.fetch()[self._idx]
        if dtype is not None and a.dtype != dtype:
            a = a.astype(dtype)
        return a

    def block_until_ready(self):
        self._frame.block_until_ready()
        return self


class _FuturePlane:
    """numpy-coercible plane backed by a pending reconstruction task (the
    pipelined GpuDecoder reconstructs picture N on a worker thread while
    the main thread entropy-decodes picture N+1). The wait for the task is
    timed as `plane_wait` on the reading thread."""

    def __init__(self, fut: Future, idx: int, metrics: DecodeMetrics | None = None):
        self._fut = fut
        self._idx = idx
        self._metrics = metrics

    def _resolve(self):
        with timer(self._metrics, "plane_wait"):
            planes = self._fut.result()
        return planes[self._idx]

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self._resolve())
        if dtype is not None and a.dtype != dtype:
            a = a.astype(dtype)
        return a

    def block_until_ready(self):
        p = self._resolve()
        block = getattr(p, "block_until_ready", None)
        if block is not None:
            block()


# raster-cell -> luma4x4BlkIdx reorder (inverse of LUMA_BLK_XY)
_RASTER_TO_BLK4 = np.array([y * 4 + x for (x, y) in LUMA_BLK_XY], np.int32)


def _coded_block_masks(ft: FrameTensors, has_l8: bool):
    """Coded-block booleans for the sparse residual wire, from the nnz
    bookkeeping grids of the entropy stage. transform-8x8 and PCM MBs set
    luma nnz without populating luma_ac, so they are masked out of the 4x4
    list. Returns key -> bool mask over the flattened block rows."""
    mb_h, mb_w, n = ft.mb_h, ft.mb_w, ft.n_mbs
    pcm = ft.mb_class == MB_I_PCM
    nnz_raster = (
        ft.luma_nnz.reshape(mb_h, 4, mb_w, 4).transpose(0, 2, 1, 3).reshape(n, 16)
    )
    nnz_blk = nnz_raster[:, _RASTER_TO_BLK4]
    skip_mb = ft.transform_8x8 | pcm
    out = {
        "l": ((nnz_blk > 0) & ~skip_mb[:, None]).reshape(-1),
        # chroma 4x4 blk order is raster within the 8x8 (CHROMA_BLK_XY)
        "c": (
            (
                ft.chroma_nnz.reshape(2, mb_h, 2, mb_w, 2)
                .transpose(1, 3, 0, 2, 4)
                .reshape(n, 8)
                > 0
            )
            & ~pcm[:, None]
        ).reshape(-1),
        # luma DC: cbf_dc is CABAC-only bookkeeping, so scan the levels
        "ld": ft.luma_dc.any(axis=1),
    }
    if has_l8:
        nnz8 = (
            ft.luma_nnz.reshape(mb_h, 2, 2, mb_w, 2, 2)
            .transpose(0, 3, 1, 4, 2, 5)
            .reshape(n, 4, 4)
            .max(axis=2)
        )
        out["l8"] = ((nnz8 > 0) & (ft.transform_8x8 & ~pcm)[:, None]).reshape(-1)
    return out


def _mb_avail_grids(ft: FrameTensors, pps: PPS):
    """MB-level intra availability (left/top/topright/topleft) incl. slice
    gating and constrained_intra_pred."""
    mb_h, mb_w = ft.mb_h, ft.mb_w
    sl = ft.slice_id.reshape(mb_h, mb_w)
    usable = np.ones((mb_h, mb_w), bool)
    if pps.constrained_intra_pred_flag:
        usable = (ft.mb_class < 3).reshape(mb_h, mb_w)

    def nb(dy, dx):
        ok = np.zeros((mb_h, mb_w), bool)
        ys, xs = slice(max(0, dy), mb_h + min(0, dy)), slice(
            max(0, dx), mb_w + min(0, dx)
        )
        ys2, xs2 = slice(max(0, -dy), mb_h + min(0, -dy)), slice(
            max(0, -dx), mb_w + min(0, -dx)
        )
        ok[ys2, xs2] = (sl[ys, xs] == sl[ys2, xs2]) & usable[ys, xs]
        return ok

    return nb(0, -1), nb(-1, 0), nb(-1, 1), nb(-1, -1)


def _weight_tables(weight_ctx, ref_lists, poc, s_pad: int, r_w: int, osh: int = 0):
    """Per-slice weighted-prediction tables for the device-side gather.

    Identity default everywhere: w=32, o=0, logWD=5, exact for unweighted
    uni (p*32+16)>>5 = p and default bi (32p0+32p1+32)>>6 = (p0+p1+1)>>1.
    Explicit slices (7.3.3.2) fill per-(list, ref_idx) entries, their
    offsets scaled by 1 << osh (osh = BitDepth - 8, spec 8.4.2.3.2);
    implicit slices (8.4.2.3.1) fill the pair-indexed bi tables from POC
    distances. Only called for frames with at least one weighted slice."""
    S, R = s_pad, r_w
    w_tab = np.full((S, 2, R), 32, np.int16)
    o_tab = np.zeros((S, 2, R), np.int16)
    wc_tab = np.full((S, 2, R, 2), 32, np.int16)
    oc_tab = np.zeros((S, 2, R, 2), np.int16)
    lwd_tab = np.full((S, 2), 5, np.int8)
    pw0 = np.full((S, R, R), 32, np.int16)
    pw1 = np.full((S, R, R), 32, np.int16)
    pwc0 = np.full((S, R, R, 2), 32, np.int16)
    pwc1 = np.full((S, R, R, 2), 32, np.int16)
    for sid, (wmode, pwt) in enumerate(weight_ctx):
        if sid >= S or wmode == "none":
            continue
        if wmode == "explicit" and pwt is not None:
            lwd_tab[sid] = (pwt.luma_log2_weight_denom, pwt.chroma_log2_weight_denom)
            w_tab[sid] = 1 << int(pwt.luma_log2_weight_denom)
            wc_tab[sid] = 1 << int(pwt.chroma_log2_weight_denom)
            for lst, tab in ((0, pwt.l0), (1, pwt.l1)):
                for ridx, e in enumerate(tab or []):
                    if ridx >= R:
                        break
                    w_tab[sid, lst, ridx] = e.luma_weight
                    o_tab[sid, lst, ridx] = e.luma_offset << osh
                    wc_tab[sid, lst, ridx] = e.chroma_weight
                    oc_tab[sid, lst, ridx] = np.asarray(e.chroma_offset, np.int32) << osh
            # explicit bi weights are separable per (list, ref_idx)
            pw0[sid] = w_tab[sid, 0, :, None]
            pw1[sid] = w_tab[sid, 1, None, :]
            pwc0[sid] = wc_tab[sid, 0, :, None, :]
            pwc1[sid] = wc_tab[sid, 1, None, :, :]
        elif wmode == "implicit":
            l0, l1 = ref_lists[sid]
            for a, p0 in enumerate(l0[:R]):
                for b, p1 in enumerate(l1[:R]):
                    _, w1v = _implicit_w(p0, p1, poc)
                    pw0[sid, a, b] = 64 - w1v
                    pw1[sid, a, b] = w1v
                    pwc0[sid, a, b] = 64 - w1v
                    pwc1[sid, a, b] = w1v
            # implicit uni-prediction is the default combine: uni tables
            # stay identity; offsets stay 0, logWD stays 5
    return {
        "w_tab": w_tab, "o_tab": o_tab, "wc_tab": wc_tab, "oc_tab": oc_tab,
        "lwd_tab": lwd_tab, "pw0": pw0, "pw1": pw1, "pwc0": pwc0, "pwc1": pwc1,
    }


def _implicit_w(p0: Picture, p1: Picture, cur_poc: int) -> tuple[int, int]:
    """8.4.2.3.1 implicit weights (host-side, mirrors the oracle)."""
    if p1.poc == p0.poc or p0.long_term or p1.long_term:
        return 32, 32
    tb = min(127, max(-128, cur_poc - p0.poc))
    td = min(127, max(-128, p1.poc - p0.poc))
    if td > 0:
        tx = (16384 + abs(td) // 2) // td
    else:
        tx = -((16384 + abs(td) // 2) // -td)
    dsf = min(1023, max(-1024, (tb * tx + 32) >> 6))
    w1 = dsf >> 2
    if w1 < -64 or w1 > 128:
        return 32, 32
    return 64 - w1, w1


class GpuDecoder(Decoder):
    """Stream decoder whose pixel pipeline runs as one frame program per
    picture on a CUDA device, with device-resident DPB reference planes
    and asynchronous packed-plane output. The programs and the rings come
    from the process-wide cache of pipeline/frame_program.py, checked out
    per ring geometry and returned at close().

    device: "cuda" (default; raises when no CUDA device exists) or "cpu",
    where the kernel wrappers run their plain torch versions. Pictures are
    reconstructed on one worker thread, RECON_DEPTH in flight; under the
    strict error policy, the entropy decodes of pictures on the native
    engine run on worker threads too, up to RECON_DEPTH + 1 at once. Call close()
    (or use `with`) to stop the worker threads; a closed decoder decodes no
    more. The luma intra and deblock kernels trap when a hand-off between
    MB rows stalls for seconds (csrc/wavefront.cuh); a trap is a sticky
    CUDA error that leaves the process's CUDA context unusable, so this
    decoder and every other CUDA user of the process fail from then on."""

    def __init__(self, apply_deblock: bool = True, device="cuda",
                 metrics: DecodeMetrics | None = None):
        super().__init__(apply_deblock=apply_deblock, metrics=metrics)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "GpuDecoder: no CUDA device is available; pass device='cpu' to "
                    "run the plain torch versions on the CPU"
                )
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        self._rings: frame_program.RingSet | None = None  # checked out
        self._ring_slots: dict[int, int] = {}  # pic uid -> ring slot
        self._keys: set = set()  # the signatures of the frames decoded
        self._r_w = R_W_DEFAULT
        self._ls_key = None
        self._ls_dev = None
        # the pipeline: the main thread parses and sets pictures up, in
        # decode order; each picture on the native engine then decodes its
        # entropy as a task on _picture_exec (its slices' engine calls on
        # the per-slice pool), several pictures at once, a B picture's
        # task waiting for its colocated picture's; this single worker
        # runs host prep + device dispatch for each picture in decode
        # order once its task is done. Ring state, _ring_slots and _r_w are
        # touched ONLY by the worker, in submission order.
        self._recon_exec = ThreadPoolExecutor(max_workers=1,
                                              thread_name_prefix="h264recon")
        self._recon_pending: deque[Future] = deque()
        # pictures in their entropy decode: at most RECON_DEPTH waiting for
        # the worker and the one just set up (_submit_reconstruct's
        # back-pressure), so none queues. A task waits only for tasks
        # submitted before it, which a FIFO pool has started: the earliest
        # unfinished task waits for nothing unfinished, so the pool cannot
        # deadlock, however few threads it had.
        self._picture_exec = ThreadPoolExecutor(max_workers=RECON_DEPTH + 1,
                                                thread_name_prefix="h264pic")

    def close(self):
        """Finish pending work, stop the recon worker and the picture and
        per-slice entropy executors, and return the rings and their programs to the
        cache."""
        try:
            self._drain_recon()
        finally:
            if self._recon_exec is not None:
                self._recon_exec.shutdown(wait=True)
                self._recon_exec = None
            if self._picture_exec is not None:
                self._picture_exec.shutdown(wait=True)
                self._picture_exec = None
            ex = getattr(self, "_slice_exec", None)
            if ex is not None:
                ex.shutdown(wait=True)
                self._slice_exec = None
            if self._rings is not None:
                frame_program.checkin(self._rings)
                self._rings = None

    @property
    def _ring(self):
        """(luma half-pel ring, chroma ring), or None before the first
        picture that the frame program decodes."""
        return None if self._rings is None else (self._rings.ring_y, self._rings.ring_c)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def _oracle_format(sps: SPS) -> bool:
        """Formats the frame program does not run, which decode on the host
        oracle as in the JAX package: mixed luma/chroma bit depths and
        high-bit-depth 4:4:4."""
        return (sps.bit_depth_chroma != sps.bit_depth_luma
                or (sps.chroma_array_type == 3 and sps.bit_depth_luma > 8))

    def _submit_entropy(self, task, native: bool) -> None:
        # a picture on the Python engine holds the interpreter lock, and a
        # lenient error policy drops a failed picture before its marking:
        # both decode here, on the main thread (depth 1); the task of a
        # Python-engine picture first waits for its colocated pictures'
        if not native or self.error_policy != "strict":
            task()
            return
        if self._picture_exec is None:
            raise RuntimeError("GpuDecoder: decoding after close()")
        self._picture_exec.submit(task)

    def _submit_reconstruct(self, ft, sps, pps, slices, ref_lists, weight_ctx, poc,
                            decoded):
        # from here the recon worker owns ft and the picture's other host
        # buffers (Decoder._finish_picture reads none of them after this
        # call): _recon_task waits for the picture's entropy task
        # (`decoded`), then returns them to self._frames once _reconstruct
        # has built and staged the wire (or the oracle has run), clearing
        # them there, and the main thread takes only clean sets
        if self._recon_exec is None:
            raise RuntimeError("GpuDecoder: decoding after close()")
        cur_uid = self.uid_counter  # snapshot: main increments it right after
        with timer(self.metrics, "recon_wait"):
            while len(self._recon_pending) >= RECON_DEPTH:
                self._recon_pending.popleft().result()  # backpressure + errors
        fut = self._recon_exec.submit(
            self._recon_task, decoded, ft, sps, pps, slices, ref_lists, weight_ctx, poc,
            cur_uid
        )
        self._recon_pending.append(fut)
        return tuple(_FuturePlane(fut, i, self.metrics) for i in range(3))

    def _recon_task(self, decoded, ft, sps, pps, slices, ref_lists, weight_ctx, poc,
                    cur_uid):
        # a failed entropy decode raises here, and its buffers stay out of
        # the pool (a slice call of the picture may still write them); a
        # later picture that predicts from it raises in turn, when its
        # reference planes are uploaded
        decoded.result()
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx, timer(self.metrics, "prep"):
            try:
                return self._reconstruct(ft, sps, pps, slices, ref_lists, weight_ctx, poc,
                                         cur_uid=cur_uid)
            finally:
                self._frames.give(ft)

    def _drain_recon(self):
        while self._recon_pending:
            self._recon_pending.popleft().result()

    @staticmethod
    def _ring_geom_of(sps: SPS):
        """(luma ring shape, chroma ring shape, sample dtype) of the DPB
        rings, max_num_ref_frames + 1 slots each: {G, b, h, j} luma stacks
        [R, 4, H+2P, W+2P], and padded Cb/Cr planes [R, 2, Hc+2P, W/2+2P]
        (Hc = H/2, or H for 4:2:2) or, for 4:4:4, Cb and Cr half-pel stacks
        [R, 2, 4, H+2P, W+2P] (JAX: tpu_pipeline.py:1109-1116)."""
        n_refs = max(1, sps.max_num_ref_frames + 1)
        H, W = sps.frame_height_in_mbs * 16, sps.pic_width_in_mbs * 16
        P = mc_k.PAD
        luma = (n_refs, 4, H + 2 * P, W + 2 * P)
        if sps.chroma_array_type == 3:
            chroma = (n_refs, 2, *luma[1:])
        else:
            Hc = H if sps.chroma_array_type == 2 else H // 2
            chroma = (n_refs, 2, Hc + 2 * P, W // 2 + 2 * P)
        return luma, chroma, sample_dtype((1 << sps.bit_depth_luma) - 1)

    @staticmethod
    def ring_bytes(sps: SPS) -> int:
        """Device bytes of the DPB rings this decoder allocates for the
        stream geometry (_ensure_ring, shapes from _ring_geom_of; samples
        above 8 bits take 2 bytes)."""
        luma, chroma, dt = GpuDecoder._ring_geom_of(sps)
        return (int(np.prod(luma)) + int(np.prod(chroma))) * (1 if dt == torch.uint8 else 2)

    def _ring_over_budget(self, sps: SPS) -> bool:
        """True when the DPB rings would exceed RING_BUDGET_MB on a CPU
        device: the picture then decodes on the host oracle. On a CUDA device
        no picture leaves the card: rings larger than the card's memory
        raise MemoryError, and smaller ones are allocated."""
        need = self.ring_bytes(sps)
        if self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
            if need > total:
                raise MemoryError(
                    f"GpuDecoder: the DPB rings of this stream need {need >> 20} MB, "
                    f"more than the {total >> 20} MB of {self.device}"
                )
            return False
        over = need > RING_BUDGET_MB << 20
        if over and not getattr(self, "_budget_warned", False):
            self._budget_warned = True
            print(
                f"h264decode_tpu_torch: DPB ring would take {need >> 20} MB "
                f"(> {RING_BUDGET_MB} MB); decoding on the host oracle",
                file=sys.stderr,
            )
        return over

    def _ensure_ring(self, sps: SPS) -> int:
        """Check out the rings (and programs) of the stream's geometry; a
        new geometry returns the set in use to the cache first."""
        geom = self._ring_geom_of(sps)
        if self._rings is None or self._rings.geom != geom:
            if self._rings is not None:
                frame_program.checkin(self._rings)
            self._rings = frame_program.checkout(self.device, geom)
            self._ring_slots = {}
            self._ls_key = None  # the tables of a set are its own
        return geom[0][0]

    def _alloc_slot(self, live_uids: set, n_refs: int) -> int:
        """A free ring slot, evicting slots of no-longer-referenced uids."""
        for uid in [u for u in self._ring_slots if u not in live_uids]:
            del self._ring_slots[uid]
        used = set(self._ring_slots.values())
        return next(i for i in range(n_refs) if i not in used)

    def _insert_host_refs(self, pictures: list[Picture], n_refs: int, live: set,
                          mx: int):
        """Upload reference pictures that lack a ring slot (pictures decoded
        by the host oracle, e.g. lossless transform-bypass frames; uint16
        planes above 8 bits, held as int16 on the device; 4:4:4 Cb and Cr as
        half-pel stacks, JAX: tpu_pipeline.py:1154-1157)."""
        ring_y, ring_c = self._ring
        cf3 = ring_c.dim() == 5
        for p in pictures[:n_refs]:
            if p.uid in self._ring_slots:
                continue
            slot = self._alloc_slot(live, n_refs)

            def dev(a):
                a = np.ascontiguousarray(np.asarray(a))
                if a.dtype == np.uint16:
                    a = a.view(np.int16)
                return torch.as_tensor(a, device=self.device)

            ring_y[slot] = mc_k.half_pel_planes(dev(p.y), mx)
            for k, c in enumerate((p.cb, p.cr)):
                ring_c[slot, k] = mc_k.half_pel_planes(dev(c), mx) if cf3 else \
                    mc_k.chroma_pad(dev(c))
            self._ring_slots[p.uid] = slot

    def _dyn(self, sps, pps) -> dict:
        """Scaling-list tables (per-(SPS, PPS) constants, uploaded once per
        content into the checked-out RingSet); for 4:4:4 also the Cb and Cr
        luma-process lists, [intra, inter], with the JAX package's indices
        (tpu_pipeline.py:1458-1475)."""
        key = (id(sps), id(pps))
        if self._ls_key != key:
            s4 = pps.effective_scaling_4x4(sps)
            s8 = pps.effective_scaling_8x8(sps)
            l4, l8 = tr_k.level_scale_tables_4x4, tr_k.level_scale_tables_8x8
            tabs = {
                "ls4_y": np.stack([l4(s4[0]), l4(s4[3])]),
                "ls8_y": np.stack([l8(s8[0]), l8(s8[1])]),
                "ls4_c": np.stack([np.stack([l4(s4[1]), l4(s4[2])]),
                                   np.stack([l4(s4[4]), l4(s4[5])])]),
            }
            if sps.chroma_array_type == 3:
                tabs["ls4_cb"] = np.stack([l4(s4[1]), l4(s4[4])])
                tabs["ls4_cr"] = np.stack([l4(s4[2]), l4(s4[5])])
                tabs["ls8_cb"] = np.stack([l8(s8[2]), l8(s8[3])])
                tabs["ls8_cr"] = np.stack([l8(s8[4]), l8(s8[5])])
            self._ls_dev = self._rings.tables(tabs)
            self._ls_key = key
        dyn = dict(self._ls_dev)
        dyn["qp_offsets"] = (int(pps.chroma_qp_index_offset),
                             int(pps.second_chroma_qp_index_offset))
        return dyn

    def _reconstruct(self, ft, sps, pps, slices, ref_lists, weight_ctx, poc,
                     cur_uid: int | None = None):
        if cur_uid is None:
            cur_uid = self.uid_counter
        bd = sps.bit_depth_luma
        oracle_format = self._oracle_format(sps)
        over_budget = not oracle_format and self._ring_over_budget(sps)
        # QP'Y = 0 selects the transform bypass (QPY = -QpBdOffsetY above 8 bits)
        lossless = sps.qpprime_y_zero_transform_bypass_flag and bool(
            (ft.qp.astype(np.int32) + 6 * (bd - 8) == 0).any()
        )
        if (
            slices[0][0].field_pic_flag
            or slices[0][0].mbaff_frame_flag
            or any(h.is_sp or h.is_si for h, *_ in slices)
            or over_budget
            or lossless
            or oracle_format
        ):
            # PAFF field pictures, MBAFF pictures, SP/SI slices (8.6
            # transform-domain requant), lossless transform-bypass MBs
            # (8.5.15), mixed bit depths and high-bit-depth 4:4:4 run on the
            # numpy oracle. Reference pictures may hold lazy device planes:
            # materialize them once for the oracle.
            for l0, l1 in ref_lists:
                for p in l0 + l1:
                    if not isinstance(p.y, np.ndarray):
                        p.y = np.asarray(p.y)
                        p.cb = np.asarray(p.cb)
                        p.cr = np.asarray(p.cr)
            return super()._reconstruct(ft, sps, pps, slices, ref_lists, weight_ctx, poc)
        m = self.metrics
        mb_h, mb_w = ft.mb_h, ft.mb_w
        H, W = mb_h * 16, mb_w * 16
        n = ft.n_mbs
        hdr0 = slices[0][0]
        cf2 = sps.chroma_array_type == 2
        cf3 = sps.chroma_array_type == 3
        mx = (1 << bd) - 1
        n_refs = self._ensure_ring(sps)
        # ---- unique reference pictures -> ring slots
        uid_to_pic = {}
        for l0, l1 in ref_lists:
            for p in l0 + l1:
                uid_to_pic.setdefault(p.uid, p)
        pics = list(uid_to_pic.values())
        live = {p.uid for p in pics[:n_refs]}
        self._insert_host_refs(pics, n_refs, live, mx)
        uid_slot = {u: s for u, s in self._ring_slots.items() if u in live}
        # slot for the current frame's planes (a free slot always exists:
        # the ring has max_num_ref_frames + 1 slots)
        cur_slot = self._alloc_slot(live, n_refs)
        if hdr0.nal_ref_idc:
            self._ring_slots[cur_uid] = cur_slot

        # ---- per-part ref slots
        slot_lut = np.full(cur_uid + 2, -1, np.int32)
        for uid, s in uid_slot.items():
            slot_lut[uid] = s
        rp_parts = ft.ref_pic  # [n, 2, 4] picture uids (or -1/-2)
        slot_parts = np.where(
            rp_parts >= 0, slot_lut[np.clip(rp_parts, 0, len(slot_lut) - 1)], -1
        ).astype(np.int8)

        # ---- per-slice weight tables (left out of the wire for the common
        # fully-unweighted frame: the device uses identity constants)
        weighted = any(wmode != "none" for wmode, _ in weight_ctx)
        wt = {}
        if weighted:
            s_pad = 1 << max(0, len(slices) - 1).bit_length()
            max_list = max(
                [1] + [len(l0) for l0, _ in ref_lists] + [len(l1) for _, l1 in ref_lists]
            )
            while self._r_w < max_list:
                self._r_w *= 2
            wt = _weight_tables(weight_ctx, ref_lists, poc, s_pad, self._r_w, osh=bd - 8)

        # ---- intra metadata
        kind = np.zeros(n, np.int32)
        kind[(ft.mb_class == MB_I_NXN) & ~ft.transform_8x8] = K_I4
        kind[(ft.mb_class == MB_I_NXN) & ft.transform_8x8] = K_I8
        kind[ft.mb_class == MB_I_16X16] = K_I16
        avl, avt, avtr, avtl = _mb_avail_grids(ft, pps)

        # ---- PCM planes (only built and shipped when the frame has any):
        # uint16 above 8 bits, 8x16 chroma per MB for 4:2:2 and 16x16 for
        # 4:4:4, and mid-gray chroma for monochrome (which codes none)
        has_pcm = bool(ft.pcm_samples)
        if has_pcm:
            pdt = np.uint8 if bd == 8 else np.uint16
            chh = 16 if cf2 or cf3 else 8
            cw = 16 if cf3 else 8
            mono = sps.chroma_array_type == 0
            pcm_y = np.zeros((H, W), pdt)
            pcm_cb = np.zeros((mb_h * chh, mb_w * cw), pdt)
            pcm_cr = np.zeros((mb_h * chh, mb_w * cw), pdt)
            for addr, (py, pcb, pcr) in ft.pcm_samples.items():
                mbx, mby = ft.mb_xy(addr)
                pcm_y[mby * 16 : mby * 16 + 16, mbx * 16 : mbx * 16 + 16] = py
                cy, cx = slice(mby * chh, (mby + 1) * chh), slice(mbx * cw, (mbx + 1) * cw)
                pcm_cb[cy, cx] = 1 << (bd - 1) if mono else pcb
                pcm_cr[cy, cx] = 1 << (bd - 1) if mono else pcr

        # 4:4:4 may code 8x8 blocks in Cb/Cr alone (JAX: tpu_pipeline.py:1304-1307)
        has_l8 = bool(pps.transform_8x8_mode_flag and (
            ft.luma8_ac is not None or (cf3 and ft.c444_8x8 is not None)))
        if has_l8:
            ft.ensure_luma8()
        # ---- sparse residual wire: typical inter frames code ~1-5% of the
        # blocks, so ship (index, levels) of coded blocks only, up to fixed
        # capacities; an over-capacity frame (an I frame, typically) ships
        # the dense tensors
        sp = {
            "l": (ft.luma_ac.reshape(-1, 16), n),
            "c": (ft.chroma_ac.reshape(-1, 16), n // 2),
            "ld": (ft.luma_dc, n // 4),
        }
        if has_l8:
            sp["l8"] = (ft.luma8_ac.reshape(-1, 64), n // 4)
        # 4:2:2 and 4:4:4 ship their residuals dense, as in the JAX package
        sparse = not (cf2 or cf3)
        masks = _coded_block_masks(ft, has_l8) if sparse else {}
        sp_idx = {}
        for key, (flat, cap) in (sp.items() if sparse else ()):
            idx = np.flatnonzero(masks[key]).astype(np.int32)
            if len(idx) > cap:
                sparse = False
                break
            sp_idx[key] = idx
        # the rows the reset clears: a sparse frame's coded ones, and no
        # luma8_ac row for a picture without 8x8 transforms
        ft.coded = dict(sp_idx) if sparse else {}
        if not has_l8:
            ft.coded["l8"] = np.zeros(0, np.int64)
        wire: dict[str, np.ndarray] = {}

        def narrow(a):
            # levels overwhelmingly fit int8: ship the narrow dtype when the
            # whole tensor does (widened on the device before any arithmetic)
            if a.dtype == np.int16 and a.size and abs(int(a.max(initial=0))) < 128 \
                    and abs(int(a.min(initial=0))) < 128:
                return a.astype(np.int8)
            return a

        wire["chroma_dc"] = narrow(ft.chroma_dc)
        if sparse:
            for key, (flat, cap) in sp.items():
                idx = sp_idx[key]
                pad = cap - len(idx)
                wire[key + "_idx"] = np.pad(idx, (0, pad))
                wire[key + "_lev"] = narrow(np.pad(flat[idx], ((0, pad), (0, 0))))
        else:
            wire["luma_ac"] = narrow(ft.luma_ac)
            wire["chroma_ac"] = narrow(ft.chroma_ac)
            wire["luma_dc"] = narrow(ft.luma_dc)
            if has_l8:
                wire["luma8_ac"] = narrow(ft.luma8_ac)
        if cf3:  # Cb/Cr coded luma-style (JAX: tpu_pipeline.py:1355-1360)
            wire["c444_ac"] = narrow(ft.c444_ac)
            wire["c444_dc"] = narrow(ft.c444_dc)
            if has_l8:
                wire["c444_8x8"] = narrow(ft.ensure_c444_8x8())
        # MVs ship at 8x8 granularity when no MB uses sub-8x8 partitions,
        # in cell-grid order
        mv16 = ft.mv.reshape(n, 2, 2, 2, 2, 2, 2)
        mv8c = mv16[:, :, :, :1, :, :1, :]
        if bool((mv16 == mv8c).all()):
            wire["mv8_cells"] = np.ascontiguousarray(
                mv8c.reshape(mb_h, mb_w, 2, 2, 2, 2)
                .transpose(2, 0, 3, 1, 4, 5)
                .reshape(2, mb_h * 2, mb_w * 2, 2)
            ).astype(np.int16)
        else:
            wire["mv_cells"] = np.ascontiguousarray(
                ft.mv.reshape(mb_h, mb_w, 2, 4, 4, 2)
                .transpose(2, 0, 3, 1, 4, 5)
                .reshape(2, mb_h * 4, mb_w * 4, 2)
            ).astype(np.int16)
        wire["qp"] = ft.qp
        # seven per-MB booleans ride one byte (unpacked by bit on the device)
        wire["flags8"] = (
            (ft.mb_class == MB_I_16X16).astype(np.uint8)
            | (ft.transform_8x8.astype(np.uint8) << 1)
            | ((ft.mb_class < 3).astype(np.uint8) << 2)
            | (avl.reshape(-1).astype(np.uint8) << 3)
            | (avt.reshape(-1).astype(np.uint8) << 4)
            | (avtr.reshape(-1).astype(np.uint8) << 5)
            | (avtl.reshape(-1).astype(np.uint8) << 6)
        )
        wire["slot_cells8"] = np.ascontiguousarray(
            slot_parts.reshape(mb_h, mb_w, 2, 2, 2)
            .transpose(2, 0, 3, 1, 4)
            .reshape(2, mb_h * 2, mb_w * 2)
        )
        if weighted:  # ref-list indices only feed the weight-table gathers
            wire["ridx_cells8"] = np.ascontiguousarray(
                ft.ref_idx.reshape(mb_h, mb_w, 2, 2, 2)
                .transpose(2, 0, 3, 1, 4)
                .reshape(2, mb_h * 2, mb_w * 2)
            )
        wire["kind"] = kind.astype(np.int8)
        # intra NxN modes (-1..8) nibble-pack two per byte
        m4 = (ft.intra4x4_modes.astype(np.int16) + 1).astype(np.uint8)
        wire["modes4n"] = m4[:, 0::2] | (m4[:, 1::2] << 4)
        wire["i16mode"] = ft.intra16_mode
        wire["cmode"] = ft.chroma_mode
        wire["slice_mb"] = ft.slice_id.astype(np.int16)
        wire.update(wt)
        if has_pcm:
            wire["pcm_y"] = pcm_y
            wire["pcm_cb"] = pcm_cb
            wire["pcm_cr"] = pcm_cr
        if self.apply_deblock:
            wire["mb_cls"] = ft.mb_class
            wire["disable"] = ft.disable_deblock
            wire["aoff"] = ft.alpha_off
            wire["boff"] = ft.beta_off
            wire["nnz_bits"] = np.packbits((ft.luma_nnz > 0).reshape(-1))
        if m is not None:
            m.count("bytes_up", sum(v.nbytes for v in wire.values()))
        dyn = self._dyn(sps, pps)
        # typical P/B frames code zero intra MBs: skip the intra kernels
        has_intra = bool(kind.any())
        # all-even MVs make the Table 8-12 second sample dead
        need_s2 = bool(((ft.mv & 1) != 0).any())
        flags = (has_l8, has_pcm, self.apply_deblock, sparse, has_intra, need_s2,
                 sps.chroma_array_type if cf2 or cf3 else 1, bd)
        key = frame_program.signature(wire, dyn, mb_h, mb_w, flags)
        if key not in self._keys:
            self._keys.add(key)
            if m is not None:
                m.count("program_keys")
        packed = self._rings.dispatch(frame_step, key, wire, dyn, mb_h, mb_w, flags, cur_slot, m)
        if self.device.type == "cuda":
            # the copy starts now and overlaps later frames' work; the
            # first plane access waits for its event
            done = torch.cuda.Event()
            done.record()
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            out = _PackedFrame(host, H, W, m, done, copied)
        else:
            out = _PackedFrame(packed, H, W, m)
        return _PlaneView(out, 0), _PlaneView(out, 1), _PlaneView(out, 2)
