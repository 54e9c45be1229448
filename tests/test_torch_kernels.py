"""Port kernels (plain torch, on the CPU) against their JAX counterparts.

Each test draws seeded numpy inputs, runs the JAX function and the port's
function on them, and requires identical integers (tolerance 0: the decoder
is integer-exact). Sizes are 64x64 (4x4 MBs) or QCIF.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264decode_tpu.kernels import deblock as j_db
from h264decode_tpu.kernels import deblock_prep_dev as j_prep
from h264decode_tpu.kernels import intra as j_intra
from h264decode_tpu.kernels import mc as j_mc
from h264decode_tpu.kernels import transform as j_tr
from h264decode_tpu_torch import convert
from h264decode_tpu_torch.kernels import deblock as t_db
from h264decode_tpu_torch.kernels import deblock_cuda, intra_cuda
from h264decode_tpu_torch.kernels import deblock_prep_dev as t_prep
from h264decode_tpu_torch.kernels import intra as t_intra
from h264decode_tpu_torch.kernels import mc as t_mc
from h264decode_tpu_torch.kernels import transform as t_tr
from tests.test_torch_cuda import _intra_inputs, _prep_inputs

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.asarray(a))


def eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def _scaling(rng):
    """Random scaling lists -> (ls4_y [2,6,4,4], ls8_y [2,6,8,8], ls4_c)."""
    def l4():
        return t_tr.level_scale_tables_4x4(rng.integers(4, 64, 16))

    def l8():
        return t_tr.level_scale_tables_8x8(rng.integers(4, 64, 64))

    return (np.stack([l4(), l4()]), np.stack([l8(), l8()]),
            np.stack([np.stack([l4(), l4()]), np.stack([l4(), l4()])]))


# (qp mode, ChromaArrayType, bit depth): "zero" is the lowest QP, where
# QP'Y = 0 (QPY = -QpBdOffsetY at high bit depth). The 4:2:0 8-bit cases keep
# the qp mode alone as their id.
TRANSFORM_CASES = [(m, cat, bd) for cat, bd in ((1, 8), (1, 10), (2, 10)) for m in
                   ("zero", "max", "random")] + [("random", 2, 8)]


@pytest.mark.parametrize("qp_mode,cat,bd", TRANSFORM_CASES,
                         ids=[m if (c, b) == (1, 8) else f"{m}-{c}-{b}"
                              for m, c, b in TRANSFORM_CASES])
def test_transform_matches_jax(qp_mode, cat, bd):
    seed = {"zero": 1, "max": 2, "random": 3}[qp_mode] + 10 * (cat - 1) + (bd - 8)
    rng = np.random.default_rng(seed)
    mb_h, mb_w = 4, 4
    n = mb_h * mb_w
    off = 6 * (bd - 8)
    qp = {"zero": np.full(n, -off), "max": np.full(n, 51),
          "random": rng.integers(-off, 52, n)}[qp_mode].astype(np.int32)
    luma_ac = rng.integers(-40, 40, (n, 16, 16)).astype(np.int32)
    luma_dc = rng.integers(-40, 40, (n, 16)).astype(np.int32)
    luma8 = rng.integers(-40, 40, (n, 4, 64)).astype(np.int32)
    is_i16 = rng.random(n) < 0.3
    is_t8 = (rng.random(n) < 0.4) & ~is_i16
    intra = rng.random(n) < 0.5
    ls4, ls8, ls4c = _scaling(rng)
    qpy = qp + off  # QP'Y, what luma dequant consumes
    ja = j_tr.luma_residual_plane(
        jnp.asarray(luma_ac), jnp.asarray(luma_dc), jnp.asarray(luma8),
        jnp.asarray(qpy), jnp.asarray(is_i16), jnp.asarray(is_t8), jnp.asarray(intra),
        jnp.asarray(ls4), jnp.asarray(ls8), mb_h, mb_w)
    to = t_tr.luma_residual_plane(T(luma_ac), T(luma_dc), T(luma8), T(qpy), T(is_i16),
                                  T(is_t8), T(intra), T(ls4), T(ls8), mb_h, mb_w)
    eq(ja, to)
    nb = 8 if cat == 2 else 4  # chroma 4x4 blocks per MB component
    cdc = rng.integers(-60, 60, (n, 2, nb)).astype(np.int32)
    cac = rng.integers(-40, 40, (n, 2, nb, 16)).astype(np.int32)
    offs = (int(rng.integers(-12, 13)), int(rng.integers(-12, 13)))
    j_fn = j_tr.chroma_residual_planes_422 if cat == 2 else j_tr.chroma_residual_planes
    t_fn = t_tr.chroma_residual_planes_422 if cat == 2 else t_tr.chroma_residual_planes
    jc = j_fn(jnp.asarray(cdc), jnp.asarray(cac), jnp.asarray(qp), jnp.asarray(intra),
              jnp.asarray(ls4c), offs, mb_h, mb_w, bd=bd)
    tc = t_fn(T(cdc), T(cac), T(qp), T(intra), T(ls4c), offs, mb_h, mb_w, bd=bd)
    assert tc[0].shape == (mb_h * 4 * nb // 2, mb_w * 8)
    eq(jc[0], tc[0])
    eq(jc[1], tc[1])


def _mc_inputs(seed, H=64, W=64, R=3, far=False, even=False, cat=1, bd=8):
    rng = np.random.default_rng(seed)
    sdt = np.uint8 if bd == 8 else np.uint16
    top = 1 << bd
    Hc = H if cat == 2 else H // 2
    refs = [rng.integers(0, top, (H, W)).astype(sdt) for _ in range(R)]
    crefs = [(rng.integers(0, top, (Hc, W // 2)).astype(sdt),
              rng.integers(0, top, (Hc, W // 2)).astype(sdt)) for _ in range(R)]
    H4, W4 = H // 4, W // 4
    lim = 4 * 3 * max(H, W) if far else 64
    mv = rng.integers(-lim, lim, (2, H4, W4, 2)).astype(np.int32)
    if even:
        mv &= ~1
    slot = rng.integers(-1, R, (2, H4, W4)).astype(np.int32)
    return refs, crefs, mv, slot


def S(a):
    """A sample plane as the port holds it: uint8, or int16 above 8 bits."""
    a = np.asarray(a)
    return T(a.astype(np.int16) if a.dtype == np.uint16 else a)


def _jax_rings(refs, crefs, bd):
    """The JAX package's pair-packed DPB rings of these pictures (numpy):
    (luma, chroma) at 8 bits, (luma, Cb, Cr) above."""
    if bd == 8:
        ring_y = np.stack([np.asarray(j_mc.pack_pair8(j_mc.half_pel_planes(jnp.asarray(r))))
                           for r in refs])
        ring_c = np.stack([
            np.asarray(j_mc.pack_pair16(
                j_mc.chroma_pad(jnp.asarray(cb)).astype(jnp.uint16)
                | (j_mc.chroma_pad(jnp.asarray(cr)).astype(jnp.uint16) << 8)))
            for cb, cr in crefs])
        return ring_y, ring_c
    mx = (1 << bd) - 1
    ring_y = np.stack([np.asarray(j_mc.pack_pair16(j_mc.half_pel_planes(jnp.asarray(r), mx)))
                       for r in refs])
    rings_c = [np.stack([np.asarray(j_mc.pack_pair16(
        j_mc.chroma_pad(jnp.asarray(c[k])).astype(jnp.uint16))) for c in crefs])
        for k in range(2)]
    return ring_y, rings_c[0], rings_c[1]


# (far, even, ChromaArrayType, bit depth); the 4:2:0 8-bit cases keep their ids
MC_CASES = [(False, False, 1, 8), (True, False, 1, 8), (True, True, 1, 8),
            (False, False, 2, 8), (True, False, 1, 10), (True, False, 2, 10)]


@pytest.mark.parametrize("far,even,cat,bd", MC_CASES,
                         ids=[f"{f}-{e}" + ("" if (c, b) == (1, 8) else f"-{c}-{b}")
                              for f, e, c, b in MC_CASES])
def test_mc_matches_jax(far, even, cat, bd):
    H = W = 64
    Hc = H if cat == 2 else H // 2
    mx = (1 << bd) - 1
    seed = 11 + far + 2 * even + 4 * (cat - 1) + (bd - 8)
    refs, crefs, mv, slot = _mc_inputs(seed, H, W, far=far, even=even, cat=cat, bd=bd)
    # JAX ring: pair-packed layouts; port ring: unpacked via convert.ring_from_jax
    jrings = _jax_rings(refs, crefs, bd)
    t_ring_y, t_ring_c = convert.ring_from_jax(*jrings)
    # the unpacked ring is exactly what the port builds from the planes
    assert torch.equal(t_ring_y[1], t_mc.half_pel_planes(S(refs[1]), mx))
    assert torch.equal(t_ring_c[2, 0], t_mc.chroma_pad(S(crefs[2][0])))
    assert torch.equal(t_ring_c[0, 1], t_mc.chroma_pad(S(crefs[0][1])))
    need_s2 = not even
    preds = {}
    for lst in range(2):
        jy = j_mc.luma_mc(jnp.asarray(jrings[0]), jnp.asarray(slot[lst]),
                          jnp.asarray(mv[lst]), H, W, need_s2)
        ty = t_mc.luma_mc(t_ring_y, T(slot[lst]), T(mv[lst]), H, W, need_s2)
        eq(jy, ty)
        jcb, jcr = j_mc.chroma_mc_pair(
            jnp.asarray(jrings[1]), jnp.asarray(slot[lst]), jnp.asarray(mv[lst]), Hc, W // 2,
            chroma_array_type=cat, packed2=jnp.asarray(jrings[2]) if bd > 8 else None, mx=mx)
        tcb, tcr = t_mc.chroma_mc_pair(t_ring_c, T(slot[lst]), T(mv[lst]), Hc, W // 2,
                                       chroma_array_type=cat)
        eq(jcb, tcb)
        eq(jcr, tcr)
        preds[lst] = (np.asarray(jy), ty)
    # weighted and bi-predicted combine with per-pixel weights
    rng = np.random.default_rng(5)
    use0 = rng.random((H, W)) < 0.7
    use1 = rng.random((H, W)) < 0.7
    w0, w1 = rng.integers(-128, 128, (2, H, W)).astype(np.int32)
    o0, o1 = (rng.integers(-128, 128, (2, H, W)) << (bd - 8)).astype(np.int32)
    lwd = rng.integers(0, 8, (H, W)).astype(np.int32)
    jw = j_mc.weighted_combine(jnp.asarray(preds[0][0]), jnp.asarray(preds[1][0]),
                               jnp.asarray(use0), jnp.asarray(use1), jnp.asarray(w0),
                               jnp.asarray(o0), jnp.asarray(w1), jnp.asarray(o1),
                               jnp.asarray(lwd), mx)
    tw = t_mc.weighted_combine(preds[0][1], preds[1][1], T(use0), T(use1), T(w0), T(o0),
                               T(w1), T(o1), T(lwd), mx)
    eq(jw, tw)
    # identity weights as scalars (the unweighted short cut)
    jd = j_mc.weighted_combine(jnp.asarray(preds[0][0]), jnp.asarray(preds[1][0]),
                               jnp.asarray(use0), jnp.asarray(use1), 32, 0, 32, 0, 5, mx)
    td = t_mc.weighted_combine(preds[0][1], preds[1][1], T(use0), T(use1), 32, 0, 32, 0, 5,
                               mx)
    eq(jd, td)


def _prep_both(p, mb_h=4, mb_w=4, slot_cells=True, all_h=False):
    keys = ("mb_cls", "qp", "t8", "slice_mb", "disable", "aoff", "boff", "nnz",
            "ref_pic", "mv")
    jp = j_prep.deblock_prep_device(
        *(jnp.asarray(p[k]) for k in keys), p["offs"], mb_h, mb_w,
        slot_cells=jnp.asarray(p["slot"]) if slot_cells else None,
        chroma_all_h_edges=all_h)
    tp = t_prep.deblock_prep_device(
        *(T(p[k]) for k in keys), p["offs"], mb_h, mb_w,
        slot_cells=T(p["slot"]) if slot_cells else None, chroma_all_h_edges=all_h)
    return jp, tp


@pytest.mark.parametrize("seed,slot_cells,all_h", [(21, True, False), (22, False, False),
                                                   (23, True, True)],
                         ids=["21-True", "22-False", "23-True-422"])
def test_deblock_prep_matches_jax(seed, slot_cells, all_h):
    jp, tp = _prep_both(_prep_inputs(seed), slot_cells=slot_cells, all_h=all_h)
    assert set(jp) == set(tp)
    assert ("bs_hc" in tp) == all_h
    for k in jp:
        eq(jp[k], tp[k])
        assert tp[k].dtype == torch.int32, k
    # every bS value 0..4 occurs in this draw
    vals = set(np.unique(np.concatenate([tp["bs_v"].numpy().ravel(),
                                         tp["bs_h"].numpy().ravel()])).tolist())
    assert vals == {0, 1, 2, 3, 4}
    # the cell-expansion helpers
    rng = np.random.default_rng(seed)
    for fn in ("_mb_to_cells", "_part_to_cells", "_blk_to_cells"):
        width = {"_mb_to_cells": 1, "_part_to_cells": 4, "_blk_to_cells": 16}[fn]
        a = rng.integers(-9, 9, (16, width)).astype(np.int32).squeeze(1 if width == 1 else ())
        eq(getattr(j_prep, fn)(jnp.asarray(a), 4, 4), getattr(t_prep, fn)(T(a), 4, 4))


# (seed, mb_h, mb_w, chroma MB height, bit depth); the 4:2:0 8-bit cases
# keep their ids
INTRA_CASES = [(31, 4, 4, 8, 8), (32, 9, 11, 8, 8), (33, 4, 4, 16, 10), (34, 5, 6, 8, 10)]


@pytest.mark.parametrize("seed,mb_h,mb_w,ch_h,bd", INTRA_CASES,
                         ids=[f"{s}-{h}-{w}" + ("" if (c, b) == (8, 8) else f"-ch{c}-bd{b}")
                              for s, h, w, c, b in INTRA_CASES])
def test_intra_plain_matches_jax(seed, mb_h, mb_w, ch_h, bd):
    args = _intra_inputs(seed, mb_h, mb_w, ch_h=ch_h, bd=bd)
    fmt = dict(ch_h=ch_h, mid=1 << (bd - 1), mx=(1 << bd) - 1)
    jo = j_intra.intra_wavefront(*(jnp.asarray(a) for a in args), mb_h, mb_w, **fmt)
    to = t_intra.intra_wavefront(*(T(a) for a in args), mb_h, mb_w, **fmt)
    assert to[1].shape == (mb_h * ch_h, mb_w * 8)
    for a, b in zip(jo, to):
        eq(a, b)
    # the CPU path of the kernel wrapper is the plain version
    wo = intra_cuda.intra_frame(*(T(a) for a in args), mb_h, mb_w, **fmt)
    for a, b in zip(to, wo):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,x,y", [(61, 1, 2), (62, 3, 1)])
def test_intra_chroma_ignores_top_right(seed, x, y):
    """Chroma intra prediction (spec 8.3.4) never reads the MB above-right,
    the premise of the CUDA chroma kernel's wait for row y-1's MB x alone.
    Every MB is intra with every neighbour available, except MB (x+1, y-1):
    new samples there must leave the chroma of every MB outside the cone it
    feeds through left, top and top-left neighbours (columns >= x+1, rows
    >= y-1) unchanged, MB (x, y) included, in the JAX reference and in the
    port's plain version (tolerance 0)."""
    mb_h, mb_w = 5, 6
    args = list(_intra_inputs(seed, mb_h, mb_w, all_intra=True))
    kind, cmode = args[6].copy(), args[9].copy()
    kind[(y - 1) * mb_w + x + 1] = 0
    cmode[y * mb_w + x] = 3          # plane: reads the whole row above and the corner
    cmode[y * mb_w + x + 1] = 2      # vertical: carries the new samples down
    args[6], args[9] = kind, cmode
    rng = np.random.default_rng(seed)
    outs = []
    for changed in (False, True):
        a = list(args)
        if changed:
            for k in (1, 2):  # cb, cr
                a[k] = a[k].copy()
                a[k][8 * (y - 1):8 * y, 8 * (x + 1):8 * (x + 2)] = rng.integers(0, 256, (8, 8))
        jo = j_intra.intra_wavefront(*(jnp.asarray(v) for v in a), mb_h, mb_w)
        to = t_intra.intra_wavefront(*(T(v) for v in a), mb_h, mb_w)
        for j, t in zip(jo[1:], to[1:]):
            eq(j, t)
        outs.append([t.numpy() for t in to[1:]])
    cone = np.zeros((mb_h, mb_w), bool)
    cone[y - 1:, x + 1:] = True
    cone_px = np.kron(cone, np.ones((8, 8), bool))
    below = np.zeros((mb_h, mb_w), bool)
    below[y, x + 1] = True
    below_px = np.kron(below, np.ones((8, 8), bool))
    for before, after in zip(*outs):
        np.testing.assert_array_equal(before[~cone_px], after[~cone_px])
        # the new samples do reach the MB below them
        assert not np.array_equal(before[below_px], after[below_px])


# (seed, mb_h, mb_w, chroma MB height, bit depth); the 4:2:0 8-bit cases
# keep their ids
DEBLOCK_CASES = [(41, 4, 4, 8, 8), (42, 9, 11, 8, 8), (43, 4, 4, 16, 10), (44, 5, 6, 8, 10),
                 (45, 5, 6, 16, 8)]


@pytest.mark.parametrize("seed,mb_h,mb_w,ch_h,bd", DEBLOCK_CASES,
                         ids=[f"{s}-{h}-{w}" + ("" if (c, b) == (8, 8) else f"-ch{c}-bd{b}")
                              for s, h, w, c, b in DEBLOCK_CASES])
def test_deblock_plain_matches_jax(seed, mb_h, mb_w, ch_h, bd):
    rng = np.random.default_rng(seed)
    p = _prep_inputs(seed, mb_h, mb_w)
    sh, mx = bd - 8, (1 << bd) - 1
    sdt = np.uint8 if bd == 8 else np.uint16
    # low-contrast planes so the filters really fire
    y = np.clip((128 << sh) + rng.integers(-12 << sh, (12 << sh) + 1, (16 * mb_h, 16 * mb_w)),
                0, mx).astype(sdt)
    cb, cr = np.clip((128 << sh) + rng.integers(-10 << sh, (10 << sh) + 1,
                                                (2, ch_h * mb_h, 8 * mb_w)), 0, mx).astype(sdt)
    jp, tp = _prep_both(p, mb_h, mb_w, all_h=ch_h == 16)
    fmt = dict(ch_h=ch_h, bd_scale=1 << sh, mx=mx)
    jo = j_db.deblock_frame_tpu(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), jp,
                                mb_h, mb_w, **fmt)
    to = t_db.deblock_frame(S(y), S(cb), S(cr), tp, mb_h, mb_w, **fmt)
    for a, b in zip(jo, to):
        assert b.dtype == S(y).dtype
        eq(np.asarray(a).astype(np.int32), b.to(torch.int32))
    assert not np.array_equal(to[0].numpy(), S(y).numpy())
    assert not np.array_equal(to[1].numpy(), S(cb).numpy())
    wo = deblock_cuda.deblock_frame(S(y), S(cb), S(cr), tp, mb_h, mb_w, **fmt)
    for a, b in zip(to, wo):
        assert torch.equal(a, b)


def test_build_name_covers_headers(tmp_path, monkeypatch):
    """A kernel library's name hashes its source and every csrc/*.cuh, so an
    edit to a shared header never loads a stale build (no nvcc needed)."""
    from h264decode_tpu_torch.kernels import _build

    (tmp_path / "k.cu").write_text('#include "wavefront.cuh"\n')
    (tmp_path / "wavefront.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build.lib_path("k")
    assert _build.lib_path("k") == first
    assert _build.sources() == ["k"]
    (tmp_path / "wavefront.cuh").write_text("// v2\n")
    second = _build.lib_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build.lib_path("k") != second
    (tmp_path / "k.cu").write_text('#include "wavefront.cuh"\n// edit\n')
    assert _build.lib_path("k") not in (first, second)


def test_intra_planes_plain_matches_jax_per_plane():
    """8-bit 4:4:4 intra at 4x6 MBs: the CPU path of intra_planes against the
    JAX intra_wavefront run on each of Y, Cb and Cr with dummy chroma and
    chroma mode 0, as the JAX package's 4:4:4 frame program runs it
    (tolerance 0)."""
    mb_h, mb_w = 4, 6
    a = _intra_inputs(35, mb_h, mb_w)
    rng = np.random.default_rng(35)
    H, W = 16 * mb_h, 16 * mb_w
    planes = np.stack([a[0], rng.integers(0, 256, (H, W)), rng.integers(0, 256, (H, W))])
    resid = np.stack([a[3], rng.integers(-40, 40, (H, W)), rng.integers(-40, 40, (H, W))])
    planes, resid = planes.astype(np.int32), resid.astype(np.int32)
    kind, modes4, i16, _, avl, avt, avtr, avtl = a[6:]
    dummy = jnp.zeros((8 * mb_h, 8 * mb_w), jnp.int32)
    want = [j_intra.intra_wavefront(jnp.asarray(p), dummy, dummy, jnp.asarray(r), dummy, dummy,
                                    *(jnp.asarray(v) for v in (kind, modes4, i16)),
                                    jnp.zeros(mb_h * mb_w, jnp.int32),
                                    *(jnp.asarray(v) for v in (avl, avt, avtr, avtl)),
                                    mb_h, mb_w)[0]
            for p, r in zip(planes, resid)]
    got = intra_cuda.intra_planes(T(planes), T(resid), T(kind), T(modes4), T(i16), T(avl),
                                  T(avt), T(avtr), T(avtl), mb_h, mb_w)
    assert got.shape == (3, H, W)
    eq(np.stack([np.asarray(w) for w in want]), got)
    assert not torch.equal(got[1], T(planes[1]))  # Cb really reconstructed


def test_deblock_planes_plain_matches_jax_per_plane():
    """8-bit 4:4:4 deblocking at 4x6 MBs: the CPU path of deblock_planes,
    on the stacked prep that prep_444 makes from one prep made with the
    PPS's chroma QP offsets, against the JAX deblock_frame_tpu run on each plane
    with dummy chroma and that plane's own prep (the JAX 4:4:4 path's
    prep_for(qp_grid): Y's QP, Cb's and Cr's QPc, offsets (0, 0));
    tolerance 0."""
    mb_h, mb_w = 4, 6
    p = _prep_inputs(46, mb_h, mb_w)
    rng = np.random.default_rng(46)
    planes = np.clip(128 + rng.integers(-12, 13, (3, 16 * mb_h, 16 * mb_w)), 0, 255)
    planes = planes.astype(np.uint8)
    qps = [p["qp"]] + [t_tr.CHROMA_QP_TAB[np.clip(p["qp"] + off, 0, 51)] for off in p["offs"]]
    dummy = jnp.zeros((8 * mb_h, 8 * mb_w), jnp.uint8)
    want = []
    _, tp_all = _prep_both(p, mb_h, mb_w)
    prep3 = deblock_cuda.prep_444(tp_all)
    assert prep3["ia_v"].shape == (3, 4 * mb_h, 4 * mb_w)
    for k, (plane, qp) in enumerate(zip(planes, qps)):
        prep = deblock_cuda.plane_prep(prep3, k)
        jp, tp = _prep_both({**p, "qp": qp, "offs": (0, 0)}, mb_h, mb_w)
        for n in ("bs_v", "bs_h", "ia_v", "ib_v", "ia_h", "ib_h"):
            assert torch.equal(prep[n], tp[n]), n
        want.append(np.asarray(j_db.deblock_frame_tpu(jnp.asarray(plane), dummy, dummy, jp,
                                                      mb_h, mb_w)[0]))
    assert p["offs"][0] != p["offs"][1] and not torch.equal(prep3["ia_v"][1], prep3["ia_v"][0])
    got = deblock_cuda.deblock_planes(T(planes), prep3, mb_h, mb_w)
    assert got.dtype == torch.uint8
    eq(np.stack(want), got)
    for k in range(3):
        assert not torch.equal(got[k], T(planes[k]))
