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


@pytest.mark.parametrize("qp_mode", ["zero", "max", "random"])
def test_transform_matches_jax(qp_mode):
    rng = np.random.default_rng({"zero": 1, "max": 2, "random": 3}[qp_mode])
    mb_h, mb_w = 4, 4
    n = mb_h * mb_w
    qp = {"zero": np.zeros(n), "max": np.full(n, 51),
          "random": rng.integers(0, 52, n)}[qp_mode].astype(np.int32)
    luma_ac = rng.integers(-40, 40, (n, 16, 16)).astype(np.int32)
    luma_dc = rng.integers(-40, 40, (n, 16)).astype(np.int32)
    luma8 = rng.integers(-40, 40, (n, 4, 64)).astype(np.int32)
    is_i16 = rng.random(n) < 0.3
    is_t8 = (rng.random(n) < 0.4) & ~is_i16
    intra = rng.random(n) < 0.5
    ls4, ls8, ls4c = _scaling(rng)
    ja = j_tr.luma_residual_plane(
        jnp.asarray(luma_ac), jnp.asarray(luma_dc), jnp.asarray(luma8),
        jnp.asarray(qp), jnp.asarray(is_i16), jnp.asarray(is_t8), jnp.asarray(intra),
        jnp.asarray(ls4), jnp.asarray(ls8), mb_h, mb_w)
    to = t_tr.luma_residual_plane(T(luma_ac), T(luma_dc), T(luma8), T(qp), T(is_i16),
                                  T(is_t8), T(intra), T(ls4), T(ls8), mb_h, mb_w)
    eq(ja, to)
    cdc = rng.integers(-60, 60, (n, 2, 4)).astype(np.int32)
    cac = rng.integers(-40, 40, (n, 2, 4, 16)).astype(np.int32)
    offs = (int(rng.integers(-12, 13)), int(rng.integers(-12, 13)))
    jc = j_tr.chroma_residual_planes(jnp.asarray(cdc), jnp.asarray(cac), jnp.asarray(qp),
                                     jnp.asarray(intra), jnp.asarray(ls4c), offs, mb_h, mb_w)
    tc = t_tr.chroma_residual_planes(T(cdc), T(cac), T(qp), T(intra), T(ls4c), offs,
                                     mb_h, mb_w)
    eq(jc[0], tc[0])
    eq(jc[1], tc[1])


def _mc_inputs(seed, H=64, W=64, R=3, far=False, even=False):
    rng = np.random.default_rng(seed)
    refs = [rng.integers(0, 256, (H, W)).astype(np.uint8) for _ in range(R)]
    crefs = [(rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8),
              rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)) for _ in range(R)]
    H4, W4 = H // 4, W // 4
    lim = 4 * 3 * max(H, W) if far else 64
    mv = rng.integers(-lim, lim, (2, H4, W4, 2)).astype(np.int32)
    if even:
        mv &= ~1
    slot = rng.integers(-1, R, (2, H4, W4)).astype(np.int32)
    return refs, crefs, mv, slot


@pytest.mark.parametrize("far,even", [(False, False), (True, False), (True, True)])
def test_mc_matches_jax(far, even):
    H = W = 64
    refs, crefs, mv, slot = _mc_inputs(11 + far + 2 * even, H, W, far=far, even=even)
    # JAX ring: pair-packed layouts; port ring: unpacked via convert.ring_from_jax
    ring_y = np.stack([np.asarray(j_mc.pack_pair8(j_mc.half_pel_planes(jnp.asarray(r))))
                       for r in refs])
    ring_c = np.stack([
        np.asarray(j_mc.pack_pair16(
            j_mc.chroma_pad(jnp.asarray(cb)).astype(jnp.uint16)
            | (j_mc.chroma_pad(jnp.asarray(cr)).astype(jnp.uint16) << 8)))
        for cb, cr in crefs])
    t_ring_y, t_ring_c = convert.ring_from_jax(ring_y, ring_c)
    # the unpacked ring is exactly what the port builds from the planes
    assert torch.equal(t_ring_y[1], t_mc.half_pel_planes(T(refs[1])))
    assert torch.equal(t_ring_c[2, 0], t_mc.chroma_pad(T(crefs[2][0])))
    need_s2 = not even
    preds = {}
    for lst in range(2):
        jy = j_mc.luma_mc(jnp.asarray(ring_y), jnp.asarray(slot[lst]),
                          jnp.asarray(mv[lst]), H, W, need_s2)
        ty = t_mc.luma_mc(t_ring_y, T(slot[lst]), T(mv[lst]), H, W, need_s2)
        eq(jy, ty)
        jcb, jcr = j_mc.chroma_mc_pair(jnp.asarray(ring_c), jnp.asarray(slot[lst]),
                                       jnp.asarray(mv[lst]), H // 2, W // 2)
        tcb, tcr = t_mc.chroma_mc_pair(t_ring_c, T(slot[lst]), T(mv[lst]), H // 2, W // 2)
        eq(jcb, tcb)
        eq(jcr, tcr)
        preds[lst] = (np.asarray(jy), ty)
    # weighted and bi-predicted combine with per-pixel weights
    rng = np.random.default_rng(5)
    use0 = rng.random((H, W)) < 0.7
    use1 = rng.random((H, W)) < 0.7
    w0, w1 = rng.integers(-128, 128, (2, H, W)).astype(np.int32)
    o0, o1 = rng.integers(-128, 128, (2, H, W)).astype(np.int32)
    lwd = rng.integers(0, 8, (H, W)).astype(np.int32)
    jw = j_mc.weighted_combine(jnp.asarray(preds[0][0]), jnp.asarray(preds[1][0]),
                               jnp.asarray(use0), jnp.asarray(use1), jnp.asarray(w0),
                               jnp.asarray(o0), jnp.asarray(w1), jnp.asarray(o1),
                               jnp.asarray(lwd))
    tw = t_mc.weighted_combine(preds[0][1], preds[1][1], T(use0), T(use1), T(w0), T(o0),
                               T(w1), T(o1), T(lwd))
    eq(jw, tw)
    # identity weights as scalars (the unweighted short cut)
    jd = j_mc.weighted_combine(jnp.asarray(preds[0][0]), jnp.asarray(preds[1][0]),
                               jnp.asarray(use0), jnp.asarray(use1), 32, 0, 32, 0, 5)
    td = t_mc.weighted_combine(preds[0][1], preds[1][1], T(use0), T(use1), 32, 0, 32, 0, 5)
    eq(jd, td)


def _prep_both(p, mb_h=4, mb_w=4, slot_cells=True):
    keys = ("mb_cls", "qp", "t8", "slice_mb", "disable", "aoff", "boff", "nnz",
            "ref_pic", "mv")
    jp = j_prep.deblock_prep_device(
        *(jnp.asarray(p[k]) for k in keys), p["offs"], mb_h, mb_w,
        slot_cells=jnp.asarray(p["slot"]) if slot_cells else None)
    tp = t_prep.deblock_prep_device(
        *(T(p[k]) for k in keys), p["offs"], mb_h, mb_w,
        slot_cells=T(p["slot"]) if slot_cells else None)
    return jp, tp


@pytest.mark.parametrize("seed,slot_cells", [(21, True), (22, False)])
def test_deblock_prep_matches_jax(seed, slot_cells):
    jp, tp = _prep_both(_prep_inputs(seed), slot_cells=slot_cells)
    assert set(jp) == set(tp)
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


@pytest.mark.parametrize("seed,mb_h,mb_w", [(31, 4, 4), (32, 9, 11)])
def test_intra_plain_matches_jax(seed, mb_h, mb_w):
    args = _intra_inputs(seed, mb_h, mb_w)
    jo = j_intra.intra_wavefront(*(jnp.asarray(a) for a in args), mb_h, mb_w)
    to = t_intra.intra_wavefront(*(T(a) for a in args), mb_h, mb_w)
    for a, b in zip(jo, to):
        eq(a, b)
    # the CPU path of the kernel wrapper is the plain version
    wo = intra_cuda.intra_frame(*(T(a) for a in args), mb_h, mb_w)
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


@pytest.mark.parametrize("seed,mb_h,mb_w", [(41, 4, 4), (42, 9, 11)])
def test_deblock_plain_matches_jax(seed, mb_h, mb_w):
    rng = np.random.default_rng(seed)
    p = _prep_inputs(seed, mb_h, mb_w)
    # low-contrast planes so the filters really fire
    y = np.clip(128 + rng.integers(-12, 13, (16 * mb_h, 16 * mb_w)), 0, 255).astype(np.uint8)
    cb, cr = np.clip(128 + rng.integers(-10, 11, (2, 8 * mb_h, 8 * mb_w)), 0, 255).astype(
        np.uint8)
    jp, tp = _prep_both(p, mb_h, mb_w)
    jo = j_db.deblock_frame_tpu(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), jp,
                                mb_h, mb_w)
    to = t_db.deblock_frame(T(y), T(cb), T(cr), tp, mb_h, mb_w)
    for a, b in zip(jo, to):
        eq(a, b)
    assert not np.array_equal(to[0].numpy(), y)
    wo = deblock_cuda.deblock_frame(T(y), T(cb), T(cr), tp, mb_h, mb_w)
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
