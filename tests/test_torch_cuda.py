"""The CUDA kernels against their plain torch versions, on the card.

This module imports no JAX (the card's machine has none); it also holds the
seeded input generators that tests/test_torch_kernels.py shares.

These need a CUDA device and nvcc: they carry the `cuda` marker and, without
a card, skip (decided inside the fixture, never at import). On a machine
with a card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

(named alone: the other test files import JAX).
"""

import numpy as np
import pytest
import torch

from h264decode_tpu_torch.kernels import _build, deblock_cuda, intra_cuda
from h264decode_tpu_torch.kernels import deblock as t_db
from h264decode_tpu_torch.kernels import intra as t_intra

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _prep_inputs(seed, mb_h=4, mb_w=4):
    rng = np.random.default_rng(seed)
    n = mb_h * mb_w
    H4, W4 = mb_h * 4, mb_w * 4
    return dict(
        mb_cls=rng.integers(0, 8, n).astype(np.int32),
        qp=rng.integers(0, 52, n).astype(np.int32),
        t8=rng.random(n) < 0.4,
        slice_mb=(np.arange(n) >= n // 2).astype(np.int32),
        disable=rng.integers(0, 3, n).astype(np.int32),
        aoff=(2 * rng.integers(-6, 7, n)).astype(np.int32),
        boff=(2 * rng.integers(-6, 7, n)).astype(np.int32),
        nnz=(rng.random((H4, W4)) < 0.3).astype(np.int32) * rng.integers(1, 9, (H4, W4)),
        ref_pic=rng.integers(-1, 3, (n, 2, 4)).astype(np.int32),
        mv=rng.integers(-12, 12, (2, H4, W4, 2)).astype(np.int32),
        slot=rng.integers(-1, 3, (2, H4, W4)).astype(np.int32),
        offs=(int(rng.integers(-12, 13)), int(rng.integers(-12, 13))),
    )


def _intra_inputs(seed, mb_h, mb_w, all_intra=False, ch_h=8, bd=8):
    """Every MB kind, every mode and random availability combinations; with
    all_intra, every MB intra and every neighbour inside the picture
    available (so every MB of the row kernels waits on the row above).
    Samples span 0 .. (1 << bd) - 1; chroma planes are mb_h * ch_h high."""
    rng = np.random.default_rng(seed)
    n = mb_h * mb_w
    H, W = 16 * mb_h, 16 * mb_w
    Hc, s = ch_h * mb_h, bd - 8
    kind = rng.integers(1 if all_intra else 0, 4, n).astype(np.int32)
    base_y = rng.integers(0, 256 << s, (H, W)).astype(np.int32)
    base_c = rng.integers(0, 256 << s, (2, Hc, W // 2)).astype(np.int32)
    ry = rng.integers(-40 << s, 40 << s, (H, W)).astype(np.int32)
    rc = rng.integers(-40 << s, 40 << s, (2, Hc, W // 2)).astype(np.int32)
    modes4 = rng.integers(0, 9, (n, 16)).astype(np.int32)
    i16 = rng.integers(0, 4, n).astype(np.int32)
    cm = rng.integers(0, 4, n).astype(np.int32)
    av = rng.random((4, n)) < 0.6
    if all_intra:
        my, mx = np.divmod(np.arange(n), mb_w)
        av = np.stack([mx > 0, my > 0, (my > 0) & (mx < mb_w - 1), (my > 0) & (mx > 0)])
    return (base_y, base_c[0], base_c[1], ry, rc[0], rc[1], kind, modes4, i16, cm,
            av[0], av[1], av[2], av[3])


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


# (mb_h, mb_w): small frames, one MB, a single row, a single column, and more
# MB rows (140) than the H100 has SMs (132)
SHAPES = [(4, 4), (9, 11), (1, 1), (1, 7), (7, 1), (140, 3)]


def _launch_counts(names):
    return {k: (_build.launches[k], _build.device_kernels[k]) for k in names}


def _assert_launched(before):
    # every kernel is one persistent row-wavefront launch per call
    for k, (calls, kernels) in before.items():
        assert _build.launches[k] == calls + 1
        assert _build.device_kernels[k] == kernels + 1


# (ChromaArrayType, bit depth) of the kernels' instantiations
FORMATS = [(1, 8), (1, 10), (2, 10)]
FORMAT_IDS = ["420_8", "420_10", "422_10"]


def _fmt(cat, bd):
    """The kernels' format arguments: chroma MB height, DC fallback, Clip1
    ceiling and deblock threshold scale."""
    return dict(ch_h=16 if cat == 2 else 8, mid=1 << (bd - 1), mx=(1 << bd) - 1,
                bd_scale=1 << (bd - 8))


def _intra_args(cuda, seed, mb_h, mb_w, all_intra=False, cat=1, bd=8):
    return [torch.as_tensor(a, device=cuda)
            for a in _intra_inputs(seed, mb_h, mb_w, all_intra, 16 if cat == 2 else 8, bd)]


def _deblock_args(cuda, seed, mb_h, mb_w, edges="prep", cat=1, bd=8):
    """Planes (uint8 at 8 bits, int16 above) and edge parameters. edges:
    "prep" keeps the derived bS; "top" also sets bS 1..4 on every MB's
    chroma top edge (luma edge 0, below the first MB row), so every MB of
    the chroma kernel waits; "odd" leaves bS > 0 only on luma edges 1 and 3,
    which carry no 4:2:0 chroma edge (so no MB of the 4:2:0 chroma kernel
    has work) but do carry the 4:2:2 chroma edges at chroma rows 4 and 12."""
    from h264decode_tpu_torch.kernels.deblock_prep_dev import deblock_prep_device

    p = _prep_inputs(seed, mb_h, mb_w)
    keys = ("mb_cls", "qp", "t8", "slice_mb", "disable", "aoff", "boff", "nnz",
            "ref_pic", "mv")
    T = lambda a: torch.as_tensor(np.asarray(a), device=cuda)  # noqa: E731
    prep = deblock_prep_device(*(T(p[k]) for k in keys), p["offs"], mb_h, mb_w,
                               slot_cells=T(p["slot"]), chroma_all_h_edges=cat == 2)
    rng = np.random.default_rng(seed)
    H4, W4 = 4 * mb_h, 4 * mb_w
    hkeys = ("bs_h", "bs_hc") if cat == 2 else ("bs_h",)
    if edges == "top":
        for k in hkeys:
            bs_h = prep[k].cpu().numpy()
            bs_h[4:H4:4] = rng.integers(1, 5, (mb_h - 1, W4))
            prep[k] = T(bs_h)
    elif edges == "odd":
        odd = rng.integers(1, 5, (2, H4, W4)).astype(np.int32)
        odd[0][:, 0::2] = 0  # vertical: cell columns 1 and 3 of each MB
        odd[1][0::2] = 0     # horizontal: cell rows 1 and 3
        prep["bs_v"] = T(odd[0])
        for k in hkeys:
            prep[k] = T(odd[1])
    sh, mx = bd - 8, (1 << bd) - 1
    dt = np.uint8 if bd == 8 else np.int16
    ch_h = 16 if cat == 2 else 8
    y = T(np.clip((128 << sh) + rng.integers(-12 << sh, (12 << sh) + 1,
                                             (16 * mb_h, 16 * mb_w)), 0, mx).astype(dt))
    cb, cr = (T(np.clip((128 << sh) + rng.integers(-10 << sh, (10 << sh) + 1,
                                                   (ch_h * mb_h, 8 * mb_w)), 0, mx).astype(dt))
              for _ in range(2))
    return y, cb, cr, prep


@pytest.mark.parametrize("cat,bd", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("all_intra", [False, True])
@pytest.mark.parametrize("mb_h,mb_w", SHAPES)
def test_intra_kernels_match_plain(cuda, mb_h, mb_w, all_intra, cat, bd):
    args = _intra_args(cuda, 31 + mb_h + mb_w, mb_h, mb_w, all_intra, cat, bd)
    f = _fmt(cat, bd)
    fmt = dict(ch_h=f["ch_h"], mid=f["mid"], mx=f["mx"])
    plain = t_intra.intra_wavefront(*args, mb_h, mb_w, **fmt)
    before = _launch_counts(("intra_luma", "intra_chroma"))
    out = intra_cuda.intra_frame(*args, mb_h, mb_w, **fmt)
    torch.cuda.synchronize()
    for a, b in zip(plain, out):
        assert torch.equal(a, b)
    _assert_launched(before)


@pytest.mark.parametrize("cat,bd", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("edges", ["prep", "top", "odd"])
@pytest.mark.parametrize("mb_h,mb_w", SHAPES)
def test_deblock_kernels_match_plain(cuda, mb_h, mb_w, edges, cat, bd):
    y, cb, cr, prep = _deblock_args(cuda, 41 + mb_h + mb_w, mb_h, mb_w, edges, cat, bd)
    f = _fmt(cat, bd)
    fmt = dict(ch_h=f["ch_h"], bd_scale=f["bd_scale"], mx=f["mx"])
    plain = t_db.deblock_frame(y, cb, cr, prep, mb_h, mb_w, **fmt)
    before = _launch_counts(("deblock_luma", "deblock_chroma"))
    out = deblock_cuda.deblock_frame(y, cb, cr, prep, mb_h, mb_w, **fmt)
    torch.cuda.synchronize()
    for a, b in zip(plain, out):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    if edges == "odd" and cat == 1:  # luma edges 1 and 3 alone filter no 4:2:0 chroma
        assert torch.equal(out[1], cb) and torch.equal(out[2], cr)
    if edges == "odd" and cat == 2 and mb_h * mb_w > 1:  # but they do filter 4:2:2 chroma
        assert not torch.equal(out[1], cb)
    _assert_launched(before)


@pytest.mark.parametrize("cat,bd", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("mb_h,mb_w", [(9, 11), (140, 3)])
def test_kernels_repeat_identically(cuda, mb_h, mb_w, cat, bd):
    """A race shows as outputs that differ between runs: run every kernel 10
    times on one input and require the same output each time."""
    args = _intra_args(cuda, 51, mb_h, mb_w, cat=cat, bd=bd)
    y, cb, cr, prep = _deblock_args(cuda, 52, mb_h, mb_w, cat=cat, bd=bd)
    f = _fmt(cat, bd)
    runs = [(intra_cuda.intra_frame(*args, mb_h, mb_w, f["ch_h"], f["mid"], f["mx"]),
             deblock_cuda.deblock_frame(y, cb, cr, prep, mb_h, mb_w, f["ch_h"], f["bd_scale"],
                                        f["mx"])) for _ in range(10)]
    torch.cuda.synchronize()
    for intra_out, db_out in runs[1:]:
        for a, b in zip(runs[0][0] + runs[0][1], intra_out + db_out):
            assert torch.equal(a, b)


def test_wrappers_refuse_bad_tensors(cuda):
    y = torch.zeros((64, 64), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        intra_cuda.intra_luma(y, y, y, 4, 4)
    with pytest.raises(ValueError, match="uint8"):
        deblock_cuda.deblock_luma(y, {}, 4, 4)
    # the deblock kernels move sample rows 16 (luma) and 8 (chroma) samples
    # at a time: 16 and 8 bytes at 8 bits
    off = torch.zeros(64 * 64 + 1, dtype=torch.uint8, device=cuda)[1:].view(64, 64)
    with pytest.raises(ValueError, match="16-byte"):
        deblock_cuda.deblock_luma(off, {}, 4, 4)
    offc = torch.zeros(32 * 32 + 1, dtype=torch.uint8, device=cuda)[1:].view(32, 32)
    with pytest.raises(ValueError, match="8-byte"):
        deblock_cuda.deblock_chroma(offc, offc, {}, 4, 4)
    # ... and 32 and 16 bytes at int16 (above 8 bits)
    i16 = dict(bd_scale=4, mx=1023)
    with pytest.raises(ValueError, match="int16"):
        deblock_cuda.deblock_luma(torch.zeros((64, 64), dtype=torch.uint8, device=cuda), {},
                                  4, 4, **i16)
    with pytest.raises(ValueError, match="uint8"):
        deblock_cuda.deblock_luma(torch.zeros((64, 64), dtype=torch.int16, device=cuda), {},
                                  4, 4)
    off16 = torch.zeros(64 * 64 + 8, dtype=torch.int16, device=cuda)[8:].view(64, 64)
    with pytest.raises(ValueError, match="32-byte"):
        deblock_cuda.deblock_luma(off16, {}, 4, 4, **i16)
    offc16 = torch.zeros(64 * 32 + 4, dtype=torch.int16, device=cuda)[4:].view(64, 32)
    with pytest.raises(ValueError, match="16-byte"):
        deblock_cuda.deblock_chroma(offc16, offc16, {}, 4, 4, ch_h=16, **i16)
    # formats the kernels do not take
    with pytest.raises(ValueError, match="bit depth"):
        deblock_cuda.deblock_luma(off16, {}, 4, 4, bd_scale=2, mx=1023)
    with pytest.raises(ValueError, match="chroma MB height"):
        deblock_cuda.deblock_chroma(offc16, offc16, {}, 4, 4, ch_h=12, **i16)
    z = torch.zeros((64, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bit depth"):
        intra_cuda.intra_luma(z, z, z, 4, 4, mid=512, mx=1000)
    with pytest.raises(ValueError, match="chroma MB height"):
        intra_cuda.intra_chroma(z, z, z, z, z, 4, 4, ch_h=4)
    # a 4:2:0-shaped chroma plane given as 4:2:2
    zc = torch.zeros((32, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=r"\(64, 32\)"):
        intra_cuda.intra_chroma(zc, zc, zc, zc, z, 4, 4, ch_h=16)


def _planes_intra_args(cuda, seed, planes, mb_h, mb_w, all_intra):
    """P planes of 8-bit 4:4:4 intra inputs sharing one set of MB modes."""
    rng = np.random.default_rng(seed + 100)
    a = _intra_inputs(seed, mb_h, mb_w, all_intra)
    H, W = 16 * mb_h, 16 * mb_w
    base = np.stack([a[0]] + [rng.integers(0, 256, (H, W)) for _ in range(planes - 1)])
    res = np.stack([a[3]] + [rng.integers(-40, 40, (H, W)) for _ in range(planes - 1)])
    T = lambda v: torch.as_tensor(np.asarray(v), device=cuda)  # noqa: E731
    return (T(base.astype(np.int32)), T(res.astype(np.int32)), T(a[6]), T(a[7]), T(a[8]),
            *(T(v) for v in a[10:]))


@pytest.mark.parametrize("planes", [1, 3])
@pytest.mark.parametrize("all_intra", [False, True])
@pytest.mark.parametrize("mb_h,mb_w", SHAPES)
def test_intra_planes_kernel_matches_plain(cuda, mb_h, mb_w, all_intra, planes):
    """The luma kernel over P planes in one launch (4:4:4's Y, Cb, Cr)
    against the plain version, intra_wavefront once per plane (run on the
    CPU, where its many small steps are quicker than on the card)."""
    args = _planes_intra_args(cuda, 71 + mb_h + mb_w, planes, mb_h, mb_w, all_intra)
    plain = intra_cuda.intra_planes_plain(*(a.cpu() for a in args), mb_h, mb_w)
    before = _launch_counts(("intra_luma",))
    out = intra_cuda.intra_planes(*args, mb_h, mb_w)
    torch.cuda.synchronize()
    assert out.shape == (planes, 16 * mb_h, 16 * mb_w)
    assert torch.equal(out.cpu(), plain)
    _assert_launched(before)


@pytest.mark.parametrize("planes", [1, 3])
@pytest.mark.parametrize("edges", ["prep", "top"])
@pytest.mark.parametrize("mb_h,mb_w", SHAPES)
def test_deblock_planes_kernel_matches_plain(cuda, mb_h, mb_w, edges, planes):
    """The luma filter over P planes in one launch, shared bS 0..4 and each
    plane's own indexA / indexB, against deblock_frame once per plane."""
    seed = 81 + mb_h + mb_w
    y, _, _, prep = _deblock_args(cuda, seed, mb_h, mb_w, edges)
    rng = np.random.default_rng(seed)
    H4, W4 = 4 * mb_h, 4 * mb_w
    preps, pl = [prep], [y]
    for _ in range(planes - 1):
        thr = {k: torch.as_tensor(rng.integers(10, 52, (H4, W4)).astype(np.int32), device=cuda)
               for k in ("ia_v", "ib_v", "ia_h", "ib_h")}
        preps.append({**prep, **thr})
        pl.append(torch.as_tensor(np.clip(128 + rng.integers(-12, 13, tuple(y.shape)), 0, 255)
                                  .astype(np.uint8), device=cuda))
    planes_t = torch.stack(pl)
    prep_p = {**prep, **{k: torch.stack([p[k] for p in preps])
                         for k in ("ia_v", "ib_v", "ia_h", "ib_h")}}
    plain = deblock_cuda.deblock_planes_plain(  # on the CPU, as above
        planes_t.cpu(), {k: v.cpu() for k, v in prep_p.items()}, mb_h, mb_w)
    before = _launch_counts(("deblock_luma",))
    out = deblock_cuda.deblock_planes(planes_t, prep_p, mb_h, mb_w)
    torch.cuda.synchronize()
    assert out.dtype == torch.uint8 and torch.equal(out.cpu(), plain)
    if mb_h * mb_w > 1:
        assert not torch.equal(out, planes_t)
    _assert_launched(before)


@pytest.mark.parametrize("mb_h,mb_w", [(9, 11), (140, 3)])
def test_planes_kernels_repeat_identically(cuda, mb_h, mb_w):
    """Three planes in one launch: 10 runs on one input give one output."""
    args = _planes_intra_args(cuda, 91, 3, mb_h, mb_w, True)
    y, _, _, prep = _deblock_args(cuda, 92, mb_h, mb_w, "top")
    planes_t = torch.stack([y, y.flip(0).contiguous(), y.flip(1).contiguous()])
    prep3 = {**prep, **{k: torch.stack([prep[k]] * 3) for k in ("ia_v", "ib_v", "ia_h", "ib_h")}}
    runs = [(intra_cuda.intra_planes(*args, mb_h, mb_w),
             deblock_cuda.deblock_planes(planes_t, prep3, mb_h, mb_w)) for _ in range(10)]
    torch.cuda.synchronize()
    for a, b in runs[1:]:
        assert torch.equal(a, runs[0][0]) and torch.equal(b, runs[0][1])


# the halo inputs of row-band sharding (dist/sharded.py): the intra kernels'
# row above MB row 0 and the deblock kernels' 4 rows above it, read back
HALO_SHAPES = [(4, 4), (1, 7), (9, 11), (140, 3)]


@pytest.mark.parametrize("cat,bd", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("mb_h,mb_w", HALO_SHAPES)
def test_intra_kernels_with_top_row_match_plain(cuda, mb_h, mb_w, cat, bd):
    args = _intra_args(cuda, 101 + mb_h + mb_w, mb_h, mb_w, True, cat, bd)
    f = _fmt(cat, bd)
    fmt = dict(ch_h=f["ch_h"], mid=f["mid"], mx=f["mx"])
    rng = np.random.default_rng(mb_h * mb_w)
    # an all-intra frame whose MB row 0 may read the row above: top, top-
    # right (but the last MB) and top-left (but the first) available
    avt, avtr, avtl = args[11:14]
    avt[:mb_w] = True
    avtr[: mb_w - 1] = True
    avtl[1:mb_w] = True
    top = [torch.as_tensor(rng.integers(0, f["mx"] + 1, n).astype(np.int32), device=cuda)
           for n in (16 * mb_w, 8 * mb_w, 8 * mb_w)]
    plain = t_intra.intra_wavefront(*args, mb_h, mb_w, **fmt, top=top)
    before = _launch_counts(("intra_luma_halo", "intra_chroma_halo"))  # the halo launches
    out = intra_cuda.intra_frame(*args, mb_h, mb_w, **fmt, top=top)
    torch.cuda.synchronize()
    for a, b in zip(plain, out):
        assert torch.equal(a, b)
    _assert_launched(before)
    assert not torch.equal(out[0], intra_cuda.intra_frame(*args, mb_h, mb_w, **fmt)[0])


@pytest.mark.parametrize("cat,bd", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("mb_h,mb_w", HALO_SHAPES)
def test_deblock_kernels_with_halo_match_plain(cuda, mb_h, mb_w, cat, bd):
    y, cb, cr, prep = _deblock_args(cuda, 111 + mb_h + mb_w, mb_h, mb_w, "top", cat, bd)
    f = _fmt(cat, bd)
    fmt = dict(ch_h=f["ch_h"], bd_scale=f["bd_scale"], mx=f["mx"])
    rng = np.random.default_rng(mb_h + 7 * mb_w)
    for k in ("bs_h", "bs_hc") if cat == 2 else ("bs_h",):  # MB row 0's top edge: bS 1..4
        prep[k] = prep[k].clone()
        prep[k][0] = torch.as_tensor(rng.integers(1, 5, 4 * mb_w).astype(np.int32), device=cuda)
    sh = bd - 8
    halo = [torch.as_tensor(np.clip((128 << sh) + rng.integers(-12 << sh, (12 << sh) + 1, (4, w)),
                                    0, f["mx"]), device=cuda).to(y.dtype)
            for w in (16 * mb_w, 8 * mb_w, 8 * mb_w)]
    (pl, ph) = t_db.deblock_frame(y, cb, cr, prep, mb_h, mb_w, **fmt, halo=halo)
    before = _launch_counts(("deblock_luma_halo", "deblock_chroma_halo"))
    out, oh = deblock_cuda.deblock_frame(y, cb, cr, prep, mb_h, mb_w, **fmt, halo=halo)
    torch.cuda.synchronize()
    for a, b in zip(pl + ph, out + oh):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert not torch.equal(oh[0], halo[0])  # the boundary edge filtered the halo
    _assert_launched(before)


def test_halo_wrappers_refuse_host_rows(cuda):
    """A CUDA plane never meets the plain version: halo rows left on the
    host raise instead."""
    args = _intra_args(cuda, 121, 2, 2)
    top = [torch.zeros(n, dtype=torch.int32) for n in (32, 16, 16)]
    with pytest.raises(ValueError, match="top"):
        intra_cuda.intra_frame(*args, 2, 2, top=top)
    y, cb, cr, prep = _deblock_args(cuda, 122, 2, 2)
    halo = [torch.zeros((4, w), dtype=torch.uint8) for w in (32, 16, 16)]
    with pytest.raises(ValueError, match="halo"):
        deblock_cuda.deblock_frame(y, cb, cr, prep, 2, 2, halo=halo)


# ---------------------------------------------------------------------------
# GpuDecoder's frame programs: frame_step captured once per signature in a
# CUDA graph (pipeline/frame_program.py) and replayed for every frame
# ---------------------------------------------------------------------------


def _committed(name):
    import json
    import os

    data = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "h264decode_tpu_torch", "data")
    with open(os.path.join(data, name), "rb") as f:
        bs = f.read()
    with open(os.path.join(data, "smoke_md5.json")) as f:
        return bs, json.load(f)[name]["frames"]


def _decode_md5s(device, bs, metrics=None):
    from chip_smoke import md5s
    from h264decode_tpu_torch.pipeline.gpu_pipeline import GpuDecoder

    with GpuDecoder(device=device, metrics=metrics) as dec:
        return [md5s(f.planes()) for f in dec.decode_stream(bs)]


@pytest.mark.parametrize("name", ["smoke_1080p_main_cabac.h264", "smoke_cif_high.h264"])
def test_graph_path_decodes_bit_exact_and_a_warm_decoder_captures_nothing(
        cuda, name, monkeypatch):
    """The first decoder captures one program per signature and replays a
    program for every frame (the frame that captured one too: its output
    is the replay's, the eager warm call's is dropped), bit-exact with
    libavcodec; a second decoder finds the programs the first returned and
    captures none."""
    from h264decode_tpu_torch.pipeline import frame_program
    from h264decode_tpu_torch.utils.metrics import DecodeMetrics

    monkeypatch.setattr(frame_program, "_idle", {})
    bs, want = _committed(name)
    cold, warm = DecodeMetrics(), DecodeMetrics()
    assert _decode_md5s(cuda, bs, cold) == want
    c = cold.counters
    assert c["graph_captures"] == c["program_keys"] >= 1
    assert c["graph_replays"] == len(want)
    assert _decode_md5s(cuda, bs, warm) == want
    w = warm.counters
    assert w["graph_captures"] == 0 and w["graph_replays"] == len(want)
    assert w["program_keys"] == c["program_keys"]


def test_two_decoders_on_two_threads_are_bit_exact(cuda, monkeypatch):
    """Two decoders of one geometry at the same time, each on its own thread
    with a RingSet of its own: their captures (thread-local capture mode,
    one at a time) and replays interleave, and both stay bit-exact."""
    import threading

    from h264decode_tpu_torch.pipeline import frame_program

    monkeypatch.setattr(frame_program, "_idle", {})
    bs, want = _committed("smoke_cif_high.h264")
    got, start = [None, None], threading.Barrier(2)

    def run(i):
        start.wait(timeout=60)
        got[i] = _decode_md5s(cuda, bs)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert got == [want, want]


def test_an_uncapturable_stage_raises_naming_the_key(cuda, monkeypatch):
    """A host synchronisation inside frame_step (a .item() in a stage) makes
    the capture fail: the decoder raises, naming the program's key and the
    call that the capture refused, and no frame comes back; nothing runs
    eagerly in its place."""
    from h264decode_tpu_torch.pipeline import frame_program, gpu_pipeline
    from h264decode_tpu_torch.pipeline.gpu_pipeline import GpuDecoder

    monkeypatch.setattr(frame_program, "_idle", {})
    orig = gpu_pipeline._deblock_prep

    def syncing(inp, *args, **kwargs):
        inp["qp"].sum().item()
        return orig(inp, *args, **kwargs)

    monkeypatch.setattr(gpu_pipeline, "_deblock_prep", syncing)
    bs, _ = _committed("smoke_cif_high.h264")
    got = []
    with pytest.raises(RuntimeError, match=r"frame program \(\(18, 22\).* capture failed at "
                                           r"test_torch_cuda\.py:\d+ \(inp.*\.item\(\)\)"):
        with GpuDecoder(device=cuda) as dec:
            got.extend(dec.decode_stream(bs))
    assert got == []


# ---------------------------------------------------------------------------
# the row-band sharded step's band programs (dist/sharded.py): captured once
# per band and signature in CUDA graphs, with the halo kernels inside, and
# replayed for every frame, on meshes that repeat cuda:0
# ---------------------------------------------------------------------------

ROW_KERNELS = ("intra_luma", "intra_chroma", "deblock_luma", "deblock_chroma")
# stream -> the mode every frame of it takes on a 1x2 mesh
SHARDED_STREAMS = {"halo": "smoke_cif_high.h264", "aligned": "smoke_cif_main_slices2_nodb.h264"}


def _sharded_md5s(mesh, bs, metrics=None):
    from chip_smoke import md5s
    from h264decode_tpu_torch.dist.decoder import ShardedDecoder

    dec = ShardedDecoder(mesh, metrics=metrics)
    try:
        return [md5s(f.planes()) for f in dec.decode_stream(bs)], dict(dec.modes)
    finally:
        dec.close()


@pytest.mark.parametrize("mode", sorted(SHARDED_STREAMS))
def test_sharded_programs_bit_exact_and_a_warm_decoder_captures_nothing(cuda, mode,
                                                                         monkeypatch):
    """ShardedDecoder on a 1x2 mesh of the card: the first decoder captures
    every band program of each signature (a base and a recon program a band
    in halo mode, one a band when aligned) and replays them for every frame;
    the frames equal the same decoder's on a 1x2 mesh of the CPU (the plain
    kernels, run eagerly) and libavcodec's committed MD5s. A second
    decoder captures nothing and replays every program of every frame, and
    the wrappers' counters (counted at capture, added per replay) equal
    what the eager step counted: band 0 launches each kernel without halo
    rows, band 1 with them (`*_halo`), one device kernel a call; when
    aligned, both bands launch them without."""
    from h264decode_tpu_torch.dist import sharded
    from h264decode_tpu_torch.dist.mesh import make_mesh
    from h264decode_tpu_torch.utils.metrics import DecodeMetrics

    monkeypatch.setattr(sharded, "_idle", {})
    bs, want = _committed(SHARDED_STREAMS[mode])
    mesh = make_mesh(1, 2, devices=[cuda, cuda])
    per_frame = 4 if mode == "halo" else 2
    cold, warm = DecodeMetrics(), DecodeMetrics()
    cpu = torch.device("cpu")
    assert _sharded_md5s(make_mesh(1, 2, devices=[cpu, cpu]), bs) == (want, {mode: len(want)})
    assert _sharded_md5s(mesh, bs, cold) == (want, {mode: len(want)})
    c = cold.counters
    assert c["graph_captures"] == per_frame * c["program_keys"] >= per_frame
    assert c["graph_replays"] == per_frame * len(want)
    halo_names = tuple(k + "_halo" for k in ROW_KERNELS)
    before = _launch_counts(ROW_KERNELS + halo_names)
    assert _sharded_md5s(mesh, bs, warm) == (want, {mode: len(want)})
    w = warm.counters
    assert w["graph_captures"] == 0 and w["graph_replays"] == per_frame * len(want)
    assert w["program_keys"] == c["program_keys"]
    after = _launch_counts(ROW_KERNELS + halo_names)
    got = {k: tuple(a - b for a, b in zip(after[k], before[k])) for k in after}
    n = len(want)
    expect = {k: (n, n) if mode == "halo" else (2 * n, 2 * n) for k in ROW_KERNELS}
    expect.update({k: (n, n) if mode == "halo" else (0, 0) for k in halo_names})
    assert got == expect


def test_an_uncapturable_band_stage_raises_naming_the_key(cuda, monkeypatch):
    """A host synchronisation inside a band program (a .item() in the base
    stage) makes its capture fail: the decoder raises, naming the program
    and its key and the refused call, returns no frame and never runs the
    stage eagerly in its place; the set is not reused."""
    from h264decode_tpu_torch.dist import sharded
    from h264decode_tpu_torch.dist.mesh import make_mesh

    monkeypatch.setattr(sharded, "_idle", {})
    orig = sharded._band_base

    def syncing(loc, *args, **kwargs):
        loc["qp"].sum().item()
        return orig(loc, *args, **kwargs)

    monkeypatch.setattr(sharded, "_band_base", syncing)
    bs, _ = _committed("smoke_cif_high.h264")
    got = []
    with pytest.raises(RuntimeError, match=r"sharded program \('base', band 0\) \(\(device.* "
                                           r"capture failed at test_torch_cuda\.py:\d+ "
                                           r"\(loc.*\.item\(\)\)"):
        got.extend(_sharded_md5s(make_mesh(1, 2, devices=[cuda, cuda]), bs)[0])
    assert got == [] and sharded._idle == {}
