"""The port's multi-device path (h264decode_tpu_torch/dist/) on the CPU.

Meshes repeat torch.device("cpu") (the counterpart of the JAX tests'
virtual CPU devices), so the band split, the reference all-gather and the
halo exchange run for real, through the plain versions of the kernels.
Every comparison is bit-exact (tolerance 0): the plain kernels' halo inputs
against the JAX functions, and every decode against libavcodec and
GpuDecoder(device="cpu"). The JAX ShardedDecoder comparison stays in
tests/test_dist.py, gated by H264_TPU_TESTS.
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264decode_tpu.kernels import deblock as j_db
from h264decode_tpu.kernels import intra as j_intra
from h264decode_tpu_torch.cli.main import main as cli_main
from h264decode_tpu_torch.dist.decoder import ShardedDecoder
from h264decode_tpu_torch.dist.gop import GopParallelDecoder, split_gops
from h264decode_tpu_torch.dist.mesh import make_mesh
from h264decode_tpu_torch.golden import lavc
from h264decode_tpu_torch.kernels import deblock as t_db
from h264decode_tpu_torch.kernels import intra as t_intra
from h264decode_tpu_torch.pipeline.gpu_pipeline import GpuDecoder
from chip_smoke import md5s, y4m_md5s
from tests.conftest import make_test_frames
from tests.test_mono import make_gray_frames
from tests.test_torch_cuda import _intra_inputs, _prep_inputs
from tests.test_torch_kernels import _prep_both

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def cpu_mesh(n_gop: int, n_row: int):
    return make_mesh(n_gop, n_row, devices=[CPU] * (n_gop * n_row))


def assert_same_frames(want, got):
    assert len(want) == len(got)
    for fi, (g, o) in enumerate(zip(want, got)):
        for name, gp, op in zip("y cb cr".split(), g.planes(), o.planes()):
            gp, op = np.asarray(gp), np.asarray(op)
            if gp.size == 0:  # monochrome: libavcodec returns no chroma
                assert (op == 128).all(), (fi, name)
                continue
            assert np.array_equal(gp, op), (fi, name)


# ---------------------------------------------------------------------------
# the plain kernels' halo inputs against the JAX functions


def test_intra_wavefront_top_matches_jax():
    """A given row above MB row 0 (every MB kind and mode, random
    availability, random top samples) seeds intra exactly as the JAX
    wavefront's `top` does."""
    mb_h, mb_w = 2, 4
    args = _intra_inputs(61, mb_h, mb_w)
    rng = np.random.default_rng(62)
    top = [rng.integers(0, 256, n).astype(np.int32) for n in (16 * mb_w, 8 * mb_w, 8 * mb_w)]
    jo = j_intra.intra_wavefront(*(jnp.asarray(a) for a in args), mb_h, mb_w,
                                 top=tuple(jnp.asarray(t) for t in top))
    to = t_intra.intra_wavefront(*(torch.as_tensor(a) for a in args), mb_h, mb_w,
                                 top=tuple(torch.as_tensor(t) for t in top))
    for j, t in zip(jo, to):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    plain = t_intra.intra_wavefront(*(torch.as_tensor(a) for a in args), mb_h, mb_w)
    assert any(not torch.equal(a, b) for a, b in zip(plain, to))  # the row was read


def test_deblock_frame_halo_matches_jax():
    """Halo rows in, MB row 0's top edges filtered against them (bS 0..4 on
    that edge), the modified halo rows out, as JAX deblock_frame_tpu(halo=)."""
    mb_h, mb_w = 2, 4
    p = _prep_inputs(63, mb_h, mb_w)
    jp, tp = _prep_both(p, mb_h, mb_w)
    rng = np.random.default_rng(64)
    edge = rng.integers(0, 5, 4 * mb_w).astype(np.int32)  # bS of MB row 0's top edge
    assert set(edge) == {0, 1, 2, 3, 4}
    jp["bs_h"] = jp["bs_h"].at[0].set(jnp.asarray(edge))
    tp["bs_h"] = tp["bs_h"].clone()
    tp["bs_h"][0] = torch.as_tensor(edge)

    def plane(h, w):
        return np.clip(128 + rng.integers(-12, 13, (h, w)), 0, 255).astype(np.uint8)

    y, cb, cr = plane(16 * mb_h, 16 * mb_w), plane(8 * mb_h, 8 * mb_w), plane(8 * mb_h, 8 * mb_w)
    halo = (plane(4, 16 * mb_w), plane(4, 8 * mb_w), plane(4, 8 * mb_w))
    (jy, jcb, jcr), jh = j_db.deblock_frame_tpu(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), jp, mb_h, mb_w,
        halo=tuple(jnp.asarray(h) for h in halo))
    T = torch.as_tensor
    (ty, tcb, tcr), th = t_db.deblock_frame(T(y), T(cb), T(cr), tp, mb_h, mb_w,
                                            halo=tuple(T(h) for h in halo))
    for j, t in zip((jy, jcb, jcr, *jh), (ty, tcb, tcr, *th)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    # the boundary edge changed rows of the halo: the last 3 luma and the
    # last chroma row, nothing above them
    changed = [(np.asarray(j) != h).any(axis=1) for j, h in zip(jh, halo)]
    assert changed[0][1:].any() and not changed[0][0]
    assert not changed[1][:3].any() and not changed[2][:3].any()
    assert changed[1][3] or changed[2][3]


def test_expand_slot_mv_matches_jax():
    """The compact per-MB motion of the sharded wire, expanded to cells."""
    from h264decode_tpu.kernels.deblock_prep_dev import expand_slot_mv as j_expand
    from h264decode_tpu_torch.kernels.deblock_prep_dev import expand_slot_mv

    mb_h, mb_w = 2, 3
    rng = np.random.default_rng(65)
    n = mb_h * mb_w
    slot = rng.integers(-1, 4, (n, 2, 4)).astype(np.int8)
    mv = rng.integers(-300, 300, (n, 2, 16, 2)).astype(np.int16)
    intra = rng.random(n) < 0.3
    want = j_expand(jnp.asarray(slot), jnp.asarray(mv), jnp.asarray(intra), mb_h, mb_w)
    got = expand_slot_mv(torch.as_tensor(slot), torch.as_tensor(mv), torch.as_tensor(intra),
                         mb_h, mb_w)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


# ---------------------------------------------------------------------------
# ShardedDecoder

FRAMES = make_test_frames(4, 64, 64, seed=21)

# name -> (x264 options, n_row, apply_deblock, the mode every frame takes)
SHARDED = {
    # slice-per-band CABAC IP: the band-local mode
    "aligned_1x2": (dict(bframes=0, extra_x264="no-deblock=1:slices=2:weightp=0"), 2, False,
                    "aligned"),
    "aligned_1x4": (dict(bframes=0, extra_x264="no-deblock=1:slices=4:weightp=0"), 4, False,
                    "aligned"),
    # explicit weighted P and implicit weighted B, still slice-aligned
    "aligned_weighted": (dict(bframes=2, extra_x264="slices=2:weightp=2:weightb=1:no-deblock=1"),
                         2, False, "aligned"),
    # single slice, deblocking on: only the halo pipeline is exact
    "halo_2band": (dict(bframes=2), 2, True, "halo"),
    "halo_4band_weighted": (dict(bframes=2, extra_x264="weightp=2:weightb=1"), 4, True, "halo"),
}


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_decoder_matches_libavcodec(name):
    opts, n_row, deblock, mode = SHARDED[name]
    bs = lavc.encode_x264(FRAMES, qp=26, profile="main", cabac=True, **opts)
    dec = ShardedDecoder(cpu_mesh(1, n_row), apply_deblock=deblock)
    ours = dec.decode_stream(bs)
    dec.close()
    assert dict(dec.modes) == {mode: len(FRAMES)}
    assert_same_frames(lavc.decode_annexb(bs), ours)
    with GpuDecoder(apply_deblock=deblock, device="cpu") as single:
        assert_same_frames(single.decode_stream(bs), ours)


def test_sharded_decoder_monochrome():
    """Monochrome rides the 4:2:0 step (mid-gray chroma), in halo mode."""
    bs = lavc.encode_x264(make_gray_frames(4, 64, 64), qp=26, profile="high", csp="gray",
                          cabac=True, bframes=2)
    dec = ShardedDecoder(cpu_mesh(1, 2))
    ours = dec.decode_stream(bs)
    assert dict(dec.modes) == {"halo": 4}
    assert_same_frames(lavc.decode_annexb(bs), ours)
    with GpuDecoder(device="cpu") as single:
        assert_same_frames(single.decode_stream(bs), ours)


def test_sharded_decoder_pcm():
    """I_PCM macroblocks (a synthetic CAVLC stream) through the PCM planes of
    the band step."""
    from tests.synth import pcm_frame_planes, pcm_slice, write_pps, write_sps

    mb_w, mb_h = 4, 4
    planes = pcm_frame_planes(mb_w, mb_h, seed=9)
    data = write_sps(mb_w, mb_h) + write_pps() + pcm_slice(
        planes, list(range(mb_w * mb_h)), mb_w)
    dec = ShardedDecoder(cpu_mesh(1, 2))
    out = dec.decode_stream(data)
    assert dict(dec.modes) == {"halo": 1}
    for want, got in zip(planes, out[0].planes()):
        assert np.array_equal(want, np.asarray(got))


def test_sharded_decoder_routes_other_formats_to_the_oracle():
    """4:2:2 is not a sharded format (JAX dist/decoder.py:62-83): it
    decodes on the numpy oracle, bit-exact, and no frame takes a mode."""
    frames = [(y, np.repeat(cb, 2, 0), np.repeat(cr, 2, 0)) for y, cb, cr in FRAMES[:2]]
    bs = lavc.encode_x264(frames, qp=26, profile="high422", csp="yuv422p", cabac=True,
                          bframes=0)
    dec = ShardedDecoder(cpu_mesh(1, 2))
    ours = dec.decode_stream(bs)
    assert not dec.modes
    assert_same_frames(lavc.decode_annexb(bs), ours)


# ---------------------------------------------------------------------------
# GopParallelDecoder, multihost, mesh and CLI


def gop_stream(n_frames: int, seed: int, keyint: int, **kw) -> bytes:
    return lavc.encode_x264(
        make_test_frames(n_frames, 64, 64, seed=seed), qp=26, profile="main", cabac=True,
        gop=keyint, extra_x264=f"keyint={keyint}:min-keyint={keyint}:scenecut=0" + kw.pop(
            "extra", ""), **kw)


def test_gop_parallel_decoder_2x2_unbalanced():
    """5 GOPs of 4 frames round-robin over 2 slots (3 and 2 GOPs): each slot
    thread decodes its own GOPs, one slot ends a GOP before the other, and
    weighted P/B; stream order restored."""
    bs = gop_stream(20, 2, 4, bframes=2, extra=":weightp=2:weightb=1")
    segs = split_gops(bs)
    assert len(segs) == 5 and all(n == 4 for _, n in segs), segs
    dec = GopParallelDecoder(cpu_mesh(2, 2))
    ours = dec.decode_stream(bs)
    assert dict(dec.modes) == {"halo": 20}
    assert_same_frames(lavc.decode_annexb(bs), ours)


def test_gop_parallel_decoder_slots_of_two_frame_sizes():
    """A 64x64 GOP and a 32x48 one (a new SPS) on two slots of a 2x2 mesh:
    no step spans both slots, so each decodes its own size."""
    parts = [lavc.encode_x264(make_test_frames(3, h, w, seed=7), qp=26, profile="main",
                              cabac=True, bframes=1) for h, w in ((64, 64), (32, 48))]
    ours = GopParallelDecoder(cpu_mesh(2, 2)).decode_stream(b"".join(parts))
    want = [f for p in parts for f in lavc.decode_annexb(p)]
    assert [f.planes()[0].shape for f in ours] == [(64, 64)] * 3 + [(32, 48)] * 3
    assert_same_frames(want, ours)


def _weighted_pps() -> bytes:
    """tests/synth.py's CAVLC PPS with weighted_pred_flag set."""
    from tests.synth import BitWriter, nal

    w = BitWriter()
    w.ue(0)  # pic_parameter_set_id
    w.ue(0)  # seq_parameter_set_id
    w.flag(False)  # entropy_coding_mode_flag
    w.flag(False)  # bottom_field_pic_order_in_frame_present_flag
    w.ue(0)  # num_slice_groups_minus1
    w.ue(0)  # num_ref_idx_l0_default_active_minus1
    w.ue(0)  # num_ref_idx_l1_default_active_minus1
    w.flag(True)  # weighted_pred_flag
    w.u(2, 0)  # weighted_bipred_idc
    w.se(0)  # pic_init_qp_minus26
    w.se(0)  # pic_init_qs_minus26
    w.se(0)  # chroma_qp_index_offset
    w.flag(True)  # deblocking_filter_control_present_flag
    w.flag(False)  # constrained_intra_pred_flag
    w.flag(False)  # redundant_pic_cnt_present_flag
    w.trailing_bits()
    return nal(8, 3, w.rbsp())


def _weighted_skip_slice(first_mb: int, n_mbs: int, frame_num: int, poc_lsb: int,
                         wts) -> bytes:
    """A non-reference P slice of n_mbs skipped MBs whose explicit weights
    for RefPicList0[0] are wts = (luma w, o, Cb w, o, Cr w, o), denominator
    32 (7.3.3.2)."""
    from tests.synth import BitWriter, nal

    w = BitWriter()
    w.ue(first_mb)
    w.ue(5)  # slice_type: P, every slice of the picture
    w.ue(0)  # pic_parameter_set_id
    w.u(4, frame_num)
    w.u(6, poc_lsb)
    w.flag(False)  # num_ref_idx_active_override_flag
    w.flag(False)  # ref_pic_list_modification_flag_l0
    w.ue(5)  # luma_log2_weight_denom
    w.ue(5)  # chroma_log2_weight_denom
    w.flag(True)  # luma_weight_l0_flag
    w.se(wts[0])
    w.se(wts[1])
    w.flag(True)  # chroma_weight_l0_flag
    for v in wts[2:]:
        w.se(v)
    w.se(0)  # slice_qp_delta
    w.ue(1)  # disable_deblocking_filter_idc
    w.ue(n_mbs)  # mb_skip_run over the whole slice
    w.trailing_bits()
    return nal(1, 0, w.rbsp())


def test_gop_parallel_decoder_weighted_slices():
    """Two GOPs (a PCM IDR, then two P pictures of 10 skip slices, every
    slice with weights of its own) on a 2x2 mesh: each slice reads its own
    weight table, past the 8th slice too."""
    from tests.synth import pcm_frame_planes, pcm_slice, write_sps

    mb_w = mb_h = 4
    sizes = [2, 2, 2, 2, 2, 2, 1, 1, 1, 1]
    rng = np.random.default_rng(66)
    data = write_sps(mb_w, mb_h) + _weighted_pps()
    for gop in range(2):
        planes = pcm_frame_planes(mb_w, mb_h, seed=10 + gop)
        data += pcm_slice(planes, list(range(mb_w * mb_h)), mb_w)
        for p in range(2):
            first = 0
            for n in sizes:
                wts = [int(v) for v in rng.integers((16, -20) * 3, (56, 21) * 3)]
                data += _weighted_skip_slice(first, n, 1, 2 + 2 * p, wts)
                first += n
    dec = GopParallelDecoder(cpu_mesh(2, 2))
    ours = dec.decode_stream(data)
    assert dict(dec.modes) == {"halo": 6}  # slices start inside the bands
    assert_same_frames(lavc.decode_annexb(data), ours)


_MH_WORKER = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from h264decode_tpu_torch.dist import multihost
pid, path, port = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(f"127.0.0.1:{port}", 2, pid, device="cpu", timeout_s=100)
from h264decode_tpu_torch.dist.gop import GopParallelDecoder, split_gops
from h264decode_tpu_torch.golden import lavc

data = open(path, "rb").read()
mesh = multihost.make_global_mesh(n_row=2, devices=["cpu", "cpu"])  # 2 procs x 2 -> 2x2
assert mesh.shape == {"gop": 2, "row": 2}
dec = GopParallelDecoder(mesh, multihost=True)
frames = dec.decode_stream(data)
golden = lavc.decode_annexb(data)
segs = split_gops(data)
starts = np.cumsum([0] + [n for _, n in segs])
idx = checked = 0
for j, (_, n) in enumerate(segs):
    if dec.g0 <= j % 2 < dec.g0 + dec.g_local:
        for g, o in zip(golden[starts[j] : starts[j] + n], frames[idx : idx + n]):
            for gp, op in zip(g.planes(), o.planes()):
                assert np.array_equal(gp, np.asarray(op)), (pid, j)
            checked += 1
        idx += n
assert idx == len(frames) and checked > 0
multihost.coordination_barrier("h264_mh_done")
multihost.shutdown()
print("MH_OK", pid, checked, flush=True)
"""


def test_multihost_two_gloo_processes(tmp_path):
    """Two processes over gloo on loopback form a 2x2 global mesh whose gop
    axis spans them; each decodes its own GOPs of a 4-GOP stream and checks
    them bit-exact. A run that does not finish within 120 s is killed and
    retried once on a fresh port; then the test fails."""
    path = tmp_path / "s.264"
    path.write_bytes(gop_stream(8, 4, 2, bframes=0))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")

    def attempt():
        with socket.socket() as s:  # a free port for the store
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, "-c", _MH_WORKER, str(i), str(path),
                                   str(port)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for i in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append((p.communicate(timeout=120)[0], p.returncode))
        except subprocess.TimeoutExpired:
            outs.append(("timed out after 120 s", None))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return outs

    outs = attempt()
    if not (len(outs) == 2 and all("MH_OK" in o and rc == 0 for o, rc in outs)):
        outs = attempt()
    assert len(outs) == 2, outs
    for out, rc in outs:
        assert "MH_OK" in out and rc == 0, outs


def test_make_mesh_factoring_and_devices(monkeypatch):
    """The JAX factoring rule (rows first, by powers of two), explicit
    repeated devices, and no silent CPU fallback."""
    assert make_mesh(devices=[CPU] * 8).shape == {"gop": 1, "row": 8}
    assert make_mesh(devices=[CPU] * 6).shape == {"gop": 3, "row": 2}
    m = make_mesh(2, 1, devices=[CPU] * 3)
    assert m.shape == {"gop": 2, "row": 1} and m.row(1) == (CPU,)
    with pytest.raises(AssertionError, match="mesh 2x2 > 3 devices"):
        make_mesh(2, 2, devices=[CPU] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 1)


@pytest.mark.parametrize("backend", ["sharded", "gop"])
def test_cli_mesh_refuses_one_named_device(tmp_path, backend):
    """The mesh takes every visible card or the CPU: `--device cuda:1` would
    not be the mesh's device, so it is refused rather than ignored."""
    src = tmp_path / "in.264"
    src.write_bytes(b"")
    with pytest.raises(ValueError, match="--device cuda:1"):
        cli_main(["decode", str(src), str(tmp_path / "out.y4m"), "--backend", backend,
                  "--device", "cuda:1"])


@pytest.mark.parametrize("backend,mesh", [("sharded", "1x2"), ("gop", "2x1")])
def test_cli_multi_device_backends(tmp_path, backend, mesh):
    """`decode --backend sharded|gop --mesh GxR --device cpu`: the Y4M equals
    libavcodec's frames."""
    bs = gop_stream(6, 5, 3, bframes=1)
    src, out = tmp_path / "in.264", tmp_path / "out.y4m"
    src.write_bytes(bs)
    assert cli_main(["decode", str(src), str(out), "--backend", backend, "--mesh", mesh,
                     "--device", "cpu"]) == 0
    want = dict(width=64, height=64, bit_depth=8, chroma="420")
    assert y4m_md5s(str(out), want) == [md5s(g.planes()) for g in lavc.decode_annexb(bs)]
