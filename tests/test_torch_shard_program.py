"""The row-band sharded step as programs (dist/sharded.py) on the CPU.

On a CPU mesh a ShardSet runs the band functions eagerly on its static
buffers (the captured graphs are tested on the card, tests/test_torch_cuda.py):
the port's ShardedDecoder on a 1x2 mesh against the JAX ShardedDecoder on
a 1x2 mesh of the conftest's virtual CPU devices and against libavcodec
(tolerance 0: integer samples), the signature (the JAX jit cache key), one
program per band and signature, and the process-wide ShardSet cache."""

import numpy as np
import pytest
import torch

from h264decode_tpu.dist.decoder import ShardedDecoder as JaxShardedDecoder
from h264decode_tpu.dist.mesh import make_mesh as jax_make_mesh
from h264decode_tpu_torch.dist import sharded
from h264decode_tpu_torch.dist.decoder import ShardedDecoder
from h264decode_tpu_torch.dist.gop import GopParallelDecoder
from h264decode_tpu_torch.dist.mesh import make_mesh
from h264decode_tpu_torch.golden import lavc
from h264decode_tpu_torch.utils.metrics import DecodeMetrics
from tests.conftest import make_test_frames

torch.set_num_threads(1)

CPU = torch.device("cpu")


def cpu_mesh(n_gop: int, n_row: int):
    return make_mesh(n_gop, n_row, devices=[CPU] * (n_gop * n_row))


def planes(frames):
    return [[np.asarray(p) for p in f.planes()] for f in frames]


def assert_same(got, want):
    assert len(got) == len(want)
    for fi, (o, w) in enumerate(zip(got, want)):
        for c in range(3):
            np.testing.assert_array_equal(o[c], w[c], err_msg=f"frame {fi} plane {c}")


def halo_stream() -> bytes:
    """64x64 Main CABAC, 4 frames, 2 B-frames, one slice, deblocking on:
    only the halo mode is exact on a 1x2 mesh."""
    return lavc.encode_x264(make_test_frames(4, 64, 64, seed=31), qp=26, profile="main",
                            cabac=True, bframes=2)


def aligned_stream() -> bytes:
    """Two slices of two MB rows each, deblocking off: aligned on 1x2."""
    return lavc.encode_x264(make_test_frames(3, 64, 64, seed=32), qp=26, profile="main",
                            cabac=True, bframes=0, extra_x264="slices=2:no-deblock=1")


def test_programs_match_jax_sharded_decoder_and_libavcodec():
    """The port's ShardedDecoder (1x2, halo mode, through the band programs
    on their static buffers) equals the JAX ShardedDecoder on a 1x2 mesh of
    virtual CPU devices frame for frame, and libavcodec."""
    bs = halo_stream()
    m = DecodeMetrics()
    dec = ShardedDecoder(cpu_mesh(1, 2), metrics=m)
    ours = planes(dec.decode_stream(bs))
    dec.close()
    assert dict(dec.modes) == {"halo": 4}
    assert m.timer_calls["dispatch"] == 4 and m.counters["program_keys"] >= 1
    assert "graph_captures" not in m.counters  # no graph on the CPU
    jax_dec = JaxShardedDecoder(jax_make_mesh(1, 2), apply_deblock=True)
    theirs = planes(jax_dec.decode_stream(bs))
    golden = planes(lavc.decode_annexb(bs))
    assert len(ours) == 4
    assert_same(ours, theirs)
    assert_same(ours, golden)


def _sig_args():
    rng = np.random.default_rng(0)
    inp = {"qp": rng.integers(0, 52, 8).astype(np.int8),
           "luma_ac": rng.integers(-9, 9, (8, 16, 16)).astype(np.int16),
           "ref_luma_raw": np.zeros((2, 32, 64), np.uint8),
           "w_tab": np.full((1, 2, 16), 32, np.int16),
           "db_bs_v": np.zeros((8, 16), np.int8)}
    return dict(inp=inp, devices=(CPU, CPU), mb_h=2, mb_w=4, apply_deblock=True,
                qp_offsets=(0, 0), halo=True, has_pcm=False)


def test_signature_ignores_values():
    a = _sig_args()
    b = dict(a, inp={k: v + 1 for k, v in a["inp"].items()}, qp_offsets=[0, 0])
    assert sharded.signature(**a) == sharded.signature(**b)


@pytest.mark.parametrize("change", ["geometry", "devices", "halo", "apply_deblock", "has_pcm",
                                    "qp_offsets", "n_refs", "s_pad", "r_w", "dtype", "key"])
def test_signature_changes_with_what_jax_retraces_on(change):
    args = _sig_args()
    key = sharded.signature(**args)
    inp = dict(args["inp"])
    if change == "geometry":
        args["mb_w"] += 1
    elif change == "devices":
        args["devices"] = (CPU, CPU, CPU)
    elif change in ("halo", "apply_deblock", "has_pcm"):
        args[change] = not args[change]
    elif change == "qp_offsets":
        args["qp_offsets"] = (0, 2)
    elif change == "n_refs":
        inp["ref_luma_raw"] = np.zeros((3, 32, 64), np.uint8)
    elif change == "s_pad":  # more slices in the picture
        inp["w_tab"] = np.full((2, 2, 16), 32, np.int16)
    elif change == "r_w":  # longer reference lists
        inp["w_tab"] = np.full((1, 2, 32), 32, np.int16)
    elif change == "dtype":
        inp["qp"] = inp["qp"].astype(np.int16)
    else:  # a frame without deblocking grids
        del inp["db_bs_v"]
    args["inp"] = inp
    assert sharded.signature(**args) != key


def _spied(monkeypatch):
    monkeypatch.setattr(sharded, "_idle", {})
    seen = []
    orig = sharded.signature

    def spy(*args):
        seen.append(orig(*args))
        return seen[-1]

    monkeypatch.setattr(sharded, "signature", spy)
    return seen


@pytest.mark.parametrize("mode", ["halo", "aligned"])
def test_one_program_per_band_and_signature(mode, monkeypatch):
    """Every frame goes through the programs of its signature, and a set
    holds one step per distinct signature with one program per band and
    stage: a base and a recon program a band in halo mode, one a band when
    aligned; bit-exact with libavcodec."""
    seen = _spied(monkeypatch)
    bs = halo_stream() if mode == "halo" else aligned_stream()
    m = DecodeMetrics()
    dec = ShardedDecoder(cpu_mesh(1, 2), metrics=m)
    frames = dec.decode_stream(bs)
    ss = dec._set
    dec.close()
    assert_same(planes(frames), planes(lavc.decode_annexb(bs)))
    assert dict(dec.modes) == {mode: len(frames)}
    assert len(seen) == len(frames) and set(ss.steps) == set(seen)
    assert m.counters["program_keys"] == len(set(seen))
    assert m.timer_calls["dispatch"] == len(frames)
    stages = ("base", "recon") if mode == "halo" else ("band",)
    for st in ss.steps.values():
        assert set(st.programs) == {(s, r) for s in stages for r in range(2)}
        assert all(p.graph is None for p in st.programs.values())  # eager on the CPU


def test_closed_decoder_returns_its_shard_set(monkeypatch):
    """A decoder after close() checks out the set the first one returned,
    steps included (a stream it decoded adds none); a decoder open at the
    same time as another of its row and geometry gets a set of its own, and
    the cache keeps both; a set whose capture failed is let go."""
    monkeypatch.setattr(sharded, "_idle", {})
    bs = aligned_stream()
    mesh = cpu_mesh(1, 2)
    first = ShardedDecoder(mesh)
    want = planes(first.decode_stream(bs))
    ss = first._set
    first.close()
    assert first._set is None and sharded._idle == {((CPU, CPU), (4, 4)): [ss]}
    n = len(ss.steps)
    second, other = ShardedDecoder(mesh), ShardedDecoder(mesh)
    assert_same(planes(second.decode_stream(bs)), want)
    assert second._set is ss and len(ss.steps) == n
    assert_same(planes(other.decode_stream(bs)), want)
    own = other._set
    assert own is not ss
    other.close()
    second.close()
    assert [id(s) for s in sharded._idle[((CPU, CPU), (4, 4))]] == [id(own), id(ss)]
    failed = sharded.checkout((CPU, CPU), (4, 4))
    failed.failure = RuntimeError("capture refused")
    with pytest.raises(RuntimeError, match="an earlier capture .* capture refused"):
        failed.check()
    sharded.checkin(failed)
    assert failed not in sharded._idle[((CPU, CPU), (4, 4))]


def test_gop_slots_of_one_device_take_distinct_sets(monkeypatch):
    """Two gop slots on one device and geometry each take a set of their
    own and return it when their thread ends; a second GOP decode finds
    both and adds no step."""
    monkeypatch.setattr(sharded, "_idle", {})
    bs = lavc.encode_x264(make_test_frames(4, 64, 64, seed=33), qp=26, profile="main",
                          cabac=True, bframes=0, gop=2,
                          extra_x264="keyint=2:min-keyint=2:scenecut=0")
    mesh = cpu_mesh(2, 1)
    want = planes(lavc.decode_annexb(bs))
    assert_same(planes(GopParallelDecoder(mesh).decode_stream(bs)), want)
    sets = sharded._idle[((CPU,), (4, 4))]
    assert len(sets) == 2 and sets[0] is not sets[1]
    steps = {id(s): len(s.steps) for s in sets}
    assert_same(planes(GopParallelDecoder(mesh).decode_stream(bs)), want)
    after = sharded._idle[((CPU,), (4, 4))]
    assert {id(s) for s in after} == set(steps)
    assert {id(s): len(s.steps) for s in after} == steps
