"""frame_step as one program per signature (pipeline/frame_program.py) on
the CPU: the ring slot as a 0-d tensor against the int slot and the JAX
frame_step (tolerance 0: integer samples), the signature (the JAX jit
cache key), GpuDecoder(device="cpu") through the programs on committed
streams, and the process-wide RingSet cache. On the CPU a program runs
frame_step eagerly on its static buffers; the captured graphs are tested
on the card (tests/test_torch_cuda.py)."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from h264decode_tpu.golden import lavc
from h264decode_tpu.pipeline import tpu_pipeline
from h264decode_tpu_torch import convert
from h264decode_tpu_torch.pipeline import frame_program
from h264decode_tpu_torch.pipeline import gpu_pipeline
from h264decode_tpu_torch.pipeline.gpu_pipeline import GpuDecoder
from h264decode_tpu_torch.utils.metrics import DecodeMetrics
from chip_smoke import md5s
from tests.conftest import make_test_frames
from tests.test_torch_pipeline import _record_jax_frame_steps, fade_frames

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "h264decode_tpu_torch", "data")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_frames():
    """Every JAX frame_step call of a QCIF-sized weighted Main stream (I, P,
    P): wire, rings, dyn, mb_h, mb_w, flags, outputs (rings..., packed)."""
    bs = lavc.encode_x264(fade_frames(3, 64, 64), qp=26, profile="main", cabac=True,
                          bframes=0, extra_x264="weightp=2")
    with pytest.MonkeyPatch.context() as mp:
        calls = _record_jax_frame_steps(mp)
        tpu_pipeline.TpuDecoder().decode_stream(bs)
    assert len(calls) == 3
    return calls


def _port_args(call):
    """(port wire, port dyn, rings, mb_h, mb_w, port flags, slot, JAX packed,
    JAX output rings) of a recorded 8-bit 4:2:0 JAX frame."""
    wire, rings, dyn, mb_h, mb_w, flags, jout = call
    has_l8, has_pcm, apply_db, sparse, cf3, has_intra, cf2, bd, need_s2 = flags
    assert not cf3 and not cf2 and bd == 8
    t_wire, t_dyn = convert.wire_from_numpy(wire, dyn)
    pflags = (has_l8, has_pcm, apply_db, sparse, has_intra, need_s2, 1, bd)
    return (t_wire, t_dyn, convert.ring_from_jax(*rings[:2]), mb_h, mb_w, pflags,
            int(wire["slot_idx"][0]), jout[-1], convert.ring_from_jax(*jout[:2]))


@pytest.mark.parametrize("i", [0, 1, 2])
def test_tensor_slot_equals_int_slot_and_jax(jax_frames, i):
    """frame_step with the slot as a 0-d int64 tensor (index_copy_ into the
    rings) writes what the int slot writes, and both equal JAX's frame."""
    wire, dyn, rings, mb_h, mb_w, flags, slot, jpacked, jrings = _port_args(jax_frames[i])
    outs = []
    for s in (slot, torch.tensor(slot, dtype=torch.int64)):
        ring_y, ring_c = (r.clone() for r in rings)
        packed = gpu_pipeline.frame_step(wire, ring_y, ring_c, dyn, mb_h, mb_w, flags, s)
        outs.append((packed, ring_y, ring_c))
    for packed, ring_y, ring_c in outs:
        np.testing.assert_array_equal(packed.numpy(), jpacked)
        assert torch.equal(ring_y, jrings[0]) and torch.equal(ring_c, jrings[1])


def test_ring_set_dispatch_equals_jax(jax_frames):
    """The JAX frames through one CPU RingSet, one frame after another: the
    numpy wire staged, copied into each program's static buffer, the slot
    written into its static tensor; every packed output and ring equals
    JAX's, and the set holds one program per distinct signature."""
    first = _port_args(jax_frames[0])
    ring_y, ring_c = first[2]
    rs = frame_program.RingSet(CPU, (tuple(ring_y.shape), tuple(ring_c.shape), ring_y.dtype))
    keys = set()
    for call in jax_frames:
        _, dyn, rings, mb_h, mb_w, flags, slot, jpacked, jrings = _port_args(call)
        rs.ring_y.copy_(rings[0])
        rs.ring_c.copy_(rings[1])
        key = frame_program.signature(call[0], dyn, mb_h, mb_w, flags)
        keys.add(key)
        packed = rs.dispatch(gpu_pipeline.frame_step, key, call[0], dyn, mb_h, mb_w, flags, slot)
        np.testing.assert_array_equal(packed.numpy(), jpacked)
        assert torch.equal(rs.ring_y, jrings[0]) and torch.equal(rs.ring_c, jrings[1])
        prog = rs.programs[key]
        assert prog.graph is None and int(prog.slot) == slot  # eager on the CPU
    assert set(rs.programs) == keys


def _sig_inputs():
    rng = np.random.default_rng(0)
    wire = {"qp": rng.integers(0, 52, 6).astype(np.int8),
            "luma_ac": rng.integers(-9, 9, (6, 16, 16)).astype(np.int8),
            "w_tab": np.full((2, 2, 16), 32, np.int16)}
    dyn = {"ls4_y": torch.zeros((2, 6, 16), dtype=torch.int32), "qp_offsets": (0, 0)}
    return wire, dyn, 2, 3, (False, False, True, True, True, False, 1, 8)


def test_signature_ignores_values():
    wire, dyn, mb_h, mb_w, flags = _sig_inputs()
    other = {k: v + 1 for k, v in wire.items()}
    assert frame_program.signature(wire, dyn, mb_h, mb_w, flags) == \
        frame_program.signature(other, dict(dyn), mb_h, mb_w, tuple(flags))


@pytest.mark.parametrize("change", ["flag", "geometry", "wire_shape", "narrow_dtype",
                                    "wire_key", "dyn_tables", "qp_offsets"])
def test_signature_changes_with_what_jax_retraces_on(change):
    wire, dyn, mb_h, mb_w, flags = _sig_inputs()
    key = frame_program.signature(wire, dyn, mb_h, mb_w, flags)
    if change == "flag":
        flags = flags[:4] + (False,) + flags[5:]  # has_intra
    elif change == "geometry":
        mb_w += 1
    elif change == "wire_shape":
        wire = dict(wire, w_tab=np.full((4, 2, 16), 32, np.int16))  # more slices
    elif change == "narrow_dtype":
        wire = dict(wire, luma_ac=wire["luma_ac"].astype(np.int16))
    elif change == "wire_key":
        wire = {k: v for k, v in wire.items() if k != "w_tab"}  # an unweighted frame
    elif change == "dyn_tables":
        dyn = dict(dyn, ls4_y=dyn["ls4_y"].clone())  # equal values, another tensor
    else:
        dyn = dict(dyn, qp_offsets=(0, 2))
    assert frame_program.signature(wire, dyn, mb_h, mb_w, flags) != key


def _committed(name):
    with open(os.path.join(DATA, name), "rb") as f:
        bs = f.read()
    with open(os.path.join(DATA, "smoke_md5.json")) as f:
        return bs, json.load(f)[name]["frames"]


@pytest.mark.parametrize("name", ["smoke_cif_high.h264", "smoke_cif_high444.h264"])
def test_decoder_runs_one_program_per_signature(name, monkeypatch):
    """GpuDecoder(device="cpu") through the programs stays bit-exact with
    libavcodec's committed MD5s; its RingSet holds one program per distinct
    signature, and every frame went through one."""
    monkeypatch.setattr(frame_program, "_idle", {})
    seen = []
    orig = frame_program.signature

    def spy(*args):
        seen.append(orig(*args))
        return seen[-1]

    monkeypatch.setattr(frame_program, "signature", spy)
    bs, want = _committed(name)
    m = DecodeMetrics()
    with GpuDecoder(device="cpu", metrics=m) as dec:
        got = [md5s(f.planes()) for f in dec.decode_stream(bs)]
        rs = dec._rings
    assert got == want
    assert len(seen) == len(want) and set(rs.programs) == set(seen)
    assert m.counters["program_keys"] == len(set(seen)) < len(seen)
    assert m.timer_calls["dispatch"] == len(want)
    assert "graph_captures" not in m.counters  # no graph on the CPU


def _tiny_stream():
    return lavc.encode_x264(make_test_frames(2, 32, 48, seed=4), qp=30, profile="main",
                            cabac=True, bframes=0)


def test_closed_decoder_returns_its_ring_set(monkeypatch):
    """A decoder after close() checks out the set the first one returned,
    programs included (a stream it decoded adds none); a decoder open at the
    same time as another of its geometry gets a set of its own."""
    monkeypatch.setattr(frame_program, "_idle", {})
    bs = _tiny_stream()
    with GpuDecoder(device="cpu") as first:
        want = [md5s(f.planes()) for f in first.decode_stream(bs)]
        rs = first._rings
    assert first._rings is None
    n = len(rs.programs)
    with GpuDecoder(device="cpu") as second:
        assert [md5s(f.planes()) for f in second.decode_stream(bs)] == want
        assert second._rings is rs and len(rs.programs) == n
        with GpuDecoder(device="cpu") as other:
            assert [md5s(f.planes()) for f in other.decode_stream(bs)] == want
            own = other._rings
            assert own is not rs
    # one idle set per (device, geometry): `other` closed first, so its set
    # stayed and the second decoder's was let go
    assert list(frame_program._idle.values()) == [own]


def test_concurrent_checkouts_get_distinct_sets(monkeypatch):
    """Checkouts of one geometry from more threads than cores at once, with
    a short switch interval, never share a set, and check-ins keep one idle
    set."""
    monkeypatch.setattr(frame_program, "_idle", {})
    geom = ((2, 4, 48, 64), (2, 2, 32, 40), torch.uint8)
    frame_program.checkin(frame_program.RingSet(CPU, geom))
    n = 2 * (os.cpu_count() or 4)
    got, start = [], threading.Barrier(n)

    def take():
        start.wait(timeout=30)
        got.append(frame_program.checkout(CPU, geom))

    threads = [threading.Thread(target=take) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len({id(rs) for rs in got}) == n
    for rs in got:
        frame_program.checkin(rs)
    assert len(frame_program._idle) == 1 and frame_program._idle[(CPU, geom)] in got
