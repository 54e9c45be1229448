"""8-bit High 4:4:4 Predictive on the port's frame program, on the CPU,
against the JAX package's frame_step and libavcodec. Every comparison is
bit-exact (tolerance 0).

One small stream (64x96, CABAC, B frames, the 8x8 transform, the JVT
scaling lists, and a fade of all three planes, so x264 codes explicit luma
and chroma weights in its P frames) is decoded once
by the JAX package with its frame_step calls recorded: compiling the JAX
4:4:4 frame program on the CPU takes minutes, and one recording serves
every test here.
"""

import numpy as np
import pytest
import torch

from h264decode_tpu.golden import lavc
from h264decode_tpu.pipeline import tpu_pipeline
from tests.test_torch_pipeline import (
    _port_frame_step_matches,
    _record_jax_frame_steps,
    assert_frames_equal,
    to_format,
)
from tests.conftest import make_test_frames

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rec444():
    """(stream, JAX TpuDecoder frames, recorded JAX frame_step calls)."""
    frames = [tuple(np.clip(p.astype(np.float32) * (1.0 - 0.08 * i) + 3 * i, 0, 255)
                    .astype(np.uint8) for p in planes)
              for i, planes in enumerate(to_format(make_test_frames(4, 64, 96, seed=3),
                                                   "yuv444p"))]
    bs = lavc.encode_x264(frames, qp=26, profile="high444", csp="yuv444p", cabac=True,
                          bframes=1, extra_x264="weightp=2:8x8dct=1:cqm=jvt")
    with pytest.MonkeyPatch.context() as mp:
        calls = _record_jax_frame_steps(mp)
        ref = tpu_pipeline.TpuDecoder().decode_stream(bs)
    return bs, ref, calls


def _pick(calls, kind):
    if kind == "intra":  # the IDR frame: every MB intra, no weights
        return next(c for c in calls if c[5][5] and "w_tab" not in c[0])
    return next(c for c in calls if "w_tab" in c[0])  # explicitly weighted P


@pytest.mark.parametrize("kind", ["intra", "weighted_p"])
def test_frame_step_matches_jax_on_444_frame(rec444, kind):
    """A recorded 4:4:4 frame through the port's frame_step: the packed
    [3H, W] output and all three rings (Y, Cb, Cr half-pel stacks) equal
    the JAX package's."""
    _, _, calls = rec444
    call = _pick(calls, kind)
    wire, _, dyn, mb_h, mb_w, flags, jout = call
    assert flags[4] and flags[7] == 8  # cf3, 8-bit
    assert flags[0]  # the 8x8 transform
    # the JVT lists: intra and inter differ (flat lists would not)
    assert not (dyn["ls8_cb"][0] == dyn["ls8_cb"][1]).all()
    assert jout[-1].shape == (3 * 16 * mb_h, 16 * mb_w)
    if kind == "weighted_p":
        assert (wire["wc_tab"] != wire["wc_tab"][0, 0, 0, 0]).any()  # chroma weights
    _port_frame_step_matches(call)


def test_gpu_decoder_cpu_matches_tpu_decoder_on_444(rec444):
    """GpuDecoder(device="cpu") runs the 4:4:4 frame program on every
    picture and equals TpuDecoder and libavcodec."""
    bs, ref, _ = rec444
    from h264decode_tpu_torch.pipeline.gpu_pipeline import GpuDecoder

    with GpuDecoder(device="cpu") as dec:
        ours = dec.decode_stream(bs)
        assert dec._ring is not None and dec._ring[1].dim() == 5
    assert ours[0].cb.shape == ours[0].y.shape == (64, 96)
    assert_frames_equal(ref, ours)
    assert_frames_equal(lavc.decode_annexb(bs), ours)
    assert len(ours) == 4
