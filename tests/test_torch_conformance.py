"""JVT conformance corpus runner for the port (the counterpart of
tests/conformance/test_jvt_corpus.py).

Decodes every elementary stream of an externally provided corpus with the
port's GpuDecoder, bit-exactly against libavcodec. The JVT/AVC conformance
bitstreams are not redistributable with this repo; point the runner at a
local copy:

    H264_CONFORMANCE_DIR=/path/to/corpus python -m pytest tests/test_torch_conformance.py

The directory is scanned recursively for *.264 / *.h264 / *.26l / *.avc /
*.jsv / *.jvt files (tests/conformance/corpus/ when the variable is unset).
H264_CONFORMANCE_DEVICE names GpuDecoder's device: cpu (the default, the
plain torch versions of the kernels) or cuda (on the card). For each
stream the runner decodes it with libavcodec (the golden oracle) and with
GpuDecoder, and asserts the frame count and every output plane bit-exact.

Streams whose features the decoder declares out of scope raise
NotImplementedError and are reported as XFAIL (counted, not hidden);
streams libavcodec itself cannot decode are skipped. Without a corpus the
module collects one skipped placeholder.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from tests.conformance.test_jvt_corpus import _STREAMS


@pytest.mark.skipif(bool(_STREAMS), reason="corpus present: real runs below")
def test_corpus_absent_placeholder():
    pytest.skip("no JVT corpus: set H264_CONFORMANCE_DIR or populate "
                "tests/conformance/corpus/")


@pytest.mark.parametrize("path", _STREAMS, ids=[os.path.basename(p) for p in _STREAMS])
def test_jvt_stream_bit_exact_on_the_port(path):
    import torch

    from h264decode_tpu_torch.golden import lavc
    from h264decode_tpu_torch.pipeline.gpu_pipeline import GpuDecoder

    torch.set_num_threads(1)
    name = os.path.basename(path)
    with open(path, "rb") as f:
        data = f.read()
    try:
        golden = lavc.decode_annexb(data)
    except Exception as e:  # the oracle cannot decode it either
        pytest.skip(f"libavcodec cannot decode {name}: {e}")
    if not golden:
        pytest.skip("libavcodec produced no frames")
    try:
        with GpuDecoder(device=os.environ.get("H264_CONFORMANCE_DEVICE", "cpu")) as dec:
            ours = [[np.asarray(p) for p in f.planes()] for f in dec.decode_stream(data)]
    except NotImplementedError as e:
        pytest.xfail(f"declared unsupported feature: {e}")
    assert len(ours) == len(golden), f"{name}: {len(ours)} frames vs libavcodec's {len(golden)}"
    for fi, (g, o) in enumerate(zip(golden, ours)):
        for plane, gp, op in zip(("y", "cb", "cr"), g.planes(), o):
            assert np.array_equal(np.asarray(gp), op), f"{name}: frame {fi} plane {plane} differs"
