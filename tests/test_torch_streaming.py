"""Seek and chunked ingest on the port's GpuDecoder (on the CPU), against
libavcodec: resuming at an IDR access point through seek.decode_from and
through `decode --seek`, and decode_iter fed 777-byte chunks. The stream is
tests/test_streaming.py's B-pyramid stream (24 frames, 3 IDR groups)."""

import numpy as np
import pytest
import torch

from h264decode_tpu_torch.cli.main import main as cli_main
from h264decode_tpu_torch.golden import lavc
from h264decode_tpu_torch.pipeline.gpu_pipeline import GpuDecoder
from h264decode_tpu_torch.pipeline.seek import decode_from, scan_access_points
from chip_smoke import md5s, y4m_md5s
from tests.conftest import make_test_frames

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bstream():
    return lavc.encode_x264(
        make_test_frames(24, 96, 112, seed=3), qp=26, profile="main", cabac=True,
        bframes=3, gop=8, extra_x264="b-pyramid=normal:keyint=8:min-keyint=8:scenecut=0",
    )


@pytest.fixture(scope="module")
def golden(bstream):
    return lavc.decode_annexb(bstream)


def assert_same(want, got):
    assert len(want) == len(got)
    for g, o in zip(want, got):
        for gp, op in zip(g.planes(), o.planes()):
            assert np.array_equal(gp, np.asarray(op))


def test_decode_from_second_idr(bstream, golden):
    idrs = [p for p in scan_access_points(bstream) if p.kind == "idr"]
    assert [p.picture_index for p in idrs] == [0, 8, 16]
    with GpuDecoder(device="cpu") as dec:
        tail = list(decode_from(bstream, idrs[1], decoder=dec))
    assert_same(golden[8:], tail)


def test_cli_decode_seek(tmp_path, bstream, golden):
    """`decode --seek 8` resumes at the first access point at or after
    picture 8, the second IDR."""
    src, out = tmp_path / "in.264", tmp_path / "out.y4m"
    src.write_bytes(bstream)
    assert cli_main(["decode", str(src), str(out), "--seek", "8", "--device", "cpu"]) == 0
    want = dict(width=112, height=96, bit_depth=8, chroma="420")
    assert y4m_md5s(str(out), want) == [md5s(g.planes()) for g in golden[8:]]


def test_decode_iter_777_byte_chunks(bstream, golden):
    chunks = (bstream[i : i + 777] for i in range(0, len(bstream), 777))
    with GpuDecoder(device="cpu") as dec:
        got = list(dec.decode_iter(chunks))
    assert_same(golden, got)
