"""The port's decode timers (utils/metrics.DecodeMetrics) on the CPU: CPU
time beside wall time, spans in segments, exact sums under concurrent
updates, and the decoder's host spans (parse, picture_setup, entropy,
entropy_native, picture_finish, recon_wait) on a committed smoke stream
decoded by GpuDecoder(device="cpu")."""

import json
import os
import sys
import threading
import time
from collections import defaultdict

import pytest
import torch

from h264decode_tpu_torch.bench import _md5s
from h264decode_tpu_torch.bitstream.annexb import iter_nalus
from h264decode_tpu_torch.pipeline.gpu_pipeline import GpuDecoder
from h264decode_tpu_torch.syntax.nal import parse_nal_unit
from h264decode_tpu_torch.utils.metrics import DecodeMetrics, span, timer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "h264decode_tpu_torch", "data")
# 8 CIF pictures of two slices each: the slices' engine calls run on the
# per-slice threads
STREAM = "smoke_cif_main_slices2_nodb.h264"
PER_PICTURE = ("parse", "picture_setup", "entropy", "picture_finish", "recon_wait")
# the timers of the thread that runs decode_iter and reads the planes,
# disjoint in time (`entropy` runs in each picture's task, on a worker)
MAIN_THREAD = tuple(k for k in PER_PICTURE if k != "entropy") + (
    "plane_wait", "download", "recon_drain")


def _busy(seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_timer_records_cpu_time_beside_wall_time():
    m = DecodeMetrics()
    with m.timer("busy"):
        _busy(0.2)
    with m.timer("sleep"):
        time.sleep(0.2)
    assert m.timers["busy"] >= 0.2 and m.timers["sleep"] >= 0.2
    # the CPU interval lies inside the wall interval
    assert m.cpu_timers["busy"] <= m.timers["busy"]
    assert m.cpu_timers["busy"] > 0.5 * m.timers["busy"]
    assert 0 <= m.cpu_timers["sleep"] < 0.02
    s = m.summary()
    assert s["t_busy_s"] == round(m.timers["busy"], 3)
    assert s["t_busy_cpu_s"] == round(m.cpu_timers["busy"], 3)
    assert s["t_sleep_calls"] == 1 and "t_sleep_cpu_s" in s


def test_span_adds_its_segments_as_one_call():
    m = DecodeMetrics()
    seen = []
    m.segment = lambda name, t0, t1: seen.append((name, t1 - t0))
    s = m.span("stage")
    s.start()
    _busy(0.05)
    s.pause()
    time.sleep(0.2)  # paused: not counted
    s.start()
    _busy(0.05)
    s.end()
    assert m.timer_calls["stage"] == 1
    assert 0.1 <= m.timers["stage"] < 0.25  # the 0.2 s paused left out
    assert m.cpu_timers["stage"] <= m.timers["stage"]
    assert [n for n, _ in seen] == ["stage", "stage"]
    assert sum(d for _, d in seen) == pytest.approx(m.timers["stage"])
    # an add_time without CPU time leaves cpu_timers alone
    m.add_time("copy", 0.5)
    assert m.timers["copy"] == 0.5 and "copy" not in m.cpu_timers


def test_spans_and_timers_of_no_metrics_record_nothing():
    s = span(None, "stage")
    s.start()
    s.pause()
    s.end()
    with timer(None, "stage"):
        pass


class _Switching(defaultdict):
    """A defaultdict that lets another thread run between the read and the
    write of each `d[k] += v`, as the interpreter may at any bytecode."""

    def __setitem__(self, key, value):
        time.sleep(0)
        super().__setitem__(key, value)


@pytest.mark.parametrize("dicts", ["plain", "switching"])
def test_concurrent_updates_give_exact_sums(dicts):
    m = DecodeMetrics()
    if dicts == "switching":
        for name in ("counters", "timers", "cpu_timers", "timer_calls"):
            setattr(m, name, _Switching(getattr(m, name).default_factory))
    threads, calls = 8, 2000
    start = threading.Barrier(threads)

    def work():
        start.wait()
        for _ in range(calls):
            m.add_time("stage", 0.5, 0.25)
            m.count("frames")
            m.count("mbs", 3)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
    finally:
        sys.setswitchinterval(old)
    n = threads * calls
    assert m.timer_calls["stage"] == n
    assert m.timers["stage"] == 0.5 * n and m.cpu_timers["stage"] == 0.25 * n
    assert m.counters["frames"] == n and m.counters["mbs"] == 3 * n


@pytest.fixture(scope="module")
def decoded():
    """(metrics, wall s, main thread CPU s, planes, slices) of one decode of
    STREAM by GpuDecoder(device="cpu"), every frame's planes read as
    decode_iter yields it."""
    with open(os.path.join(DATA, STREAM), "rb") as f:
        bs = f.read()
    slices = sum(parse_nal_unit(raw).is_vcl for raw in iter_nalus(bs))
    m = DecodeMetrics()
    with GpuDecoder(device="cpu", metrics=m) as dec:
        t0, c0 = time.perf_counter(), time.thread_time()
        planes = [f.planes() for f in dec.decode_iter(bs)]
        cpu = time.thread_time() - c0
        wall = time.perf_counter() - t0
    return m, wall, cpu, planes, slices


def test_decoder_times_each_host_stage_once_a_picture(decoded):
    m, _, _, planes, slices = decoded
    with open(os.path.join(DATA, "smoke_md5.json")) as f:
        want = json.load(f)[STREAM]["frames"]
    assert [_md5s(p) for p in planes] == want
    pictures = m.counters["frames"]
    assert pictures == len(want) == 8 and slices == 2 * pictures
    for name in PER_PICTURE:
        assert m.timer_calls[name] == pictures, name
    assert m.timer_calls["entropy_native"] == slices
    assert m.timer_calls["prep"] == pictures and m.timer_calls["recon_drain"] == 1
    for name in PER_PICTURE + ("entropy_native", "prep"):
        assert m.timers[name] >= 0 and m.cpu_timers[name] >= 0, name


def test_main_thread_spans_fit_in_the_decode(decoded):
    m, wall, cpu, _, _ = decoded
    assert sum(m.timers[k] for k in MAIN_THREAD) <= wall
    assert cpu <= wall
    # each of these ran on the main thread, its CPU inside its wall
    for k in MAIN_THREAD + ("entropy",):
        assert m.cpu_timers[k] <= m.timers[k] + 1e-6, k
    assert sum(m.cpu_timers[k] for k in MAIN_THREAD) <= cpu + 1e-3
    # the pictures' entropy tasks ran beside it, each inside the decode
    assert m.timers["entropy"] <= wall * m.timer_calls["entropy"]
