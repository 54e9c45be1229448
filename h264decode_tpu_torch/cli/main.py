"""Command-line interface: decode / probe / serve / bench.

Usage:
  python -m h264decode_tpu_torch decode in.h264 out.y4m
      [--backend gpu|numpy|sharded|gop] [--mesh GxR] [--device cuda|cpu]
      [--no-deblock] [--metrics]
  python -m h264decode_tpu_torch probe in.h264 [--access-points]
  python -m h264decode_tpu_torch serve [--host 127.0.0.1] [--port 8000]
      [--out-dir .] [--once] [--backend gpu|numpy] [--device cuda|cpu]
  python -m h264decode_tpu_torch bench [--device cuda|cpu]

The gpu backend runs on the CUDA device unless --device cpu asks for the
CPU (the plain torch versions of the kernels). The multi-device backends
run on a ("gop", "row") mesh of GxR devices (dist/): `sharded` cuts each
frame into R row bands (gop slot 0), `gop` decodes closed GOPs on G slots
in parallel, each in R bands. Their mesh takes the visible CUDA devices (so
one card gives 1x1); with --device cpu it repeats the CPU device G*R times.
`serve` is a TCP ingest server: each connection's bytes are one Annex-B
stream, decoded by a decoder of its own into <out-dir>/stream_<n>.y4m as the
DPB outputs frames. `bench` prints the decode-throughput JSON line of
h264decode_tpu_torch/bench.py.
"""

from __future__ import annotations

import argparse
import itertools
import os
import socket
import sys
import threading
import time


def _parse_mesh(spec: str, device: str = "cuda"):
    """"GxR" -> a ("gop", "row") mesh (e.g. --mesh 2x4; empty: the JAX
    package's factoring of every device). CUDA devices are the visible
    ones; --device cpu repeats the CPU G*R times. A single named device
    (cuda:N) is refused: the mesh would not be built from it."""
    from ..dist.mesh import make_mesh

    if device not in ("cuda", "cpu"):
        raise ValueError(f"--device {device}: the sharded and gop backends take every "
                         "visible CUDA device (--device cuda) or the CPU (--device cpu)")
    g, r = (int(v) for v in spec.lower().split("x")) if spec else (None, None)
    if device == "cpu":
        return make_mesh(g, r, devices=["cpu"] * ((g or 1) * (r or 1)))
    return make_mesh(g, r)


def _make_decoder(backend: str, apply_deblock: bool, device: str = "cuda",
                  metrics=None, mesh: str = ""):
    if backend == "sharded":
        from ..dist.decoder import ShardedDecoder

        return ShardedDecoder(_parse_mesh(mesh, device), apply_deblock=apply_deblock,
                              metrics=metrics)
    if backend == "gop":
        from ..dist.gop import GopParallelDecoder

        return GopParallelDecoder(_parse_mesh(mesh, device), apply_deblock=apply_deblock)
    if backend == "gpu":
        from ..pipeline.gpu_pipeline import GpuDecoder

        return GpuDecoder(apply_deblock=apply_deblock, device=device, metrics=metrics)
    from ..pipeline.decoder import Decoder

    return Decoder(apply_deblock=apply_deblock, metrics=metrics)


def _close(dec) -> None:
    """Stop a decoder's worker threads (GpuDecoder has some; None and the
    host Decoder have none)."""
    close = getattr(dec, "close", None)
    if close is not None:
        close()


def cmd_decode(args) -> int:
    from ..io.writers import write_npz, write_y4m
    from ..utils.metrics import DecodeMetrics

    metrics = DecodeMetrics()
    with open(args.input, "rb") as f:
        data = f.read()
    dec = _make_decoder(args.backend, not args.no_deblock, args.device, metrics, args.mesh)
    try:
        t0 = time.time()
        if args.seek:
            from ..pipeline.seek import decode_from, scan_access_points

            pts = scan_access_points(data)
            if not pts:
                print("no access points found", file=sys.stderr)
                return 1
            pt = next((p for p in pts if p.picture_index >= args.seek), pts[-1])
            frames = list(decode_from(data, pt, decoder=dec))
        else:
            with metrics.timer("decode"):
                frames = dec.decode_stream(data)
        dt = time.time() - t0
    finally:
        _close(dec)
    if args.output.endswith(".npz"):
        write_npz(args.output, frames)
    else:
        write_y4m(args.output, frames)
    print(
        f"decoded {len(frames)} frames in {dt:.2f}s "
        f"({len(frames) / dt:.2f} fps) -> {args.output}"
    )
    if args.metrics:
        print(metrics.dump())
    return 0


def cmd_probe(args) -> int:
    from ..bitstream.annexb import iter_nalus
    from ..syntax import nal as nal_mod
    from ..syntax.nal import parse_nal_unit
    from ..syntax.pps import parse_pps
    from ..syntax.slice_header import parse_slice_header
    from ..syntax.sps import parse_sps

    data = open(args.input, "rb").read()
    if getattr(args, "access_points", False):
        from ..pipeline.seek import scan_access_points

        for pt in scan_access_points(data):
            extra = (
                f" recovery_frame_cnt {pt.recovery_frame_cnt}"
                f" exact {pt.exact_match}" if pt.kind == "recovery" else ""
            )
            print(
                f"{pt.kind:8s} byte {pt.offset:<10d} picture "
                f"{pt.picture_index}{extra}"
            )
        return 0
    sps_map, pps_map = {}, {}
    for raw in iter_nalus(data):
        nal = parse_nal_unit(raw)
        if nal.type == nal_mod.NAL_SPS:
            s = parse_sps(nal.rbsp)
            sps_map[s.seq_parameter_set_id] = s
            print(
                f"SPS {s.seq_parameter_set_id}: profile {s.profile_idc} "
                f"level {s.level_idc} {s.width}x{s.height} "
                f"chroma {s.chroma_format_idc} refs {s.max_num_ref_frames}"
            )
        elif nal.type == nal_mod.NAL_PPS:
            p = parse_pps(nal.rbsp, sps_map)
            pps_map[p.pic_parameter_set_id] = p
            print(
                f"PPS {p.pic_parameter_set_id}: "
                f"{'CABAC' if p.entropy_coding_mode_flag else 'CAVLC'} "
                f"init_qp {p.pic_init_qp} t8x8 {p.transform_8x8_mode_flag}"
            )
        elif nal.is_vcl:
            h, s, p, _ = parse_slice_header(nal.rbsp, nal, sps_map, pps_map)
            print(
                f"slice {h.type_name}{' IDR' if h.idr_pic_flag else ''} "
                f"frame_num {h.frame_num} qp {h.slice_qp(p)} "
                f"first_mb {h.first_mb_in_slice}"
            )
        else:
            print(f"NAL {nal.type}: {nal.name} ({len(raw)} bytes)")
    return 0


def _serve_connection(conn: socket.socket, dec, path: str, idx: int) -> None:
    """Decode one connection's byte stream into the Y4M file `path`, frame
    by frame as the DPB outputs them (memory stays bounded for any stream
    length); the socket and the decoder are closed when it ends. The line
    it prints gives the decoder's counters and stage timers in seconds and,
    on a CUDA device, the process's peak device memory in bytes."""
    import json

    from ..io.writers import write_y4m

    def chunks():
        while True:
            b = conn.recv(1 << 16)
            if not b:
                return
            yield b

    try:
        n = write_y4m(path, dec.decode_iter(chunks()))
    finally:
        conn.close()
        _close(dec)
    stats = {"counters": dict(dec.metrics.counters), "timers": dict(dec.metrics.timers)}
    device = getattr(dec, "device", None)
    if device is not None and device.type == "cuda":
        import torch

        stats["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    print(f"[conn {idx}] {n} frames -> {path}; {json.dumps(stats)}", flush=True)


def cmd_serve(args) -> int:
    """TCP Annex-B ingest (h264decode_tpu/cli/main.py:146-186). Each
    connection gets a decoder of its own, made before the connection is
    accepted, so a missing CUDA device fails at startup. With --once the
    server handles one connection and returns when its output is written."""
    from ..utils.metrics import DecodeMetrics

    dec = _make_decoder(args.backend, True, args.device, DecodeMetrics())
    srv = socket.create_server((args.host, args.port))
    host, port = srv.getsockname()[:2]
    print(f"listening on {host}:{port}; writing to {args.out_dir}", flush=True)
    try:
        for idx in itertools.count():
            conn, _ = srv.accept()
            path = os.path.join(args.out_dir, f"stream_{idx}.y4m")
            handler_args = (conn, dec, path, idx)
            dec = None  # the handler closes it
            if args.once:
                _serve_connection(*handler_args)
                return 0
            threading.Thread(target=_serve_connection, args=handler_args, daemon=True).start()
            dec = _make_decoder(args.backend, True, args.device, DecodeMetrics())
    except KeyboardInterrupt:
        return 0
    finally:
        srv.close()
        _close(dec)


def cmd_bench(args) -> int:
    from ..bench import main as bench_main

    return bench_main(args.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="h264decode_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("decode", help="decode an Annex-B file to y4m/npz")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument(
        "--backend", choices=["gpu", "numpy", "sharded", "gop"], default="gpu",
        help="gpu: the GPU frame program; sharded: row bands over a mesh; gop: "
        "GOP-parallel slots of row bands over a mesh; numpy: the host oracle",
    )
    d.add_argument(
        "--mesh", default="",
        help='("gop","row") mesh shape as GxR, e.g. 1x2 (sharded/gop backends)',
    )
    d.add_argument("--device", default="cuda",
                   help="torch device of the gpu backend (cuda, cuda:N or cpu); the "
                   "sharded/gop mesh takes every visible card (cuda) or repeats the CPU (cpu)")
    d.add_argument(
        "--seek", type=int, default=0, metavar="N",
        help="resume decoding at the first access point at/after picture N",
    )
    d.add_argument("--no-deblock", action="store_true")
    d.add_argument("--metrics", action="store_true")
    d.set_defaults(fn=cmd_decode)
    p = sub.add_parser("probe", help="print stream structure")
    p.add_argument("input")
    p.add_argument(
        "--access-points", action="store_true",
        help="list random-access points (IDR / recovery-point SEI)",
    )
    p.set_defaults(fn=cmd_probe)
    s = sub.add_parser("serve", help="TCP Annex-B ingest server")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000, help="0 picks a free port")
    s.add_argument("--out-dir", default=".")
    s.add_argument("--once", action="store_true",
                   help="serve one connection, return when its output is written")
    s.add_argument("--backend", choices=["gpu", "numpy"], default="gpu")
    s.add_argument("--device", default="cuda",
                   help="torch device of the gpu backend (cuda, cuda:N or cpu)")
    s.set_defaults(fn=cmd_serve)
    b = sub.add_parser("bench", help="decode-throughput benchmark (one JSON line)")
    b.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    b.set_defaults(fn=cmd_bench)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
