"""GOP-parallel decoding over the "gop" mesh axis (data parallelism).

Counterpart of h264decode_tpu/dist/gop.py. Closed GOPs (IDR to next IDR)
are independent decode problems. The stream is split at IDR access units
(pipeline/seek.scan_access_points), the GOPs go round-robin to the G gop
slots, and each slot runs in a thread of its own: a ShardedDecoder of the
slot's GOPs whose frames are reconstructed on the R bands of mesh row g
(dist/sharded.py), each frame in the mode it allows, through band programs
in a ShardSet of the slot's own: slots that share a card and a frame
geometry take distinct sets, and each returns its set when its thread ends,
so that a later decode replays them. The native entropy engine releases the
GIL in its C entry points and each slot's step owns its devices, so the
slots' entropy and reconstruction overlap; slots that share a card share
its stream.

The JAX decoder runs the slots in lockstep because its step is one SPMD
program over all of them: each batch waits for a frame of every slot, pads
the slots' weight tables to one shape, feeds exhausted slots dummy frames
and refuses slots whose frame sizes differ. Here no step spans two slots,
so none of that exists, and slots whose frames differ in size decode side
by side.

Multi-process (`multihost=True`, after dist.multihost.initialize): the gop
axis spans processes, each process decodes only the GOPs of its own slots
and returns their frames. GOPs exchange nothing while they decode, so no
collective runs per frame.
"""

from __future__ import annotations

import threading
from collections import Counter

from ..bitstream.annexb import to_annexb
from ..pipeline.decoder import DecodedFrame
from ..pipeline.seek import _first_mb_is_zero, _iter_nalus_offsets, scan_access_points
from ..syntax.nal import parse_nal_unit
from . import multihost as mh
from .decoder import ShardedDecoder


def split_gops(data: bytes) -> list[tuple[bytes, int]]:
    """Split an Annex-B stream at IDR access units into self-contained
    (segment_bytes, picture_count) pairs; each segment is prefixed with its
    active parameter sets."""
    pts = [p for p in scan_access_points(data) if p.kind == "idr"]
    if not pts:
        return [(data, _count_pictures(data))]
    total = _count_pictures(data)
    segs = []
    for i, p in enumerate(pts):
        end = pts[i + 1].offset if i + 1 < len(pts) else len(data)
        n = (pts[i + 1].picture_index if i + 1 < len(pts) else total) - p.picture_index
        prefix = to_annexb(list(p.sps_nals.values()) + list(p.pps_nals.values()))
        segs.append((prefix + data[p.offset : end], n))
    return segs


def _count_pictures(data: bytes) -> int:
    n = 0
    in_pic = False
    for _, raw in _iter_nalus_offsets(data):
        nal = parse_nal_unit(raw)
        if nal.is_vcl:
            if not in_pic or _first_mb_is_zero(nal.rbsp):
                n += 1
                in_pic = True
        else:
            in_pic = False
    return n


class GopParallelDecoder:
    """Decode a multi-GOP stream with data parallelism on the gop axis, and
    row-band sharding within each frame. `modes` counts the frames each
    mode reconstructed over all slots, as ShardedDecoder's does."""

    def __init__(self, mesh, apply_deblock: bool = True, multihost: bool = False):
        self.mesh = mesh
        self.apply_deblock = apply_deblock
        self.G = mesh.shape["gop"]
        self.multihost = multihost
        if multihost:
            n_proc = mh.process_count()
            assert self.G % n_proc == 0, "gop axis must divide by processes"
            self.g_local = self.G // n_proc
            self.g0 = mh.process_index() * self.g_local
        else:
            self.g_local = self.G
            self.g0 = 0
        self.modes: Counter = Counter()

    def decode_stream(self, data: bytes) -> list[DecodedFrame]:
        segs = split_gops(data)
        G = self.G
        local_slots = [g for g in range(self.g0, self.g0 + self.g_local) if g < len(segs)]
        decs = {g: ShardedDecoder(self.mesh, apply_deblock=self.apply_deblock, slot=g)
                for g in local_slots}
        slot_frames: dict[int, list[DecodedFrame]] = {}
        errors: list[BaseException] = []

        def run(slot: int):
            try:
                slot_frames[slot] = decs[slot].decode_stream(
                    b"".join(s for s, _ in segs[slot::G]))
            except BaseException as e:  # re-raised on the calling thread
                errors.append(e)
            finally:
                decs[slot].close()

        threads = [threading.Thread(target=run, args=(g,), daemon=True) for g in local_slots]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        self.modes = sum((d.modes for d in decs.values()), Counter())
        # stream order: segment j was decoded by slot j % G as its (j // G)-th
        # IDR group; a multi-process decoder returns its own slots' frames
        out: list[DecodedFrame] = []
        for j in range(len(segs)):
            if (j % G) in slot_frames:
                out.extend(f for f in slot_frames[j % G] if f.idr_group == j // G)
        return out
