"""Annex-B byte-stream demux and RBSP (de-)escaping.

Capability parity with the reference's L1/L2 layers
(/root/reference/h264/server.go:64-111, /root/reference/h264/nalUnit.go:106-126)
but fixing its defects: both 3- and 4-byte start codes are handled (the
reference only scans the 4-byte form, h264/server.go:28-39), the scan is
O(n) total via bytes.find (the reference does 1-byte reads per iteration,
h264/bit_reader.go:27), and no unbounded growing buffer is kept.
"""

from __future__ import annotations

from collections.abc import Iterator

START3 = b"\x00\x00\x01"


def split_nalus(data: bytes) -> list[bytes]:
    """Split an Annex-B stream into raw NAL units (no start codes).

    Handles both 00 00 01 and 00 00 00 01 start codes; trailing zero
    padding between NALs is dropped per spec section B.1.2.
    """
    return list(iter_nalus(data))


def iter_nalus(data: bytes) -> Iterator[bytes]:
    i = data.find(START3)
    if i < 0:
        return
    i += 3
    while True:
        j = data.find(START3, i)
        if j < 0:
            nal = data[i:]
            # strip trailing_zero_8bits
            nal = nal.rstrip(b"\x00")
            if nal:
                yield nal
            return
        end = j
        # a 4-byte start code is 00 + (00 00 01): the preceding 00 belongs
        # to the start code, not the NAL; so do any run of trailing zeros
        while end > i and data[end - 1] == 0:
            end -= 1
        if end > i:
            yield data[i:end]
        i = j + 3


def iter_nalus_chunks(chunks) -> Iterator[bytes]:
    """Incremental Annex-B demux over an iterable of byte chunks (e.g. a TCP
    stream): yields each complete NAL as soon as its terminating start code
    arrives, holding only the in-flight NAL in memory. The reference buffers
    the entire stream forever (h264/bit_reader.go:27-39); this is the
    bounded-memory streaming equivalent."""
    buf = b""
    started = False
    for chunk in chunks:
        if not chunk:
            continue
        buf += bytes(chunk)
        if not started:
            i = buf.find(START3)
            if i < 0:
                buf = buf[-2:]  # keep a potential split start code
                continue
            buf = buf[i + 3 :]
            started = True
        while True:
            j = buf.find(START3)
            if j < 0:
                break
            end = j
            while end > 0 and buf[end - 1] == 0:
                end -= 1
            if end > 0:
                yield buf[:end]
            buf = buf[j + 3 :]
    if started:
        nal = buf.rstrip(b"\x00")
        if nal:
            yield nal


def strip_emulation_prevention(payload: bytes) -> bytes:
    """nal_unit() to RBSP: drop each emulation_prevention_three_byte (0x03
    following 00 00), spec section 7.3.1 / 7.4.1. bytes.replace scans
    left-to-right over non-overlapping matches, which is exactly the
    spec's sequential removal rule."""
    if b"\x00\x00\x03" not in payload:
        return payload
    return payload.replace(b"\x00\x00\x03", b"\x00\x00")


def insert_emulation_prevention(rbsp: bytes) -> bytes:
    """RBSP to nal payload: insert 0x03 after any 00 00 preceding 00/01/02/03.

    Needed by the test-vector generator and bitstream writers, not decode.
    """
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def to_annexb(nalus: list[bytes]) -> bytes:
    """Join raw NAL units into an Annex-B stream with 4-byte start codes."""
    return b"".join(b"\x00\x00\x00\x01" + n for n in nalus)
