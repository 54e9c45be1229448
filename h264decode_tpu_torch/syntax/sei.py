"""SEI message parsing (spec 7.3.2.3, Annex D) — the payloads the decode
pipeline acts on (recovery point for resume/seek, buffering/timing skimmed),
everything else preserved raw.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..bitstream.bitreader import BitReader

SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_USER_DATA_UNREGISTERED = 5
SEI_RECOVERY_POINT = 6


@dataclass
class SEIMessage:
    payload_type: int
    payload: bytes
    # recovery point fields (type 6), spec D.2.7
    recovery_frame_cnt: int = -1
    exact_match_flag: bool = False
    broken_link_flag: bool = False


@dataclass
class SEI:
    messages: list[SEIMessage] = field(default_factory=list)

    def recovery_point(self) -> SEIMessage | None:
        for m in self.messages:
            if m.payload_type == SEI_RECOVERY_POINT:
                return m
        return None


def parse_sei(rbsp: bytes) -> SEI:
    """sei_rbsp(): sequence of sei_message() until the trailing bits."""
    out = SEI()
    pos = 0
    n = len(rbsp)
    while pos < n and rbsp[pos] != 0x80:  # stop at rbsp_trailing_bits
        ptype = 0
        while pos < n and rbsp[pos] == 0xFF:
            ptype += 255
            pos += 1
        if pos >= n:
            break
        ptype += rbsp[pos]
        pos += 1
        size = 0
        while pos < n and rbsp[pos] == 0xFF:
            size += 255
            pos += 1
        if pos >= n:
            break
        size += rbsp[pos]
        pos += 1
        payload = rbsp[pos : pos + size]
        pos += size
        msg = SEIMessage(payload_type=ptype, payload=payload)
        if ptype == SEI_RECOVERY_POINT and payload:
            r = BitReader(payload)
            msg.recovery_frame_cnt = r.ue()
            msg.exact_match_flag = r.flag()
            msg.broken_link_flag = r.flag()
        out.messages.append(msg)
    return out
