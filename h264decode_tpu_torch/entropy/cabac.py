"""CABAC arithmetic decoding engine + binarization primitives, spec 9.3.

A complete, working engine — unlike the reference's, which re-initialises
per syntax element (h264/slice.go:652), discards results
(h264/cabac.go:462) and mis-implements DecodeBypass (h264/cabac.go:473);
see SURVEY.md section 3.3. Context init uses the complete 1024-context
tables in cabac_tables.py (the reference has ~75 of them).

Pure-Python reference implementation; the native/ C++ engine is the fast
path and is cross-checked against this one.
"""

from __future__ import annotations

from ..bitstream.bitreader import BitReader
from .cabac_tables import (
    CONTEXT_INIT_I,
    CONTEXT_INIT_PB,
    RANGE_TAB_LPS,
    TRANS_IDX_LPS,
    TRANS_IDX_MPS,
)


def _clip3(lo, hi, v):
    return lo if v < lo else hi if v > hi else v


def init_context_states(slice_qp: int, is_intra_slice: bool, cabac_init_idc: int):
    """spec 9.3.1.1: (pStateIdx, valMPS) for all 1024 contexts."""
    table = CONTEXT_INIT_I if is_intra_slice else CONTEXT_INIT_PB[cabac_init_idc]
    qp = _clip3(0, 51, slice_qp)
    states = bytearray(1024)
    mps = bytearray(1024)
    for i, (m, n) in enumerate(table):
        pre = _clip3(1, 126, ((m * qp) >> 4) + n)
        if pre <= 63:
            states[i] = 63 - pre
            mps[i] = 0
        else:
            states[i] = pre - 64
            mps[i] = 1
    return states, mps


class CabacEngine:
    """spec 9.3.3.2: arithmetic decoding engine. Initialised ONCE per slice."""

    __slots__ = ("r", "range", "offset", "states", "mps")

    def __init__(self, r: BitReader, slice_qp: int, is_intra_slice: bool, cabac_init_idc: int):
        # cabac_alignment_one_bit(s): align to the next byte (spec 7.3.4)
        while not r.byte_aligned():
            if r.u(1) != 1:
                raise ValueError("cabac_alignment_one_bit != 1")
        self.r = r
        self.range = 510
        self.offset = r.u(9)
        self.states, self.mps = init_context_states(
            slice_qp, is_intra_slice, cabac_init_idc
        )

    def _read_bit(self) -> int:
        r = self.r
        if r.pos < r.nbits:
            return r.u(1)
        return 0  # cabac_zero_word padding region

    def decision(self, ctx: int) -> int:
        """DecodeDecision, spec 9.3.3.2.1 (the reference's unwired TODO,
        h264/cabac.go:460)."""
        state = self.states[ctx]
        rng = self.range
        lps = RANGE_TAB_LPS[state][(rng >> 6) & 3]
        rng -= lps
        offset = self.offset
        if offset >= rng:
            # LPS path
            offset -= rng
            rng = lps
            bin_val = 1 - self.mps[ctx]
            if state == 0:
                self.mps[ctx] ^= 1
            self.states[ctx] = TRANS_IDX_LPS[state]
        else:
            bin_val = self.mps[ctx]
            self.states[ctx] = TRANS_IDX_MPS[state]
        # RenormD (9.3.3.2.2)
        while rng < 256:
            rng <<= 1
            offset = (offset << 1) | self._read_bit()
        self.range = rng
        self.offset = offset
        return bin_val

    def bypass(self) -> int:
        """DecodeBypass, spec 9.3.3.2.3."""
        offset = (self.offset << 1) | self._read_bit()
        if offset >= self.range:
            self.offset = offset - self.range
            return 1
        self.offset = offset
        return 0

    def terminate(self) -> int:
        """DecodeTerminate, spec 9.3.3.2.4 (end_of_slice_flag, I_PCM)."""
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return 0

    def flush(self) -> None:
        """DecodeFlush (9.3.3.2.5): after a terminate bin of 1, re-sync the
        raw bit position (range=2 then renormalize, reading 7 bits)."""
        self.range = 2
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()

    def reinit(self) -> None:
        """Re-initialise the arithmetic engine after I_PCM samples
        (9.3.1.2); context states are preserved."""
        self.range = 510
        self.offset = self.r.u(9)

    # ------------------------------------------------- composite binarizations

    def unary(self, ctx_fn, max_val: int | None = None) -> int:
        """U / TU binarization: count of 1-bins; ctx_fn(bin_idx) -> ctxIdx."""
        v = 0
        while (max_val is None or v < max_val) and self.decision(ctx_fn(v)):
            v += 1
        return v

    def fixed_len_bypass(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bypass()
        return v

    def ueg_suffix(self, k: int) -> int:
        """EGk suffix of a saturated UEGk prefix (spec 9.3.2.3), bypass-coded."""
        v = 0
        while self.bypass():
            v += 1 << k
            k += 1
            if k > 30:
                raise ValueError("UEG suffix overflow")
        while k > 0:
            k -= 1
            v += self.bypass() << k
        return v

    def sign(self) -> int:
        """coeff/mvd sign: 1 bypass bin; returns +1 or -1."""
        return -1 if self.bypass() else 1
