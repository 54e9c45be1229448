"""Bit-granular reader over an RBSP byte string, with Exp-Golomb descriptors.

Covers the reference's L5 layer (/root/reference/h264/bit_reader.go) with
fixes: se(v) is exact for all codeNums (the reference's integer-division bug
at h264/bit_reader.go:158-161 breaks odd codeNums), and more_rbsp_data() is
non-destructive (the reference consumes bits while probing,
h264/bit_reader.go:199-219).

This is the pure-Python reference implementation; the hot entropy path has a
C++ twin in native/ cross-checked against this one.
"""

from __future__ import annotations


class BitReaderError(Exception):
    pass


class BitReader:
    __slots__ = ("data", "pos", "nbits", "_stop_bit")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.nbits = len(data) * 8
        self._stop_bit = None  # lazily computed rbsp_stop_one_bit position

    # -- core reads ---------------------------------------------------------

    def u(self, n: int) -> int:
        """Read n bits, MSB first (descriptor u(n) / f(n))."""
        pos = self.pos
        end = pos + n
        if end > self.nbits:
            raise BitReaderError(f"read past end: pos={pos} n={n} nbits={self.nbits}")
        if n == 0:
            return 0
        byte_start = pos >> 3
        byte_end = (end + 7) >> 3
        chunk = int.from_bytes(self.data[byte_start:byte_end], "big")
        self.pos = end
        return (chunk >> ((byte_end << 3) - end)) & ((1 << n) - 1)

    def flag(self) -> bool:
        return bool(self.u(1))

    def peek(self, n: int) -> int:
        """Peek up to n bits without consuming; zero-padded past the end."""
        pos = self.pos
        avail = self.nbits - pos
        take = min(n, avail)
        if take <= 0:
            return 0
        byte_start = pos >> 3
        byte_end = (pos + take + 7) >> 3
        chunk = int.from_bytes(self.data[byte_start:byte_end], "big")
        val = (chunk >> ((byte_end << 3) - (pos + take))) & ((1 << take) - 1)
        return val << (n - take)

    def skip(self, n: int) -> None:
        self.pos += n
        if self.pos > self.nbits:
            raise BitReaderError("skip past end")

    # -- Exp-Golomb (spec section 9.1) --------------------------------------

    def ue(self) -> int:
        """ue(v): unsigned Exp-Golomb."""
        # fast path: inspect a 32-bit window
        window = self.peek(32)
        if window == 0:
            # >31 leading zeros: long-code slow path
            lz = 0
            while self.u(1) == 0:
                lz += 1
                if lz > 63:
                    raise BitReaderError("invalid Exp-Golomb code (>63 zeros)")
            return (1 << lz) - 1 + self.u(lz) if lz else 0
        lz = 32 - window.bit_length()
        if lz == 0:
            self.skip(1)
            return 0
        if 2 * lz + 1 <= 32:
            self.skip(2 * lz + 1)
            return (1 << lz) - 1 + ((window >> (32 - 2 * lz - 1)) & ((1 << lz) - 1))
        # code longer than the 32-bit window: consume prefix, read suffix
        self.skip(lz + 1)
        return (1 << lz) - 1 + self.u(lz)

    def se(self) -> int:
        """se(v): signed Exp-Golomb, spec 9.1.1: (-1)^(k+1) * ceil(k/2)."""
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def te(self, max_val: int) -> int:
        """te(v): truncated Exp-Golomb (spec 9.1.1)."""
        if max_val == 1:
            return 1 - self.u(1)
        return self.ue()

    # -- alignment / termination -------------------------------------------

    def byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    @property
    def stop_bit_pos(self) -> int:
        """Bit position of the rbsp_stop_one_bit (last set bit in the RBSP)."""
        if self._stop_bit is None:
            data = self.data
            i = len(data) - 1
            while i >= 0 and data[i] == 0:
                i -= 1
            if i < 0:
                self._stop_bit = 0
            else:
                b = data[i]
                # position of lowest set bit within byte i
                low = (b & -b).bit_length() - 1
                self._stop_bit = i * 8 + (7 - low)
        return self._stop_bit

    def more_rbsp_data(self) -> bool:
        """Spec 7.2: data remains before the rbsp_stop_one_bit. Non-destructive."""
        return self.pos < self.stop_bit_pos

    def rbsp_trailing_bits(self) -> None:
        if self.u(1) != 1:
            raise BitReaderError("rbsp_stop_one_bit != 1")
        while not self.byte_aligned():
            if self.u(1) != 0:
                raise BitReaderError("rbsp_alignment_zero_bit != 0")

    def bits_left(self) -> int:
        return self.nbits - self.pos
