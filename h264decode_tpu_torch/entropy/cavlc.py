"""CAVLC residual block decoding, spec section 9.2.

This is the component the reference repo lacks entirely (SURVEY.md section 0:
"residual/coefficient parsing ... absent"). Pure-Python reference
implementation; the C++ twin in native/ is cross-checked against it.

Tables come from entropy/cavlc_tables.py (generated, spec-exact).
"""

from __future__ import annotations

from ..bitstream.bitreader import BitReader, BitReaderError
from .cavlc_tables import (
    CHROMA422_DC_COEFF_TOKEN,
    CHROMA422_DC_TOTAL_ZEROS,
    CHROMA_DC_COEFF_TOKEN,
    CHROMA_DC_TOTAL_ZEROS,
    COEFF_TOKEN,
    RUN_BEFORE,
    TOTAL_ZEROS_4x4,
)


def _build_vlc(entries):
    """entries: iterable of ((length, bits), value). Returns dict keyed by
    (length, bits) plus the max code length."""
    table = {}
    max_len = 0
    for (length, bits), value in entries:
        if length == 0:
            continue
        table[(length, bits)] = value
        max_len = max(max_len, length)
    return table, max_len


def _coeff_token_entries(tab):
    for idx, lb in enumerate(tab):
        total_coeff, trailing_ones = idx >> 2, idx & 3
        if trailing_ones <= min(total_coeff, 3):
            yield lb, (total_coeff, trailing_ones)


# coeff_token VLCs: index by nC class 0..3, then the chroma DC variants
_CT_VLCS = [_build_vlc(_coeff_token_entries(t)) for t in COEFF_TOKEN]
_CT_CHROMA_DC = _build_vlc(_coeff_token_entries(CHROMA_DC_COEFF_TOKEN))
_CT_CHROMA422_DC = _build_vlc(_coeff_token_entries(CHROMA422_DC_COEFF_TOKEN))

_TZ_VLCS = [
    _build_vlc(((lb, tz) for tz, lb in enumerate(row))) for row in TOTAL_ZEROS_4x4
]
_TZ_CDC = [
    _build_vlc(((lb, tz) for tz, lb in enumerate(row))) for row in CHROMA_DC_TOTAL_ZEROS
]
_TZ_C422 = [
    _build_vlc(((lb, tz) for tz, lb in enumerate(row)))
    for row in CHROMA422_DC_TOTAL_ZEROS
]
_RB_VLCS = [_build_vlc(((lb, rb) for rb, lb in enumerate(row))) for row in RUN_BEFORE]


def read_vlc(r: BitReader, vlc) -> int:
    """Decode one codeword from a (table, max_len) prefix-free VLC."""
    table, max_len = vlc
    window = r.peek(max_len)
    for length in range(1, max_len + 1):
        code = window >> (max_len - length)
        hit = table.get((length, code))
        if hit is not None:
            r.skip(length)
            return hit
    raise BitReaderError(f"invalid VLC codeword (window={window:0{max_len}b})")


def coeff_token_vlc_for_nc(nc: int):
    if nc >= 8:
        return _CT_VLCS[3]
    if nc >= 4:
        return _CT_VLCS[2]
    if nc >= 2:
        return _CT_VLCS[1]
    if nc >= 0:
        return _CT_VLCS[0]
    if nc == -1:
        return _CT_CHROMA_DC
    return _CT_CHROMA422_DC


def residual_block_cavlc(
    r: BitReader,
    start_idx: int,
    end_idx: int,
    max_num_coeff: int,
    nc: int,
) -> tuple[list[int], int]:
    """residual_block_cavlc(), spec 9.2. Returns (coeffLevel[max_num_coeff]
    in scan order, TotalCoeff). `nc` is the coded-block context per 9.2.1
    (-1 chroma DC 4:2:0, -2 chroma DC 4:2:2)."""
    coeff = [0] * max_num_coeff
    total_coeff, trailing_ones = read_vlc(r, coeff_token_vlc_for_nc(nc))
    if total_coeff == 0:
        return coeff, 0

    levels = [0] * total_coeff
    # trailing one signs (9.2.2)
    for i in range(trailing_ones):
        levels[i] = -1 if r.u(1) else 1
    suffix_length = 1 if (total_coeff > 10 and trailing_ones < 3) else 0
    for i in range(trailing_ones, total_coeff):
        # level_prefix: count of leading zeros before a 1 (9.2.2.1)
        level_prefix = 0
        while r.u(1) == 0:
            level_prefix += 1
            if level_prefix > 32:
                raise BitReaderError("level_prefix too long")
        if level_prefix >= 15:
            suffix_size = level_prefix - 3
        elif level_prefix == 14 and suffix_length == 0:
            suffix_size = 4
        else:
            suffix_size = suffix_length
        level_suffix = r.u(suffix_size) if suffix_size > 0 else 0
        level_code = (min(15, level_prefix) << suffix_length) + level_suffix
        if level_prefix >= 15 and suffix_length == 0:
            level_code += 15
        if level_prefix >= 16:
            level_code += (1 << (level_prefix - 3)) - 4096
        if i == trailing_ones and trailing_ones < 3:
            level_code += 2
        if level_code % 2 == 0:
            levels[i] = (level_code + 2) >> 1
        else:
            levels[i] = (-level_code - 1) >> 1
        if suffix_length == 0:
            suffix_length = 1
        if abs(levels[i]) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    # total_zeros (9.2.3)
    if total_coeff < end_idx - start_idx + 1:
        if max_num_coeff == 4:
            tz_vlc = _TZ_CDC[total_coeff - 1]
        elif max_num_coeff == 8:
            tz_vlc = _TZ_C422[total_coeff - 1]
        else:
            tz_vlc = _TZ_VLCS[total_coeff - 1]
        zeros_left = read_vlc(r, tz_vlc)
    else:
        zeros_left = 0

    runs = [0] * total_coeff
    for i in range(total_coeff - 1):
        if zeros_left > 0:
            run = read_vlc(r, _RB_VLCS[min(zeros_left, 7) - 1])
        else:
            run = 0
        runs[i] = run
        zeros_left -= run
    runs[total_coeff - 1] = zeros_left

    coeff_num = -1
    for i in range(total_coeff - 1, -1, -1):
        coeff_num += runs[i] + 1
        coeff[start_idx + coeff_num] = levels[i]
    return coeff, total_coeff


def nc_from_neighbors(na: int | None, nb: int | None) -> int:
    """spec 9.2.1: nC from left (nA) and top (nB) block TotalCoeffs.
    None = neighbor unavailable."""
    if na is not None and nb is not None:
        return (na + nb + 1) >> 1
    if na is not None:
        return na
    if nb is not None:
        return nb
    return 0
