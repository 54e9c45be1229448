"""FMO slice-group maps, spec 8.2.2 — all seven map types.

The reference implements types 0-2 and leaves 3-6 TODO
(/root/reference/h264/slice.go:457-529); this is the complete set, and the
MB-to-slice-group map is computed once per picture instead of per MB (the
reference recomputes it per-MB, an accidental O(n^2): h264/slice.go:827,530).
"""

from __future__ import annotations

import numpy as np

from .pps import PPS
from .sps import SPS


def map_units_in_slice_group0(pps: PPS, slice_group_change_cycle: int, pic_size: int) -> int:
    """spec 7-32: MapUnitsInSliceGroup0."""
    rate = pps.slice_group_change_rate_minus1 + 1
    return min(slice_group_change_cycle * rate, pic_size)


def map_unit_to_slice_group_map(
    sps: SPS, pps: PPS, slice_group_change_cycle: int = 0
) -> np.ndarray:
    """mapUnitToSliceGroupMap per 8.2.2.1-8.2.2.7. For map types 3-5 the map
    depends on the per-slice slice_group_change_cycle."""
    w = sps.pic_width_in_mbs
    h = sps.pic_height_in_map_units
    size = w * h
    n = pps.num_slice_groups
    m = np.zeros(size, np.int32)
    if n == 1:
        return m
    t = pps.slice_group_map_type
    if t == 0:  # interleaved, 8.2.2.1
        i = 0
        while i < size:
            for g in range(n):
                run = pps.run_length_minus1[g] + 1
                for _ in range(run):
                    if i >= size:
                        break
                    m[i] = g
                    i += 1
    elif t == 1:  # dispersed, 8.2.2.2
        idx = np.arange(size)
        m = ((idx % w) + (((idx // w) * n) // 2)) % n
        m = m.astype(np.int32)
    elif t == 2:  # foreground + background, 8.2.2.3
        m[:] = n - 1
        for g in range(n - 2, -1, -1):
            y_tl, x_tl = divmod(pps.top_left[g], w)
            y_br, x_br = divmod(pps.bottom_right[g], w)
            for y in range(y_tl, min(y_br, h - 1) + 1):
                for x in range(x_tl, min(x_br, w - 1) + 1):
                    m[y * w + x] = g
    elif t == 3:  # box-out, 8.2.2.4
        g0 = map_units_in_slice_group0(pps, slice_group_change_cycle, size)
        d = int(pps.slice_group_change_direction_flag)
        m[:] = 1
        x = (w - d) // 2
        y = (h - d) // 2
        left, top, right, bottom = x, y, x, y
        xdir, ydir = d - 1, d
        k = 0
        while k < g0:
            vacant = m[y * w + x] == 1
            if vacant:
                m[y * w + x] = 0
                k += 1
            if xdir == -1 and x == left:
                left = max(left - 1, 0)
                x = left
                xdir, ydir = 0, 2 * d - 1
            elif xdir == 1 and x == right:
                right = min(right + 1, w - 1)
                x = right
                xdir, ydir = 0, 1 - 2 * d
            elif ydir == -1 and y == top:
                top = max(top - 1, 0)
                y = top
                xdir, ydir = 1 - 2 * d, 0
            elif ydir == 1 and y == bottom:
                bottom = min(bottom + 1, h - 1)
                y = bottom
                xdir, ydir = 2 * d - 1, 0
            else:
                x, y = x + xdir, y + ydir
    elif t == 4:  # raster scan, 8.2.2.5
        g0 = map_units_in_slice_group0(pps, slice_group_change_cycle, size)
        d = int(pps.slice_group_change_direction_flag)
        upper_left = size - g0 if d else g0
        idx = np.arange(size)
        m = np.where(idx < upper_left, d, 1 - d).astype(np.int32)
    elif t == 5:  # wipe, 8.2.2.6
        g0 = map_units_in_slice_group0(pps, slice_group_change_cycle, size)
        d = int(pps.slice_group_change_direction_flag)
        # columns scanned left->right, top->bottom; the first
        # sizeOfUpperLeftGroup units belong to group d, the rest to 1-d
        size_ul = size - g0 if d else g0
        k = 0
        for j in range(w):
            for i in range(h):
                m[i * w + j] = d if k < size_ul else 1 - d
                k += 1
    elif t == 6:  # explicit, 8.2.2.7
        ids = pps.slice_group_id
        for i in range(size):
            m[i] = ids[i] if i < len(ids) else 0
    else:
        raise ValueError(f"invalid slice_group_map_type {t}")
    return m


def mb_to_slice_group_map(
    sps: SPS, map_units: np.ndarray, field_pic_flag: bool, mbaff: bool
) -> np.ndarray:
    """MbToSliceGroupMap, spec 8.2.2.8."""
    w = sps.pic_width_in_mbs
    if sps.frame_mbs_only_flag or field_pic_flag:
        return map_units
    if mbaff:
        n = 2 * len(map_units)
        return map_units[np.arange(n) // 2]
    # frame picture of an interlace-capable stream without MBAFF
    h2 = sps.frame_height_in_mbs
    n = w * h2
    idx = np.arange(n)
    return map_units[(idx // (2 * w)) * w + (idx % w)]


def next_mb_address(mb_map: np.ndarray, addr: int) -> int:
    """nextMbAddress per 8.2.2 (fixed: the reference's loop condition is a
    tautology, h264/slice.go:548). Returns len(map) when no next MB exists."""
    group = mb_map[addr]
    i = addr + 1
    n = len(mb_map)
    while i < n and mb_map[i] != group:
        i += 1
    return i
