"""Intra_8x8 luma prediction, spec 8.3.2 (High profile transform_8x8 path):
reference sample filtering (8.3.2.2.1) + the nine 8x8 prediction modes
(8.3.2.2.2-8.3.2.2.10). numpy oracle, mirrored by the TPU kernels."""

from __future__ import annotations

import numpy as np


def _filter_refs(left, top16, corner):
    """spec 8.3.2.2.1 reference sample filtering. top16 already includes the
    (possibly substituted) top-right 8 samples."""
    ft = fl = fc = None
    if top16 is not None:
        t = top16.astype(np.int64)
        ft = np.empty(16, np.int64)
        if corner is not None:
            ft[0] = (corner + 2 * t[0] + t[1] + 2) >> 2
        else:
            ft[0] = (3 * t[0] + t[1] + 2) >> 2
        for x in range(1, 15):
            ft[x] = (t[x - 1] + 2 * t[x] + t[x + 1] + 2) >> 2
        ft[15] = (t[14] + 3 * t[15] + 2) >> 2
    if left is not None:
        l = left.astype(np.int64)
        fl = np.empty(8, np.int64)
        if corner is not None:
            fl[0] = (corner + 2 * l[0] + l[1] + 2) >> 2
        else:
            fl[0] = (3 * l[0] + l[1] + 2) >> 2
        for y in range(1, 7):
            fl[y] = (l[y - 1] + 2 * l[y] + l[y + 1] + 2) >> 2
        fl[7] = (l[6] + 3 * l[7] + 2) >> 2
    if corner is not None:
        if top16 is not None and left is not None:
            fc = (int(top16[0]) + 2 * corner + int(left[0]) + 2) >> 2
        elif top16 is not None:
            fc = (3 * corner + int(top16[0]) + 2) >> 2
        elif left is not None:
            fc = (3 * corner + int(left[0]) + 2) >> 2
        else:
            fc = corner
    return fl, ft, fc


def intra8x8_predict(mode: int, left, top, topright, corner, mid: int = 128) -> np.ndarray:
    """left: 8 or None; top: 8 or None; topright: 8 (substituted if needed,
    None only when top is None); corner scalar or None. Returns [8,8] int32."""
    top16 = None
    if top is not None:
        top16 = np.concatenate([np.asarray(top), np.asarray(topright)])
    l, t, m = _filter_refs(
        np.asarray(left) if left is not None else None, top16, corner
    )
    p = np.zeros((8, 8), np.int64)
    if mode == 0:  # Vertical
        p[:, :] = t[None, :8]
    elif mode == 1:  # Horizontal
        p[:, :] = l[:, None]
    elif mode == 2:  # DC
        if t is not None and l is not None:
            dc = (int(np.sum(t[:8])) + int(np.sum(l)) + 8) >> 4
        elif t is not None:
            dc = (int(np.sum(t[:8])) + 4) >> 3
        elif l is not None:
            dc = (int(np.sum(l)) + 4) >> 3
        else:
            dc = mid
        p[:, :] = dc
    elif mode == 3:  # Diagonal Down-Left
        for y in range(8):
            for x in range(8):
                if x == 7 and y == 7:
                    p[y, x] = (t[14] + 3 * t[15] + 2) >> 2
                else:
                    k = x + y
                    p[y, x] = (t[k] + 2 * t[k + 1] + t[k + 2] + 2) >> 2
    elif mode == 4:  # Diagonal Down-Right
        for y in range(8):
            for x in range(8):
                if x > y:
                    k = x - y
                    a = t[k - 2] if k - 2 >= 0 else m
                    b = t[k - 1] if k - 1 >= 0 else m
                    p[y, x] = (a + 2 * b + t[k] + 2) >> 2
                elif x < y:
                    k = y - x
                    a = l[k - 2] if k - 2 >= 0 else m
                    b = l[k - 1] if k - 1 >= 0 else m
                    p[y, x] = (a + 2 * b + l[k] + 2) >> 2
                else:
                    p[y, x] = (t[0] + 2 * m + l[0] + 2) >> 2
    elif mode == 5:  # Vertical-Right
        for y in range(8):
            for x in range(8):
                z = 2 * x - y
                if z >= 0:
                    k = x - (y >> 1)
                    if z % 2 == 0:
                        a = t[k - 1] if k - 1 >= 0 else m
                        p[y, x] = (a + t[k] + 1) >> 1
                    else:
                        a = t[k - 2] if k - 2 >= 0 else m
                        b = t[k - 1] if k - 1 >= 0 else m
                        p[y, x] = (a + 2 * b + t[k] + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * m + t[0] + 2) >> 2
                else:
                    # spec: (p[-1, y-2x-1] + 2 p[-1, y-2x-2] + p[-1, y-2x-3] + 2) >> 2
                    i1, i2, i3 = y - 2 * x - 1, y - 2 * x - 2, y - 2 * x - 3
                    a = l[i1] if i1 >= 0 else m
                    b = l[i2] if i2 >= 0 else m
                    c = l[i3] if i3 >= 0 else m
                    p[y, x] = (a + 2 * b + c + 2) >> 2
    elif mode == 6:  # Horizontal-Down
        for y in range(8):
            for x in range(8):
                z = 2 * y - x
                if z >= 0:
                    k = y - (x >> 1)
                    if z % 2 == 0:
                        a = l[k - 1] if k - 1 >= 0 else m
                        p[y, x] = (a + l[k] + 1) >> 1
                    else:
                        a = l[k - 2] if k - 2 >= 0 else m
                        b = l[k - 1] if k - 1 >= 0 else m
                        p[y, x] = (a + 2 * b + l[k] + 2) >> 2
                elif z == -1:
                    p[y, x] = (t[0] + 2 * m + l[0] + 2) >> 2
                else:
                    i1, i2, i3 = x - 2 * y - 1, x - 2 * y - 2, x - 2 * y - 3
                    a = t[i1] if i1 >= 0 else m
                    b = t[i2] if i2 >= 0 else m
                    c = t[i3] if i3 >= 0 else m
                    p[y, x] = (a + 2 * b + c + 2) >> 2
    elif mode == 7:  # Vertical-Left
        for y in range(8):
            for x in range(8):
                k = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (t[k] + t[k + 1] + 1) >> 1
                else:
                    p[y, x] = (t[k] + 2 * t[k + 1] + t[k + 2] + 2) >> 2
    elif mode == 8:  # Horizontal-Up
        for y in range(8):
            for x in range(8):
                z = x + 2 * y
                if z > 13:
                    p[y, x] = l[7]
                elif z == 13:
                    p[y, x] = (l[6] + 3 * l[7] + 2) >> 2
                else:
                    k = y + (x >> 1)
                    if z % 2 == 0:
                        p[y, x] = (l[k] + l[k + 1] + 1) >> 1
                    else:
                        p[y, x] = (l[k] + 2 * l[k + 1] + l[k + 2] + 2) >> 2
    else:
        raise ValueError(f"bad intra8x8 mode {mode}")
    return p.astype(np.int32)
