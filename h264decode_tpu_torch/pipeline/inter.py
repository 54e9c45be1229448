"""Inter prediction: fractional sample interpolation (spec 8.4.2.2) and
weighted prediction (8.4.2.3) — numpy oracle.

The TPU path (kernels/mc.py) restructures this as whole-frame half-pel
plane precomputation (three separable 6-tap convolutions per reference,
MXU-friendly) followed by per-block gathers; this oracle computes per-block
windows exactly as the spec writes it.
"""

from __future__ import annotations

import numpy as np


def _filt6_h(w: np.ndarray) -> np.ndarray:
    """6-tap (1,-5,20,20,-5,1) along axis 1; output width = in - 5."""
    return (
        w[:, 0:-5] - 5 * w[:, 1:-4] + 20 * w[:, 2:-3] + 20 * w[:, 3:-2] - 5 * w[:, 4:-1] + w[:, 5:]
    )


def _filt6_v(w: np.ndarray) -> np.ndarray:
    return (
        w[0:-5] - 5 * w[1:-4] + 20 * w[2:-3] + 20 * w[3:-2] - 5 * w[4:-1] + w[5:]
    )


def luma_mc_block(
    ref: np.ndarray, x0: int, y0: int, w: int, h: int, mvx: int, mvy: int,
    mx: int = 255,
) -> np.ndarray:
    """Predict a w x h luma block at (x0, y0) with quarter-pel MV, spec
    8.4.2.2.1. `ref` is the unpadded reference plane; coordinates are
    edge-clamped (Clip3 on sample positions). `mx` = (1 << BitDepth) - 1."""
    H, W = ref.shape
    xi = x0 + (mvx >> 2)
    yi = y0 + (mvy >> 2)
    fx = mvx & 3
    fy = mvy & 3
    # window with 2 left/top and 3 right/bottom margin for the 6-tap filter
    ys = np.clip(np.arange(yi - 2, yi + h + 3), 0, H - 1)
    xs = np.clip(np.arange(xi - 2, xi + w + 3), 0, W - 1)
    win = ref[np.ix_(ys, xs)].astype(np.int32)  # [h+5, w+5]

    G = win[2 : 2 + h, 2 : 2 + w]
    if fx == 0 and fy == 0:
        return G
    # b: horizontal half-pel at integer rows; raw (un-normalised) for j
    b_raw_full = _filt6_h(win)  # [h+5, w]
    b = np.clip((b_raw_full[2 : 2 + h] + 16) >> 5, 0, mx)
    # h: vertical half-pel at integer columns
    h_raw_full = _filt6_v(win)  # [h, w+5]
    hh = np.clip((h_raw_full[:, 2 : 2 + w] + 16) >> 5, 0, mx)
    # j: half-half via vertical filter over raw b
    j_raw = _filt6_v(b_raw_full)  # [h, w]
    jj = np.clip((j_raw + 512) >> 10, 0, mx)
    # shifted integer/half samples used by quarter positions
    G1 = win[2 : 2 + h, 3 : 3 + w]  # G at x+1
    Gv = win[3 : 3 + h + 1, 2 : 2 + w][:h]  # G at y+1
    m = np.clip((h_raw_full[:, 3 : 3 + w] + 16) >> 5, 0, mx)  # h at x+1
    s = np.clip((b_raw_full[3 : 3 + h + 1][:h] + 16) >> 5, 0, mx)  # b at y+1

    def avg(a, b_):
        return (a + b_ + 1) >> 1

    table = {
        (0, 0): lambda: G,
        (1, 0): lambda: avg(G, b),
        (2, 0): lambda: b,
        (3, 0): lambda: avg(b, G1),
        (0, 1): lambda: avg(G, hh),
        (0, 2): lambda: hh,
        (0, 3): lambda: avg(hh, Gv),
        (1, 1): lambda: avg(b, hh),
        (3, 1): lambda: avg(b, m),
        (1, 3): lambda: avg(hh, s),
        (3, 3): lambda: avg(m, s),
        (2, 1): lambda: avg(b, jj),
        (2, 3): lambda: avg(s, jj),
        (1, 2): lambda: avg(hh, jj),
        (3, 2): lambda: avg(m, jj),
        (2, 2): lambda: jj,
    }
    return table[(fx, fy)]()


def chroma_mc_block(
    ref: np.ndarray, x0: int, y0: int, w: int, h: int, mvx: int, mvy: int
) -> np.ndarray:
    """Chroma 1/8-pel bilinear interpolation, spec 8.4.2.2.2 (4:2:0: the
    luma quarter-pel MV is used directly as a chroma eighth-pel MV)."""
    H, W = ref.shape
    xi = x0 + (mvx >> 3)
    yi = y0 + (mvy >> 3)
    fx = mvx & 7
    fy = mvy & 7
    ys = np.clip(np.arange(yi, yi + h + 1), 0, H - 1)
    xs = np.clip(np.arange(xi, xi + w + 1), 0, W - 1)
    win = ref[np.ix_(ys, xs)].astype(np.int32)
    A = win[:h, :w]
    B = win[:h, 1 : 1 + w]
    C = win[1 : 1 + h, :w]
    D = win[1 : 1 + h, 1 : 1 + w]
    return (
        (8 - fx) * (8 - fy) * A + fx * (8 - fy) * B + (8 - fx) * fy * C + fx * fy * D + 32
    ) >> 6


def weight_uni(pred: np.ndarray, w: int, o: int, log_wd: int,
               mx: int = 255) -> np.ndarray:
    """Explicit unidirectional weighted prediction, spec 8.4.2.3.2 (the
    caller pre-scales `o` by 1 << (BitDepth - 8))."""
    if log_wd >= 1:
        v = ((pred * w + (1 << (log_wd - 1))) >> log_wd) + o
    else:
        v = pred * w + o
    return np.clip(v, 0, mx)


def weight_bi(
    p0: np.ndarray, p1: np.ndarray, w0: int, w1: int, o0: int, o1: int,
    log_wd: int, mx: int = 255
) -> np.ndarray:
    """Bidirectional weighted prediction, spec 8.4.2.3.2."""
    v = ((p0 * w0 + p1 * w1 + (1 << log_wd)) >> (log_wd + 1)) + ((o0 + o1 + 1) >> 1)
    return np.clip(v, 0, mx)
