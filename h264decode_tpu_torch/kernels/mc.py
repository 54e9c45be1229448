"""Motion compensation (spec 8.4.2.2/8.4.2.3), plain torch on unpacked planes.

Counterpart of h264decode_tpu/kernels/mc.py. Each reference picture keeps
its three half-pel planes (b, h, j) beside the integer plane G, computed
once by separable 6-tap filters over the edge-padded frame; prediction is
then per-pixel gathers from that {G, b, h, j} stack plus quarter-pel
averaging selected by the MV fraction (Table 8-12), and a generalized
weighted combine.

The JAX package stores the ring pair-packed (two columns per word, two
phase copies) because of TPU gather costs; here the ring is the plain stack
[R, 4, H+2*PAD, W+2*PAD] (chroma [R, 2, Hc+2*PAD, Wc+2*PAD]) of uint8
samples at 8 bits and int16 samples above (up to 14 bits fit; torch has no
CPU arithmetic on uint16). Column reads past the right margin clamp to the
last column, which is the value the packed layout's edge padding holds
there, so the results are identical.

Every gather index is clamped explicitly: torch does not clamp
out-of-range indices. All arithmetic is int32.
"""

from __future__ import annotations

import numpy as np
import torch

from .device_tables import device_table

PAD = 8  # flat-extension margin; any value >= 4 is exact (see oracle clamping)


def _edge_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Indices into an axis of length n that replicate its edges."""
    return torch.clamp(torch.arange(-before, n + after, device=device), 0, n - 1)


def _edge_pad(a: torch.Tensor, top: int, bottom: int, left: int, right: int):
    """Edge-replicating pad of the last two dims (integer-safe)."""
    h, w = a.shape[-2], a.shape[-1]
    rows = _edge_index(h, top, bottom, a.device)
    cols = _edge_index(w, left, right, a.device)
    return a[..., rows, :][..., :, cols]


def _filt6(a0, a1, a2, a3, a4, a5):
    return a0 - 5 * a1 + 20 * a2 + 20 * a3 - 5 * a4 + a5


def sample_dtype(mx: int) -> torch.dtype:
    """The port's sample dtype for Clip1 ceiling mx: uint8 at 8 bits, int16
    above."""
    return torch.uint8 if mx == 255 else torch.int16


def half_pel_planes(ref: torch.Tensor, mx: int = 255) -> torch.Tensor:
    """ref: [H, W] -> [4, H+2*PAD, W+2*PAD] stack (G, b, h, j) in
    sample_dtype(mx); the filter outputs Clip1 at mx.

    b = horizontal half-pel (right of G), h = vertical half-pel (below G),
    j = center half-pel, over the edge-replicated canvas so any MV (after
    coordinate clamping into the padded range) is exact."""
    ge = _edge_pad(ref.to(torch.int32), PAD + 2, PAD + 3, PAD + 2, PAD + 3)
    g = ge[2:-3, 2:-3]
    b_raw = _filt6(
        ge[:, 0:-5], ge[:, 1:-4], ge[:, 2:-3], ge[:, 3:-2], ge[:, 4:-1], ge[:, 5:]
    )  # [H+2P+5, W+2P]
    b = torch.clamp((b_raw[2:-3] + 16) >> 5, 0, mx)
    h_raw = _filt6(ge[0:-5], ge[1:-4], ge[2:-3], ge[3:-2], ge[4:-1], ge[5:])
    h = torch.clamp((h_raw[:, 2:-3] + 16) >> 5, 0, mx)
    j_raw = _filt6(
        b_raw[0:-5], b_raw[1:-4], b_raw[2:-3], b_raw[3:-2], b_raw[4:-1], b_raw[5:]
    )
    j = torch.clamp((j_raw + 512) >> 10, 0, mx)
    return torch.stack([g, b, h, j]).to(sample_dtype(mx))


def chroma_pad(ref: torch.Tensor) -> torch.Tensor:
    """[Hc, Wc] -> edge-padded [Hc+2*PAD, Wc+2*PAD] (same dtype)."""
    return _edge_pad(ref, PAD, PAD, PAD, PAD)


# Table 8-12 quarter-sample selection as 2 samples from the {G,b,h,j} stack:
# per frac class (fx + 4*fy): (plane1, dy1, dx1, plane2, dy2, dx2, single).
# The predicted sample is s1 when single, else (s1 + s2 + 1) >> 1.
QPEL_TAB = np.array(
    [
        (0, 0, 0, 0, 0, 0, 1),  # G
        (0, 0, 0, 1, 0, 0, 0),  # avg(G, b)
        (1, 0, 0, 1, 0, 0, 1),  # b
        (1, 0, 0, 0, 0, 1, 0),  # avg(b, G[x+1])
        (0, 0, 0, 2, 0, 0, 0),  # avg(G, h)
        (1, 0, 0, 2, 0, 0, 0),  # avg(b, h)
        (1, 0, 0, 3, 0, 0, 0),  # avg(b, j)
        (1, 0, 0, 2, 0, 1, 0),  # avg(b, h[x+1])
        (2, 0, 0, 2, 0, 0, 1),  # h
        (2, 0, 0, 3, 0, 0, 0),  # avg(h, j)
        (3, 0, 0, 3, 0, 0, 1),  # j
        (2, 0, 1, 3, 0, 0, 0),  # avg(h[x+1], j)
        (2, 0, 0, 0, 1, 0, 0),  # avg(h, G[y+1])
        (2, 0, 0, 1, 1, 0, 0),  # avg(h, b[y+1])
        (1, 1, 0, 3, 0, 0, 0),  # avg(b[y+1], j)
        (2, 0, 1, 1, 1, 0, 0),  # avg(h[x+1], b[y+1])
    ],
    np.int64,
)


def luma_mc(
    ring: torch.Tensor,  # [R, 4, Hp, Wp] half-pel stacks
    slot: torch.Tensor,  # [H4, W4] int32 (valid where >= 0)
    mv: torch.Tensor,  # [H4, W4, 2] int32 quarter-pel
    H: int,
    W: int,
    need_s2: bool = True,  # False when every MV component is even: Table
    #                        8-12 then always selects a single plane sample
) -> torch.Tensor:
    """Per-pixel luma prediction [H, W] int32 for one reference list.

    Coordinates follow the JAX version exactly: the integer position of
    each 4-pixel cell row is clamped into the padded canvas once, then the
    four pixels read consecutive columns (clamped to the last column)."""
    dev = ring.device
    Hp, Wp = ring.shape[-2], ring.shape[-1]
    RH, RW = Hp - 2 * PAD, Wp - 2 * PAD
    flat = ring.reshape(-1)
    W4 = W // 4
    plane_sz = Hp * Wp
    mv = mv.to(torch.int64)
    frac = ((mv[..., 0] & 3) + 4 * (mv[..., 1] & 3))  # [H4, W4]
    t = device_table(QPEL_TAB, dev)[frac]  # [H4, W4, 7]
    t = t.repeat_interleave(4, dim=0)  # [H, W4, 7]
    R = ring.shape[0]
    base = torch.clamp(slot.to(torch.int64), 0, R - 1) * (4 * plane_sz)
    base = base.repeat_interleave(4, dim=0)  # [H, W4]
    mvx = mv[..., 0].repeat_interleave(4, dim=0)
    mvy = mv[..., 1].repeat_interleave(4, dim=0)
    yy = torch.arange(H, device=dev)[:, None]
    xx0 = (torch.arange(W4, device=dev) * 4)[None, :]
    xi = torch.clamp(xx0 + (mvx >> 2), -PAD, RW - 1 + PAD) + PAD
    yi = torch.clamp(yy + (mvy >> 2), -PAD, RH - 1 + PAD) + PAD
    k = torch.arange(4, device=dev)

    def sample(plane, dy, dx):  # -> [H, W4, 4]
        y = torch.clamp(yi + dy, max=Hp - 1)
        x = torch.clamp(xi + dx, max=Wp - 1)
        cols = torch.clamp(x[..., None] + k, max=Wp - 1)
        idx = (base + plane * plane_sz + y * Wp)[..., None] + cols
        return flat[idx].to(torch.int32)

    s1 = sample(t[..., 0], t[..., 1], t[..., 2])
    if not need_s2:
        return s1.reshape(H, W)
    s2 = sample(t[..., 3], t[..., 4], t[..., 5])
    out = torch.where(t[..., 6:7] == 1, s1, (s1 + s2 + 1) >> 1)
    return out.reshape(H, W)


def chroma_mc_pair(
    ring: torch.Tensor,  # [R, 2, Hpc, Wpc] padded Cb/Cr samples
    slot: torch.Tensor,  # [H4, W4] int32 (luma-cell granularity)
    mv: torch.Tensor,  # [H4, W4, 2] int32 quarter-pel luma MV
    Hc: int,
    Wc: int,
    chroma_array_type: int = 1,
):
    """Eighth-pel bilinear prediction of both chroma components (spec
    8.4.2.2.2). 4:2:0 halves the rows (2 chroma rows per luma cell, eighth-
    pel vertical MV); 4:2:2 keeps them (4 rows per cell, yIntC = mv >> 2,
    yFracC = (mv & 3) << 1). The two pixels of a chroma cell row share one
    MV and read source columns (x, x+1) and (x+1, x+2) from a cell position
    clamped once, as in the JAX version. Returns (pred_cb, pred_cr) int32
    planes."""
    dev = ring.device
    Hp, Wp = ring.shape[-2], ring.shape[-1]
    RH, RW = Hp - 2 * PAD, Wp - 2 * PAD
    flat = ring.reshape(-1)
    Wc2 = Wc // 2  # == W4: one luma 4x4 cell <-> one chroma cell column
    plane_sz = Hp * Wp
    mv = mv.to(torch.int64)
    R = ring.shape[0]
    rv = 4 if chroma_array_type == 2 else 2  # chroma rows per luma cell
    sl = torch.clamp(slot.to(torch.int64), 0, R - 1).repeat_interleave(rv, dim=0)
    mvx = mv[..., 0].repeat_interleave(rv, dim=0)  # [Hc, Wc2]
    mvy = mv[..., 1].repeat_interleave(rv, dim=0)
    yy = torch.arange(Hc, device=dev)[:, None]
    xx0 = (torch.arange(Wc2, device=dev) * 2)[None, :]
    xi = torch.clamp(xx0 + (mvx >> 3), -PAD, RW - 1 + PAD) + PAD
    if chroma_array_type == 2:
        yi = torch.clamp(yy + (mvy >> 2), -PAD, RH - 1 + PAD) + PAD
        fy = ((mvy & 3) << 1)[..., None]
    else:
        yi = torch.clamp(yy + (mvy >> 3), -PAD, RH - 1 + PAD) + PAD
        fy = (mvy & 7)[..., None]
    yi1 = torch.clamp(yi + 1, max=Hp - 1)
    fx = (mvx & 7)[..., None]
    k = torch.arange(3, device=dev)
    cols = torch.clamp(xi[..., None] + k, max=Wp - 1)  # [Hc, Wc2, 3]
    out = []
    for comp in range(2):
        b = (sl * 2 + comp) * plane_sz
        top = flat[(b + yi * Wp)[..., None] + cols].to(torch.int32)
        bot = flat[(b + yi1 * Wp)[..., None] + cols].to(torch.int32)
        a, bb = top[..., 0:2], top[..., 1:3]  # pixel p reads cols p, p+1
        c, d = bot[..., 0:2], bot[..., 1:3]
        pred = ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * bb
                + (8 - fx) * fy * c + fx * fy * d + 32) >> 6
        out.append(pred.to(torch.int32).reshape(Hc, Wc))
    return out[0], out[1]


def weighted_combine(p0, p1, use0, use1, w0, o0, w1, o1, log_wd, mx: int = 255):
    """Generalized spec 8.4.2.3 combine: bi uses (p0*w0 + p1*w1 + 2^lwd) >>
    (lwd+1) + (o0+o1+1)>>1; uni the one-sided formula. Identity weights
    (w=32, o=0, logWD=5) make unweighted prediction fall out exactly.
    Weight arguments are int32 tensors or Python ints."""
    def as_t(v):  # a Python int becomes a filled scalar: no host-to-device copy
        if torch.is_tensor(v):
            return v.to(device=p0.device, dtype=torch.int32)
        return torch.full((), v, dtype=torch.int32, device=p0.device)

    w0, o0, w1, o1, log_wd = (as_t(v) for v in (w0, o0, w1, o1, log_wd))
    bi = use0 & use1
    p = torch.where(use0, p0, p1)
    w = torch.where(use0, w0, w1)
    rnd = torch.ones_like(log_wd) << torch.clamp(log_wd - 1, min=0)
    uni = torch.where(log_wd >= 1, (p * w + rnd) >> log_wd, p * w)
    uni = uni + torch.where(use0, o0, o1)
    bi_val = ((p0 * w0 + p1 * w1 + (torch.ones_like(log_wd) << log_wd))
              >> (log_wd + 1)) + ((o0 + o1 + 1) >> 1)
    return torch.clamp(torch.where(bi, bi_val, uni), 0, mx)
