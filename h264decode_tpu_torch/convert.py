"""Carry decoder state across from the JAX package's layouts to the port's.

This decoder has no weights; its state is the per-frame wire (the narrow
host tensors one frame's device program consumes, as the JAX package's
TpuDecoder._reconstruct builds them) and the DPB ring of reference planes.
With these functions the same frame can go through both frame programs.

The wire also crosses the host->device link in one staging buffer:
`pack_wire` lays every array out in one uint8 buffer (8-byte aligned, so
each array views back with its own dtype) and `unpack_wire` splits the
device copy again.
"""

from __future__ import annotations

import numpy as np
import torch

# uint16 (the PCM planes above 8 bits) arrives as int16: the same bits, and
# samples of up to 14 bits are non-negative there (torch has no CPU
# arithmetic on uint16)
_TORCH_DTYPE = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def wire_layout(wire: dict) -> tuple[int, list]:
    """(total bytes, [(key, offset, nbytes, np dtype, shape)]) for pack_wire."""
    off = 0
    layout = []
    for k, v in wire.items():
        v = np.asarray(v)
        if v.dtype not in _TORCH_DTYPE:
            raise TypeError(f"wire entry {k!r}: unsupported dtype {v.dtype}")
        layout.append((k, off, v.nbytes, v.dtype, v.shape))
        off += (v.nbytes + 7) & ~7
    return off, layout


def pack_wire(wire: dict, out: np.ndarray) -> list:
    """Copy every wire array into the uint8 buffer `out` (at least
    wire_layout(wire)[0] bytes); returns the layout."""
    _, layout = wire_layout(wire)
    for k, off, nb, dt, shape in layout:
        out[off : off + nb] = np.ascontiguousarray(wire[k], dt).reshape(-1).view(np.uint8)
    return layout


def unpack_wire(buf: torch.Tensor, layout: list) -> dict:
    """Split a packed uint8 buffer (on any device) back into typed tensors."""
    out = {}
    for k, off, nb, dt, shape in layout:
        out[k] = buf[off : off + nb].view(_TORCH_DTYPE[dt]).reshape(shape)
    return out


def dyn_to_torch(dyn: dict, device) -> dict:
    """The per-(SPS, PPS) constants: scaling-list tables -> int32 tensors;
    qp_offsets stays a tuple of ints."""
    out = {}
    for k, v in dyn.items():
        if k == "qp_offsets":
            out[k] = tuple(int(x) for x in v)
        else:
            out[k] = torch.as_tensor(np.array(v, np.int32), device=device)
    return out


def wire_from_numpy(wire: dict, dyn: dict, device="cpu") -> tuple[dict, dict]:
    """The JAX package's wire dict (numpy, as TpuDecoder._reconstruct builds
    it) and its `dyn` constants -> the port's frame_step inputs."""
    total, _ = wire_layout(wire)
    buf = np.zeros(max(total, 8), np.uint8)
    layout = pack_wire(wire, buf)
    t = torch.from_numpy(buf).to(device)
    return unpack_wire(t, layout), dyn_to_torch(dyn, device)


def ring_from_jax(ring_y, ring_cb, ring_cr=None,
                  device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Unpack the JAX package's pair-packed DPB ring (numpy) into the port's
    [R, 4, Hp, Wp] half-pel stacks and [R, 2, Hpc, Wpc] (Cb, Cr) planes.

    8-bit: luma [R, 4, 2, Hp, Wp//2+2] uint16 (two samples per word) and one
    chroma ring [R, 2, Hpc, Wpc//2+2] uint32 (Cb | Cr<<8 samples, two per
    word) -> uint8. Above 8 bits: luma uint32 words of two 16-bit samples,
    and separate Cb and Cr rings of the same kind (ring_cb, ring_cr) ->
    int16. 8-bit 4:4:4: ring_cb and ring_cr are luma-layout Cb and Cr
    rings [R, 4, 2, Hp, Wp//2+2] uint16 -> [R, 2, 4, Hp, Wp] uint8 half-pel
    stacks. Phase 0 of each ring holds the plain columns (word w: columns
    2w, 2w+1); 4:2:2 rings differ only in their height Hpc."""
    def unpair(r, bits):  # [..., H, Wk] words -> [..., H, 2*(Wk-2)] samples
        Wk = r.shape[-1]
        lo = r & ((1 << bits) - 1)
        return np.stack([lo, r >> bits], -1).reshape(*r.shape[:-1], 2 * Wk)[..., : 2 * (Wk - 2)]

    ry = np.asarray(ring_y)[:, :, 0]  # phase 0
    if np.ndim(ring_cb) == 5:  # 4:4:4 (8-bit): Cb and Cr half-pel stacks
        y = unpair(ry, 8).astype(np.uint8)
        c = np.stack([unpair(np.asarray(r)[:, :, 0], 8) for r in (ring_cb, ring_cr)],
                     1).astype(np.uint8)
    elif ry.dtype == np.uint16:  # 8-bit samples
        y = unpair(ry, 8).astype(np.uint8)
        c16 = unpair(np.asarray(ring_cb)[:, 0], 16)  # [R, Hpc, Wpc] Cb | Cr<<8
        c = np.stack([c16 & 0xFF, c16 >> 8], 1).astype(np.uint8)
    else:
        y = unpair(ry, 16).astype(np.int16)
        c = np.stack([unpair(np.asarray(r)[:, 0], 16) for r in (ring_cb, ring_cr)],
                     1).astype(np.int16)
    return torch.as_tensor(y, device=device), torch.as_tensor(c, device=device)
