"""The device mesh of multi-device decoding: a ("gop", "row") grid of
torch.devices in one process.

Counterpart of h264decode_tpu/dist/mesh.py. The axes:
  "gop"  independent closed GOPs (data parallelism, dist/gop.py)
  "row"  macroblock row bands within a frame (dist/sharded.py)

As in the JAX package, one process drives the whole mesh (only
dist/multihost.py spans processes, along "gop"). Data moves between bands
as explicit Tensor.to(device) copies. A mesh may name one device more than
once: its bands then run one after another on that device, through the
same kernels and the same halo exchange, the counterpart of the JAX tests'
virtual CPU devices.
"""

from __future__ import annotations

import torch


class Mesh:
    """A [G, R] grid of torch.devices. `shape` maps "gop" and "row" to G and
    R, as a JAX mesh's does; row(g) is gop slot g's R band devices."""

    def __init__(self, grid):
        self.grid = tuple(tuple(torch.device(d) for d in row) for row in grid)
        if not self.grid or not self.grid[0] or len({len(r) for r in self.grid}) != 1:
            raise ValueError(f"mesh: need a non-empty rectangular grid, got {grid}")
        self.shape = {"gop": len(self.grid), "row": len(self.grid[0])}

    def row(self, g: int) -> tuple[torch.device, ...]:
        return self.grid[g]


def visible_devices() -> list[torch.device]:
    """The CUDA devices of this process; raises without one (the CPU is
    used only where the caller names it)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices=[torch.device('cpu'), "
                           "...] to build a mesh of CPU devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_gop: int | None = None, n_row: int | None = None, devices=None) -> Mesh:
    """A (n_gop x n_row) mesh over `devices` (default: the visible CUDA
    devices). Without both sizes, the JAX factoring rule: the largest power
    of two of rows that divides the device count, the rest on "gop".
    `devices` may repeat a device."""
    devs = visible_devices() if devices is None else [torch.device(d) for d in devices]
    n = len(devs)
    if n_gop is None or n_row is None:
        # favour the row axis over gop
        n_row = 1
        while n_row * 2 <= n and (n // (n_row * 2)) * (n_row * 2) == n:
            n_row *= 2
        n_row = min(n_row, n)
        n_gop = n // n_row
    assert n_gop * n_row <= n, f"mesh {n_gop}x{n_row} > {n} devices"
    return Mesh([devs[g * n_row : (g + 1) * n_row] for g in range(n_gop)])
