"""Constant host tables (numpy), copied to each device once.

A table copied to the device at every call costs a synchronous
host-to-device copy from pageable memory: the host waits until the device
has drained its queue, and a CUDA graph cannot capture the copy. The frame
program (pipeline/gpu_pipeline.frame_step) reads its constant tables from
here instead: the first call on a device copies them, later calls and graph
captures reuse the copy.
"""

from __future__ import annotations

import numpy as np
import torch

# (id of the table, device) -> (the table, its device copy); the table is
# kept so that its id is never reused while the entry lives
_copies: dict = {}


def device_table(a: np.ndarray, device) -> torch.Tensor:
    """The device copy of module-level constant table `a` (never mutated)."""
    key = (id(a), torch.device(device))
    hit = _copies.get(key)
    if hit is None:
        hit = _copies[key] = (a, torch.as_tensor(a, device=device))
    return hit[1]
