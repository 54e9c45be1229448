"""Multi-process runtime: torch.distributed initialization and the global
mesh.

Counterpart of h264decode_tpu/dist/multihost.py. GOP data parallelism maps
across processes (closed GOPs exchange nothing during decode: only the work
assignment, which every process derives from the same stream scan, and the
output touch more than one process), while the "row" axis stays inside each
process (dist/mesh.py). The process group runs gloo between CPU devices and
NCCL between CUDA devices; its store also carries coordination_barrier.

Shape of a run (tests/test_torch_dist.py): two processes, each with its own
devices, form a ("gop" x "row") mesh whose gop axis spans the processes;
each process entropy-decodes and reconstructs its own GOPs (dist/gop.py).
"""

from __future__ import annotations

import os
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from .mesh import Mesh, visible_devices

_store = None  # the process group's TCPStore (coordination_barrier)
_device_type = "cpu"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device: str | None = None,
               timeout_s: float = 600.0) -> None:
    """Join the process group. The arguments fall back to the
    H264_TPU_COORDINATOR ("host:port", where process 0 listens),
    H264_TPU_NPROCS and H264_TPU_PROC environment variables. device: the
    device type of this process's mesh, "cuda" (NCCL) or "cpu" (gloo);
    default cuda when a CUDA device is visible."""
    global _store, _device_type
    coordinator_address = coordinator_address or os.environ.get("H264_TPU_COORDINATOR")
    if num_processes is None and "H264_TPU_NPROCS" in os.environ:
        num_processes = int(os.environ["H264_TPU_NPROCS"])
    if process_id is None and "H264_TPU_PROC" in os.environ:
        process_id = int(os.environ["H264_TPU_PROC"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("multihost.initialize: give the coordinator address, the number of "
                         "processes and this process's index (or H264_TPU_COORDINATOR, "
                         "H264_TPU_NPROCS, H264_TPU_PROC)")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    _device_type = torch.device(device).type
    host, port = coordinator_address.rsplit(":", 1)
    timeout = timedelta(seconds=timeout_s)
    _store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                           timeout=timeout)
    dist.init_process_group("nccl" if _device_type == "cuda" else "gloo", store=_store,
                            rank=process_id, world_size=num_processes, timeout=timeout)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_mesh(n_row: int | None = None, devices=None) -> Mesh:
    """("gop", "row") mesh over every process's devices: gop spans the
    processes, row spans each process's local devices (`devices`, default
    the visible CUDA devices; every process has as many). Gop slots are
    process-major: slot p * g + i lives on process p. A slot of another
    process lists that process's devices under the names they have there."""
    n_proc = process_count()
    local = visible_devices() if devices is None else [torch.device(d) for d in devices]
    n_local = len(local)
    if n_row is None:
        n_row = n_local
    assert n_local % n_row == 0, (n_local, n_row)
    per_proc = n_local // n_row
    rows = [local[i * n_row : (i + 1) * n_row] for i in range(per_proc)]
    mesh = Mesh(rows * n_proc)
    if n_proc > 1:
        # form the collective transport now with one tiny all-reduce: NCCL
        # communicators, like gloo cliques, are set up at the first
        # collective, and a first collective behind minutes of per-rank
        # work would rendezvous under skew
        t = torch.ones(1, device=local[0] if _device_type == "cuda" else "cpu")
        dist.all_reduce(t)
        assert int(t.item()) == n_proc, t
    return mesh


def coordination_barrier(name: str, timeout_ms: int = 600_000) -> None:
    """Rendezvous every process on the store (a key that each process
    increments, polled until it reaches the process count): unlike a
    collective, it tolerates any per-rank skew up to timeout_ms. No-op in
    a single process."""
    if _store is None:
        return
    key = f"h264/barrier/{name}"
    _store.add(key, 1)
    deadline = time.monotonic() + timeout_ms / 1e3
    while _store.add(key, 0) < process_count():
        if time.monotonic() > deadline:
            raise TimeoutError(f"coordination_barrier {name!r}: not every process arrived "
                               f"within {timeout_ms} ms")
        time.sleep(0.01)


def shutdown() -> None:
    """Leave the process group."""
    global _store
    if dist.is_initialized():
        dist.destroy_process_group()
    _store = None
