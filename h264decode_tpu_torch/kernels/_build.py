"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain C
interface, loaded with ctypes: no PyTorch headers are included, so a build
takes seconds. Libraries go to h264decode_tpu_torch/_build/ under a name that
carries a hash of the flags, the source and the shared csrc/*.cuh headers;
nothing is built when this module is imported, only at the first launch (or
by `build_all`).

The C entry points take every pointer (and the CUDA stream) as `void *`; the
Python wrappers declare them with ctypes.c_void_p and pass
`tensor.data_ptr()` and `torch.cuda.current_stream().cuda_stream`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from contextlib import contextmanager

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

#: kernel launches by wrapper name: each wrapper adds one where it launches
#: its kernel (one ctypes call = one C entry call per frame), and nowhere
#: else; a launch given halo rows (row-band sharding) counts under the name
#: + "_halo"
launches: Counter = Counter()
#: device kernels by wrapper name: each wrapper adds the number of <<<>>>
#: launches its C entry reports having issued (1 for a persistent row
#: wavefront)
device_kernels: Counter = Counter()
_count_lock = threading.Lock()
# a thread that captures a CUDA graph counts its wrappers' calls apart
# (counted_apart): a captured launch runs only when the graph is replayed
_capturing = threading.local()

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def sources() -> list[str]:
    """Kernel source names (csrc/<name>.cu)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def lib_path(name: str) -> str:
    """Where csrc/<name>.cu builds to: the name carries a hash of the flags,
    the source and every csrc/*.cuh header (any of which it may include)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        h.update(f.encode())
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start one nvcc (into a private temp name); returns (proc, tmp, path)."""
    path = lib_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v",
           os.path.join(CSRC, f"{name}.cu"), "-o", tmp]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path, cmd


def _finish(name: str, proc, tmp: str, path: str, cmd) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu: {' '.join(cmd)}\n{out}"
        )
    os.replace(tmp, path)
    return out


def build_all() -> tuple[float, dict[str, str]]:
    """Compile every csrc/*.cu that is not built yet, one nvcc per source,
    all started together. Returns (seconds, {name: nvcc -Xptxas -v output})."""
    t0 = time.time()
    with _lock:
        jobs = {n: _start(n) for n in sources() if not os.path.exists(lib_path(n))}
        logs = {n: _finish(n, *job) for n, job in jobs.items()}
    return time.time() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not os.path.exists(path):
                _finish(name, *_start(name))
            lib = _libs[name] = ctypes.CDLL(path)
        return lib


def launch(name: str, entry, *args) -> None:
    """Call the C entry point of wrapper `name` as entry(*args, &n), where
    it stores in n the number of device kernels it launched. Counts the call
    in `launches` and n in `device_kernels` (inside counted_apart, in its
    pair), then raises if the entry returned a non-zero cudaError_t."""
    n = ctypes.c_int(0)
    err = entry(*args, ctypes.addressof(n))
    apart = getattr(_capturing, "counts", None)
    calls, kernels = apart if apart is not None else (launches, device_kernels)
    with _count_lock:  # wrappers launch from several threads (dist/gop.py)
        calls[name] += 1
        kernels[name] += n.value
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def add_counts(calls: Counter, kernels: Counter) -> None:
    """Add wrapper calls to `launches` and their device kernels to
    `device_kernels` (a CUDA graph's replay adds what its capture counted)."""
    with _count_lock:
        launches.update(calls)
        device_kernels.update(kernels)


@contextmanager
def counted_apart():
    """Inside, this thread's wrapper calls are counted into the yielded
    (calls, device kernels) pair of Counters and not into `launches` and
    `device_kernels`: a CUDA graph capture records launches that run only
    at its replays, each of which adds the pair (add_counts)."""
    counts = (Counter(), Counter())
    _capturing.counts = counts
    try:
        yield counts
    finally:
        _capturing.counts = None


def ptr(t):
    """The device pointer of an optional input tensor (None: a null pointer)."""
    return None if t is None else t.data_ptr()


def check_tensor(t, shape, dtype, name: str) -> None:
    """Raise unless t is a contiguous CUDA tensor of this dtype and shape."""
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous CUDA {dtype} tensor of shape {tuple(shape)}, "
            f"got {t.device} {t.dtype} {tuple(t.shape)}"
        )
