"""Test configuration: force the CPU backend with 8 virtual devices so
multi-chip sharding logic is exercised without a pod (SURVEY.md section 4).

Must run before any `import jax` in test modules.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc (skips without one)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def make_test_frames(n, h, w, seed=0):
    """Synthetic YUV420 frames with enough structure to exercise intra+inter."""
    rng = np.random.default_rng(seed)
    frames = []
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        y = (
            (128 + 60 * np.sin(xx / 7.0 + i * 0.8) * np.cos(yy / 9.0))
            + rng.normal(0, 6, (h, w))
            + (xx + yy + 4 * i) % 32
        )
        y = np.clip(y, 0, 255).astype(np.uint8)
        cb = np.clip(
            110 + 40 * np.sin(np.mgrid[0 : h // 2, 0 : w // 2][1] / 11.0 + i),
            0,
            255,
        ).astype(np.uint8)
        cr = np.clip(
            120 + 45 * np.cos(np.mgrid[0 : h // 2, 0 : w // 2][0] / 13.0 - i * 0.5),
            0,
            255,
        ).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


@pytest.fixture(scope="session")
def test_frames_64():
    return make_test_frames(5, 64, 64)


@pytest.fixture(scope="session")
def test_frames_qcif():
    return make_test_frames(5, 144, 176)
