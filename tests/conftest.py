"""
Test configuration.

The suite runs on the CPU: `JAX_PLATFORMS=cpu python -m pytest tests/`.
The XLA flag below exposes 8 virtual CPU devices so mesh/sharding tests
can build multi-device meshes (they pass platform="cpu" to
engine.mesh.make_mesh). It must be set before jax is imported.

The accelerator path is exercised on the card by `python chip_smoke.py`.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
# No persistent compile cache for the suite or the processes it starts: a
# run would leave ~250 MB of CPU executables in the checkout's .jax_cache,
# and CPU executables are specific to the machine that compiled them.
os.environ.setdefault("JAX_ENABLE_COMPILATION_CACHE", "false")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long or timing-sensitive; excluded by -m 'not slow'"
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def synthetic_ir():
    """A ~1.5 s stereo synthetic reverb IR with known RT60 (host-generated)."""
    sr = 48_000
    n = 1 << 16  # 65536 samples = 1.365 s (pow2: no padding in kernels)
    rt60 = 0.8
    rng_local = np.random.default_rng(7)
    t = np.arange(n) / sr
    envelope = 10.0 ** (-3.0 * t / rt60)
    tail = 0.05 * rng_local.standard_normal((2, n)) * envelope
    onset = 480  # 10 ms
    ir = np.zeros((2, n), dtype=np.float64)
    ir[:, onset:] = tail[:, : n - onset]
    ir[:, onset] = 1.0
    return ir.astype(np.float32), sr, rt60, onset
