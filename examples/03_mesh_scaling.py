"""Scale the fused engine over a device mesh (tap-data-parallel).

On real hardware `make_mesh()` picks up every card of the host; here the
example forces a virtual 4-device CPU mesh (the standard fake-multichip
setup) so it runs anywhere. The sharded step is a cached `jit(shard_map)`
— per-tap metrics need no cross-device traffic, so scaling is linear in
devices until the batch runs out.

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
          python examples/03_mesh_scaling.py
"""

import os

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo checkout

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import numpy as np

from audio_analysis_tpu.engine import EngineConfig, analyze_batch_sharded, make_mesh

SR = 48_000
N = 1 << 16


def main() -> None:
    mesh = make_mesh(num_devices=4, platform="cpu")
    print("mesh:", dict(zip(mesh.axis_names, mesh.devices.shape)))

    rng = np.random.default_rng(1)
    t = np.arange(N) / SR
    batch = (
        rng.standard_normal((8, 2, N)) * np.exp(-t / 0.4) * 0.5
    ).astype(np.float32)
    lengths = np.full(8, N, np.int32)

    # uneven batches are padded to the mesh size and trimmed transparently
    out = analyze_batch_sharded(mesh, batch, lengths, EngineConfig())
    print("t30_rt60 per tap (L):", np.round(out["t30_rt60"][:, 0], 3))


if __name__ == "__main__":
    main()
