"""Analyse a batch of in-memory impulse responses with the fused engine.

The CLI covers files on disk; this is the library path — e.g. IRs produced
inside your own DSP test harness. One jit-compiled program computes every
report metric for the whole batch.

Run (host-only works fine):  JAX_PLATFORMS=cpu python examples/01_batch_metrics.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo checkout

import numpy as np

from audio_analysis_tpu.engine import EngineConfig, analyze_bundle

SR = 48_000
N = 1 << 17  # ~2.7 s per IR


def synthetic_ir(rt60_seconds: float, seed: int) -> np.ndarray:
    """Noise with an exponential decay: EDC slope = -60/rt60 dB/s."""
    rng = np.random.default_rng(seed)
    t = np.arange(N) / SR
    envelope = 10.0 ** (-3.0 * t / rt60_seconds)  # -60 dB at rt60
    return (rng.standard_normal((2, N)) * envelope * 0.5).astype(np.float32)


def main() -> None:
    targets = [0.3, 0.8, 1.5, 2.5]
    batch = np.stack([synthetic_ir(rt, seed=i) for i, rt in enumerate(targets)])
    lengths = np.full(len(targets), N, np.int32)

    config = EngineConfig(band_mode="three")
    metrics = analyze_bundle(batch, lengths, config)  # dict of (B, C, ...) arrays

    print(f"{'target RT60':>12} {'T30 (L)':>9} {'T20 (L)':>9} {'EDT (L)':>9}")
    for i, rt in enumerate(targets):
        print(
            f"{rt:>11.2f}s"
            f" {metrics['t30_rt60'][i, 0]:>8.3f}s"
            f" {metrics['t20_rt60'][i, 0]:>8.3f}s"
            f" {metrics['edt_rt60'][i, 0]:>8.3f}s"
        )
    # every other metric family is in the same dict:
    families = sorted({k.split("_")[0] for k in metrics})
    print("metric families:", ", ".join(families))


if __name__ == "__main__":
    main()
