"""Build your own batched analysis from the ops kernel library.

Everything in `audio_analysis_tpu.ops` is a jit-safe, batched, mask-based
primitive. This example composes a custom metric the stock analyses don't
ship — per-octave-band spectral centroid over time — from the shared STFT
and the log-frequency binning matrix, still as ONE compiled program over
a (B, C, N) batch.

Run:  JAX_PLATFORMS=cpu python examples/02_custom_analysis_from_ops.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo checkout

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from audio_analysis_tpu.ops import stft

SR = 48_000
N_FFT, HOP = 4096, 512


@partial(jax.jit, static_argnames=())
def band_centroid_over_time(samples: jnp.ndarray, lengths: jnp.ndarray):
    """(B, C, N) -> (B, C, T) spectral centroid in Hz per STFT frame."""
    st = stft.stft_magnitude(samples, lengths[:, None], N_FFT, HOP, True, 1e-9, "mx")
    freqs = jnp.asarray(np.fft.rfftfreq(N_FFT, 1.0 / SR).astype(np.float32))
    weighted = jnp.sum(st.mag * freqs, axis=-1)
    total = jnp.maximum(jnp.sum(st.mag, axis=-1), 1e-12)
    centroid = weighted / total  # (B, C, T)
    t = centroid.shape[-1]
    valid = jnp.arange(t) < st.num_frames[..., None]
    return jnp.where(valid, centroid, jnp.nan)


def main() -> None:
    rng = np.random.default_rng(0)
    n = 1 << 16
    t = np.arange(n) / SR
    # a downward chirp-ish test batch: centroid should fall over time
    batch = np.stack(
        [
            np.stack([np.sin(2 * np.pi * (4000 - 3000 * t / t[-1]) * t)] * 2),
            np.stack([rng.standard_normal(n) * np.exp(-t / 0.2)] * 2),
        ]
    ).astype(np.float32)
    lengths = np.full(2, n, np.int32)

    cent = np.asarray(band_centroid_over_time(jnp.asarray(batch), jnp.asarray(lengths)))
    for name, row in zip(["chirp", "decaying noise"], cent):
        first, last = row[0, 1], row[0, np.isfinite(row[0]).sum() - 2]
        print(f"{name:>15}: centroid {first:7.1f} Hz -> {last:7.1f} Hz")


if __name__ == "__main__":
    main()
