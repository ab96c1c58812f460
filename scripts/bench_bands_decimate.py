"""Bands-block decimation experiment (run on the accelerator).

Times the engine's rt60-bands block with and without spectrum-crop
decimation (EngineConfig.bands_decimate) on the production chunk shape —
(16, 2, 2^20) samples, three-band and third-octave modes. The decimated
path inverse-transforms each band at N/k (Low 32x, Mid 4x shorter at the
default edges) and runs its EDC + fits on the same smaller planes; see
ops/fftmask.band_decimation_factors for the exactness argument and
tests/test_bands_decimate.py for the parity bounds.

Timing: host clock around work that ends in block_until_ready, best-of-N.

Usage: python scripts/bench_bands_decimate.py [--small]
       (JAX_PLATFORMS=cpu with --small for a CPU smoke run)
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from audio_analysis_tpu.engine import EngineConfig  # noqa: E402
from audio_analysis_tpu.engine.batch import analyze_batch  # noqa: E402
from audio_analysis_tpu.ops import fftmask  # noqa: E402

CHUNK, C, N = 16, 2, 1 << 20
REPEATS = 4
RT60 = 1.2

if "--small" in sys.argv:  # CPU smoke: correctness wiring, not perf
    CHUNK, N, REPEATS = 2, 1 << 17, 1
    RT60 = 0.25  # the short signal must still reach the -35 dB crossing


def main():
    key = jax.random.PRNGKey(0)
    t = jnp.arange(N) / 48_000.0
    samples = 0.05 * jax.random.normal(key, (CHUNK, C, N), jnp.float32)
    samples = samples * 10.0 ** (-3.0 * t / RT60)
    samples = samples.at[:, :, 256].set(0.9)
    length = jnp.full((CHUNK,), N, jnp.int32)
    _ = float(samples[0, 0, 5])  # materialise before timing

    for band_mode in ("three", "third"):
        masks = fftmask.build_band_mask_matrix(
            fftmask.build_three_band_definitions(48_000)
            if band_mode == "three"
            else fftmask.build_fractional_octave_band_definitions(48_000, 3),
            N,
            48_000,
            1.0 / 6.0,
        )
        factors = fftmask.band_decimation_factors(masks, N)
        print(f"[{band_mode}] bands={masks.shape[0]} factors={factors}")

        results = {}
        for label, decimate in (("full-rate", False), ("decimated", True)):
            config = EngineConfig(
                band_mode=band_mode,
                bands_decimate=decimate,
                run_stft=False,
                run_modal=False,
                run_diffusion=False,
                run_fr=False,
                run_group_delay=False,
            )
            out = analyze_batch(samples, length, config)  # compile + run
            _ = float(out["band_t30_rt60"][0, 0, 0])
            best = float("inf")
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                out = analyze_batch(samples, length, config)
                _ = float(jnp.sum(out["band_t30_rt60"]) + jnp.sum(out["band_t20_rt60"]))
                best = min(best, time.perf_counter() - t0)
            results[label] = (
                best,
                np.asarray(out["band_t30_rt60"]),
                np.asarray(out["band_t30_ok"]),
            )
            print(f"  {label:10s} {best * 1e3:8.1f} ms")

        base_t, base_rt, base_ok = results["full-rate"]
        dec_t, dec_rt, dec_ok = results["decimated"]
        # compare only fits that are ok on both paths AND physically
        # meaningful for the fixture (broadband-noise narrowband EDCs in
        # marginal bands produce garbage fits whose crossings flip under
        # ANY perturbation)
        finite = base_ok & dec_ok & (base_rt > 0.1 * RT60) & (base_rt < 3.0 * RT60)
        if finite.any():
            rel = np.max(
                np.abs(dec_rt[finite] - base_rt[finite]) / np.maximum(base_rt[finite], 1e-6)
            )
            rel_text = f"{rel:.2e}"
        else:  # every fit failed the conditioning filter (can happen --small)
            rel_text = "n/a (no conditioned fits)"
        print(f"  speedup {base_t / dec_t:.2f}x   max T30 rel diff (conditioned fits) {rel_text}")


if __name__ == "__main__":
    main()
