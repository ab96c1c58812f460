"""
mx frame-FFT matmul precision experiment (run on the accelerator).

On an H100 an f32 matmul at HIGHEST computes in full f32 on the CUDA cores;
HIGH and DEFAULT let it run as TF32 on the tensor cores (~10 mantissa
bits). The mx FFT's cost is almost entirely these stage matmuls, so a
lower precision is a candidate speedup on the engine's two frame-STFT
blocks (stft + modal) — IF the metric movement is acceptable. This script
measures both sides on the bench workload:

  per precision in {highest, high, default}:
    - stft+modal-only engine time (other blocks off), best-of-N
    - full-suite engine time, best-of-N
    - max metric deviation vs the "highest" baseline, per metric family

Timing: host clock around the call and a small scalar fetch, which waits
for the device to finish.
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from audio_analysis_tpu.engine import EngineConfig  # noqa: E402
from audio_analysis_tpu.engine.batch import (  # noqa: E402
    _flat_spec,
    analyze_batch_flat,
    unpack_flat,
)

CHUNK, C, N = 16, 2, 1 << 20
REPEATS = 4

if "--small" in sys.argv:  # CPU smoke: wiring, not perf
    CHUNK, N, REPEATS = 2, 1 << 15, 1


def _workload():
    key = jax.random.PRNGKey(7)
    t = jnp.arange(N, dtype=jnp.float32)
    samples = 0.05 * jax.random.normal(key, (CHUNK, C, N), jnp.float32)
    samples = samples * jnp.exp(-t / 200_000.0)
    lengths = jnp.full((CHUNK,), N, jnp.int32)
    _ = float(samples[0, 0, 5])  # materialise before timing
    return samples, lengths


def _timed(config, samples, lengths):
    flat = analyze_batch_flat(samples, lengths, config)  # compile + run
    _ = float(flat[0])
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        flat = analyze_batch_flat(samples, lengths, config)
        _ = float(jnp.sum(flat[::4097]))  # scalar fetch forces completion
        best = min(best, time.perf_counter() - t0)
    return best, flat


def main():
    samples, lengths = _workload()
    scopes = {
        "stft+modal": dict(
            run_bands=False, run_fr=False, run_group_delay=False, run_diffusion=False
        ),
        "full": {},
    }
    for scope_name, toggles in scopes.items():
        baseline = None
        for precision in ("highest", "high", "default"):
            config = EngineConfig(stft_fft_precision=precision, **toggles)
            best, flat = _timed(config, samples, lengths)
            spec = _flat_spec((CHUNK, C, N), (CHUNK,), config)
            out = unpack_flat(np.asarray(flat), spec)
            if baseline is None:
                baseline = out
                print(f"[{scope_name}] {precision:8s} {best * 1e3:8.1f} ms  (baseline)")
                continue
            worst = []
            for key in sorted(baseline):
                a = np.asarray(baseline[key], np.float64)
                b = np.asarray(out[key], np.float64)
                if a.dtype == bool or not np.issubdtype(a.dtype, np.floating):
                    diff = float(np.mean(a != b))
                    if diff:
                        worst.append((diff, f"{key} mismatch_frac={diff:.3g}"))
                    continue
                denom = np.maximum(np.nanmax(np.abs(a)), 1e-12)
                diff = float(np.nanmax(np.abs(a - b)) / denom)
                worst.append((diff, f"{key} rel={diff:.3g}"))
            worst.sort(reverse=True)
            top = ", ".join(w[1] for w in worst[:4])
            print(f"[{scope_name}] {precision:8s} {best * 1e3:8.1f} ms  top-dev: {top}")


if __name__ == "__main__":
    main()
