"""
Device parity (SURVEY §4): the SAME jitted engine program run on the
default backend and on the host CPU backend (computation follows the
data's device) must agree within f32 tolerance on every headline metric.
Catches backend-specific numeric drift (FFT implementations, fusion
differences).

Runs CPU-vs-CPU where the CPU is the default backend (still exercises the
two-placement path); chip_smoke.py makes the same comparison on the card.
"""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def small_batch():
    sr = 48_000
    n = 32_768
    rng = np.random.default_rng(17)
    t = np.arange(n) / sr
    x = np.zeros((2, 2, n), np.float32)
    for b, rt60 in enumerate((0.25, 0.4)):
        env = 10.0 ** (-3.0 * t / rt60)
        x[b, :, 64:] = 0.05 * rng.standard_normal((2, n - 64)) * env[: n - 64]
        x[b, :, 64] = 0.9
    return x, np.full(2, n, np.int32)


def test_engine_metrics_match_across_backends(small_batch):
    import jax

    from audio_analysis_tpu.engine import EngineConfig, analyze_batch

    x, lengths = small_batch
    config = EngineConfig()

    cpu = jax.devices("cpu")[0]
    out_cpu = analyze_batch(
        jax.device_put(x, cpu), jax.device_put(lengths, cpu), config
    )

    default_out = analyze_batch(jax.device_put(x), jax.device_put(lengths), config)

    checks = {
        "t30_rt60": (1e-3, 1e-4),
        "t20_rt60": (1e-3, 1e-4),
        "early10_time": (1e-3, 1e-4),
        "band_t30_rt60": (2e-3, 1e-3),
        "fr_peak_hz": (1e-6, 1.5),  # peak can hop one bin on FFT ties
        "fr_centroid_hz": (1e-3, 2.0),
        "gd_median": (2e-3, 0.5),
        "diff_median_autocorr": (1e-3, 2e-3),
        "diff_median_echo_density": (1e-3, 2e-3),
        "modal_median_rt60": (5e-3, 5e-3),
        "peak_abs": (1e-6, 1e-7),
    }
    for key, (rel, abs_) in checks.items():
        a = np.asarray(out_cpu[key], np.float64)
        b = np.asarray(default_out[key], np.float64)
        np.testing.assert_allclose(b, a, rtol=rel, atol=abs_, err_msg=key)
