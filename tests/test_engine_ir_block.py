"""
Engine polish regressions:
- the engine emits IR-view stats (peak_abs) and the engine bundle summary
  contains the Impulse response block,
- stereo-only diffusion metrics (corr0/IACC) are gated on C==2: a mono
  batch must not emit them (the reference gates on actual stereo,
  diffusion.py:154-202).
"""

import numpy as np

from audio_analysis_tpu.engine import EngineConfig, analyze_batch


def _batch(c: int):
    import jax.numpy as jnp

    sr = 48_000
    n = 16_384
    rng = np.random.default_rng(3)
    t = np.arange(n) / sr
    env = 10.0 ** (-3.0 * t / 0.2)
    x = np.zeros((2, c, n), np.float32)
    x[:, :, 64:] = 0.05 * rng.standard_normal((2, c, n - 64)) * env[: n - 64]
    x[:, :, 64] = 0.9
    return jnp.asarray(x), jnp.asarray(np.full(2, n, np.int32))


def test_stereo_batch_has_corr0_and_peak_abs():
    samples, lengths = _batch(2)
    out = analyze_batch(samples, lengths, EngineConfig(run_modal=False, run_stft=False))
    assert "diff_median_corr0" in out and "diff_median_iacc" in out
    peak = np.asarray(out["peak_abs"])
    assert peak.shape == (2, 2)
    np.testing.assert_allclose(peak, 0.9, atol=1e-6)


def test_mono_batch_omits_stereo_diffusion_metrics():
    samples, lengths = _batch(1)
    out = analyze_batch(samples, lengths, EngineConfig(run_modal=False, run_stft=False))
    assert "diff_median_corr0" not in out
    assert "diff_median_iacc" not in out
    assert "diff_median_autocorr" in out  # per-channel metrics still there


def test_engine_bundle_summary_has_ir_block(tmp_path):
    from audio_analysis_tpu.io.bundle import write_bundle
    from audio_analysis_tpu.report.engine_report import run_bundle_report_engine

    sr = 48_000
    n = 16_384
    rng = np.random.default_rng(9)
    t = np.arange(n) / sr
    env = 10.0 ** (-3.0 * t / 0.2)
    x = np.zeros((n, 2), np.float32)
    x[64:, :] = (0.05 * rng.standard_normal((n - 64, 2)) * env[: n - 64, None]).astype(np.float32)
    x[64, :] = 0.9
    write_bundle(tmp_path, {"tap0": x}, sr)

    run_bundle_report_engine(tmp_path)
    md = (tmp_path / "reports" / "tap0" / "tap0_report.md").read_text()
    assert "## Impulse response" in md
    # PCM16 round trip: 0.9 * 32767 // 1 / 32768 ~= 0.8999
    assert "peak_abs=0.89" in md
    # stereo tap -> stereo diffusion metrics present in the summary
    assert "median_corr0=" in md
