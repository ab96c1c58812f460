"""
The plain-JAX kernels that stand where hand-written ones used to: the
Schroeder EDC against the float64 oracle, the frame STFT (both FFT paths)
against a windowed numpy rfft, the engine's FFT-path validation, and the
f32 contractions that must never run in TF32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_analysis_tpu import oracle
from audio_analysis_tpu.ops import edc, stft

SR = 48_000


def _decay_rows(n: int, tau_samples: float, rows: int = 2, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (0.1 * rng.standard_normal((rows, n)) * np.exp(-t / tau_samples)).astype(np.float32)


# (N, decay time constant in samples, valid lengths per row)
_EDC_CASES = {
    "n16384": (16384, 3000.0, None),
    "n131072": (1 << 17, 20000.0, None),
    # a fast decay: the tail is ~100 dB down, where a scan that subtracts
    # running totals instead of accumulating tail-first would cancel
    "fast_decay": (16384, 400.0, None),
    "length_masked": (16384, 3000.0, (16384, 8192)),
}


@pytest.mark.parametrize("case", sorted(_EDC_CASES))
def test_plain_edc_matches_oracle(case):
    n, tau, valid = _EDC_CASES[case]
    x = _decay_rows(n, tau)
    lengths = np.array(valid or (n, n), np.int32)
    for r, length in enumerate(lengths):
        x[r, length:] = 0.0

    got = np.asarray(edc.schroeder_edc_db(jnp.asarray(x), jnp.asarray(lengths)).edc_db)
    for r, length in enumerate(lengths):
        _, ref, _ = oracle.schroeder_edc_db(x[r, :length].astype(np.float64), SR, trim_to_peak=False)
        region = ref >= -80.0  # the fit-relevant range (fits stop at -80 dB)
        np.testing.assert_allclose(got[r, :length][region], ref[region], atol=0.02)
        # floored like the reference, zero past the valid length
        assert got[r, :length].min() >= -120.0
        assert np.all(got[r, length:] == 0.0)
    if case == "fast_decay":
        assert got[0, : n - 100].min() < -90.0  # the deep tail really was exercised


@pytest.mark.parametrize("fft_impl", ["mx", "xla"])
@pytest.mark.parametrize("n_fft,hop", [(4096, 512), (8192, 512), (4096, 1024)])
def test_stft_magnitude_matches_windowed_rfft(fft_impl, n_fft, hop):
    rng = np.random.default_rng(0)
    n = 1 << 15
    x = rng.standard_normal((2, n)).astype(np.float32)
    frames = 1 + (n - n_fft) // hop
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    ref = np.abs(np.fft.rfft(x[:, idx].astype(np.float64) * np.hanning(n_fft), axis=-1))

    got = stft.stft_magnitude(
        jnp.asarray(x), jnp.full((2,), n, jnp.int32), n_fft, hop, True, 0.0, fft_impl,
        fft_precision="highest",
    )
    mag = np.asarray(got.mag)
    assert mag.shape == ref.shape
    assert np.all(np.asarray(got.num_frames) == frames)
    assert np.max(np.abs(mag - ref)) / np.max(ref) < 1e-5


def test_engine_config_rejects_unknown_fft_impl():
    from audio_analysis_tpu.engine import EngineConfig

    assert EngineConfig(stft_fft_impl="xla").stft_fft_impl == "xla"
    with pytest.raises(ValueError, match="stft_fft_impl.*'pallas'"):
        EngineConfig(stft_fft_impl="pallas")


def _ar_gram_lowered():
    from audio_analysis_tpu.ops import spectral

    x = jnp.zeros((1, 4096), jnp.float32)
    fn = jax.jit(lambda s, n: spectral.ar_normal_equations(s, n, 8, 1024))
    return fn.lower(x, jnp.array([4096], jnp.int32)).as_text()


def _log_bins_lowered():
    from audio_analysis_tpu.ops import logfreq

    return logfreq.aggregate_db_to_log_bins.lower(
        jnp.zeros((2, 16, 64), jnp.float32), jnp.zeros((8, 64), jnp.float32)
    ).as_text()


def _engine_lowered():
    from audio_analysis_tpu.engine import EngineConfig
    from audio_analysis_tpu.engine.batch import analyze_batch

    # the whole engine: the modal log-bin matmul and every mx FFT stage
    return analyze_batch.lower(
        jax.ShapeDtypeStruct((1, 2, 16384), jnp.float32),
        jax.ShapeDtypeStruct((1,), jnp.int32),
        EngineConfig(),
    ).as_text()


@pytest.mark.parametrize(
    "lowered", [_ar_gram_lowered, _log_bins_lowered, _engine_lowered],
    ids=["ar_gram", "log_bins", "engine_modal_and_mx"],
)
def test_f32_contractions_lower_with_highest_precision(lowered):
    """On an H100 an f32 matmul without a precision may run in TF32 (~10
    mantissa bits); every contraction on these paths asks for HIGHEST."""
    import chip_smoke

    precisions = chip_smoke.dot_precisions(lowered())
    assert precisions, "no contraction found"
    assert set(precisions) == {"HIGHEST"}, precisions
