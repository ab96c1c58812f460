"""Matmul-factored FFT (ops/mxfft.py) numerics vs numpy's float64 FFT.

Pinned to the CPU backend: these are pure-numerics checks (its speed on
the card is measured by chip_smoke.py, not unit-tested).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_analysis_tpu.ops.mxfft import irfft_mx, rfft_mx

sizes = pytest.mark.parametrize("n", [64, 4096, 8192, 1 << 16])


def _cpu():
    return jax.default_device(jax.devices("cpu")[0])


@sizes
def test_rfft_matches_numpy(n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, n)).astype(np.float32)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    with _cpu():
        got = np.asarray(rfft_mx(jnp.asarray(x)))
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err < 1e-5, err


@sizes
def test_irfft_roundtrip(n):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, n)).astype(np.float32)
    with _cpu():
        back = np.asarray(irfft_mx(rfft_mx(jnp.asarray(x)), n))
    assert back.shape == x.shape
    assert np.max(np.abs(back - x)) < 1e-4


def test_irfft_at_selected_indices():
    rng = np.random.default_rng(2)
    from audio_analysis_tpu.ops.mxfft import irfft_mx_at

    n = 4096
    x = rng.standard_normal((3, n)).astype(np.float32)
    spec = np.fft.rfft(x, axis=-1)
    idx = np.concatenate([np.arange(241), n - np.arange(1, 241)])
    ref = np.fft.irfft(spec, n, axis=-1)[..., idx]
    with _cpu():
        got = np.asarray(irfft_mx_at(jnp.asarray(spec.astype(np.complex64)), n, idx))
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_irfft_at_real_power_spectrum():
    rng = np.random.default_rng(3)
    from audio_analysis_tpu.ops.mxfft import irfft_mx_at

    n = 4096
    x = rng.standard_normal((2, n)).astype(np.float32)
    spec = np.fft.rfft(x, axis=-1)
    power = (spec * np.conj(spec)).real
    ref = np.fft.irfft(power, n, axis=-1)[..., :241]  # autocorrelation lags
    with _cpu():
        got = np.asarray(
            irfft_mx_at(jnp.asarray(power.astype(np.float32)), n, np.arange(241))
        )
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-2 * np.abs(ref).max())


def test_diffusion_mx_matches_xla():
    """The engine's mx diffusion path (matmul rfft + lag-cropped synthesis
    irfft) matches the XLA FFT path bit-for-bit-ish on the same frames."""
    from audio_analysis_tpu.ops.diffusion import (
        diffusion_metrics,
        stereo_diffusion_metrics,
    )

    rng = np.random.default_rng(5)
    n = 1 << 15
    x = (rng.standard_normal((2, n)) * np.exp(-np.arange(n) / 6000)[None]).astype(
        np.float32
    )
    y = (rng.standard_normal((2, n)) * np.exp(-np.arange(n) / 6000)[None]).astype(
        np.float32
    )
    l = jnp.full((2,), n, jnp.int32)
    win, hop, max_lag = 2400, 2400, 240

    with _cpu():
        a = diffusion_metrics(jnp.asarray(x), l, win, hop, max_lag, 48000, 1.0, True, "xla")
        b = diffusion_metrics(jnp.asarray(x), l, win, hop, max_lag, 48000, 1.0, True, "mx")
        sa = stereo_diffusion_metrics(jnp.asarray(x), jnp.asarray(y), l, win, hop, max_lag, "xla")
        sb = stereo_diffusion_metrics(jnp.asarray(x), jnp.asarray(y), l, win, hop, max_lag, "mx")

    for pa, pb in ((a, b), (sa, sb)):
        for name, va in pa._asdict().items():
            vb = getattr(pb, name)
            np.testing.assert_allclose(
                np.asarray(va), np.asarray(vb), rtol=1e-4, atol=1e-5, err_msg=name
            )


@pytest.mark.parametrize("n1", [None, 128])
def test_rfft_k_out_trim_matches_full(n1):
    """k_out (and an n1 split override) restrict stage 2 to the requested
    bins; values match the full transform at the method's own error level
    (the reshaped matmuls reorder accumulation, so not bit-equal)."""
    n, k_out = 8192, 3415  # the modal block's 20 kHz cut of a 24 kHz Nyquist
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, n)).astype(np.float32)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)[..., :k_out]
    with _cpu():
        got = np.asarray(rfft_mx(jnp.asarray(x), k_out=k_out, n1=n1))
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) / np.max(np.abs(np.fft.rfft(x, axis=-1)))
    assert err < 1e-5, err


def test_rfft_k_out_validation():
    x = jnp.zeros((2, 64), jnp.float32)
    with _cpu():
        with pytest.raises(ValueError):
            rfft_mx(x, k_out=64 // 2 + 2)
        with pytest.raises(ValueError):
            rfft_mx(x, n1=48)


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_rfft_precision_levels_match_numpy(precision):
    # On CPU every level is a true f32 matmul, so this pins the API and the
    # transform itself; on an H100 "high"/"default" allow TF32 products
    # (scripts/bench_fft_precision.py measures the tradeoff on the card).
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    with _cpu():
        got = np.asarray(rfft_mx(jnp.asarray(x), precision=precision))
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err < 1e-5, (precision, err)


def test_rfft_precision_validation():
    with _cpu():
        with pytest.raises(KeyError):
            rfft_mx(jnp.zeros((2, 64), jnp.float32), precision="fast")


def test_engine_fft_precision_config_traces():
    # the static knob reaches the engine's frame-STFT blocks without
    # disturbing output structure
    from audio_analysis_tpu.engine import EngineConfig
    from audio_analysis_tpu.engine.batch import analyze_batch

    rng = np.random.default_rng(6)
    n = 1 << 14
    s = (rng.standard_normal((1, 2, n)) * np.exp(-np.arange(n) / 2000.0)).astype(
        np.float32
    )
    lengths = np.full(1, n, np.int32)
    with _cpu():
        base = analyze_batch(jnp.asarray(s), jnp.asarray(lengths), EngineConfig())
        high = analyze_batch(
            jnp.asarray(s),
            jnp.asarray(lengths),
            EngineConfig(stft_fft_precision="high"),
        )
    assert set(base) == set(high)
    for key in base:
        np.testing.assert_allclose(
            np.asarray(base[key], np.float64),
            np.asarray(high[key], np.float64),
            rtol=1e-5,
            atol=1e-6,
            err_msg=key,
        )
