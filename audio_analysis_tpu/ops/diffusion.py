"""
Sliding-window diffusion / decorrelation metrics.

Same definitions as the reference (diffusion.py:132-226) — per window:
- max |normalised autocorrelation| over lags 1..L,
- echo density (fraction of |x| above k*rms, optionally normalised by the
  Gaussian expectation 2(1-Phi(k))),
- zero-lag Pearson correlation corr0 and IACC-like max |cross-correlation|
  over lags -L..L for stereo pairs.

The reference computes these with O(frames x lags) nested Python loops
(diffusion.py:144-151, 189-202). Here every window is a row of a framed
matrix and all correlations for all lags come from ONE batched rfft per
window (Wiener–Khinchin): linear auto/cross-correlation = irfft of the
(conjugated) spectrum product, zero-padded to avoid circular wrap. All
frames of all taps/channels run in a single fused program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from audio_analysis_tpu.ops.common import next_pow2
from audio_analysis_tpu.ops.stft import frame_signal, num_frames_static


class DiffusionSeries(NamedTuple):
    time_seconds: jnp.ndarray  # (T,) static frame centres
    max_abs_autocorr: jnp.ndarray  # (..., T), NaN where invalid
    echo_density: jnp.ndarray  # (..., T), NaN where invalid
    num_frames: jnp.ndarray  # (...,) int32 valid frame count


class StereoDiffusionSeries(NamedTuple):
    corr0: jnp.ndarray  # (..., T)
    iacc_max: jnp.ndarray  # (..., T)


def _frames_and_validity(x: jnp.ndarray, length: jnp.ndarray, win: int, hop: int):
    frames = frame_signal(x, win, hop)  # (..., T, win)
    t = frames.shape[-2]
    frame_valid = jnp.arange(t, dtype=jnp.int32) * hop + win <= length[..., None]
    return frames, frame_valid


def _centered(frames: jnp.ndarray) -> jnp.ndarray:
    return frames - jnp.mean(frames, axis=-1, keepdims=True)


@partial(jax.jit, static_argnames=("win", "hop", "max_lag", "sample_rate_hz",
                                   "threshold_rms", "normalise_to_gaussian",
                                   "fft_impl", "fft_precision"))
def diffusion_metrics(
    x: jnp.ndarray,
    length: jnp.ndarray,
    win: int,
    hop: int,
    max_lag: int,
    sample_rate_hz: int,
    threshold_rms: float = 1.0,
    normalise_to_gaussian: bool = True,
    fft_impl: str = "xla",
    fft_precision: "str | None" = None,
) -> DiffusionSeries:
    """Windowed max|autocorr| and echo density for (..., N) aligned signals."""
    frames, frame_valid = _frames_and_validity(x, length, win, hop)
    x0 = _centered(frames)

    # --- autocorrelation via rfft (linear, zero-padded) ---
    n_fft = next_pow2(win + max_lag + 1)
    if fft_impl == "mx":
        # matmul path: matmul rfft, then the inverse evaluated ONLY at lags
        # 0..max_lag as a direct synthesis matmul (the power spectrum is
        # real, so one (F, lags) matmul replaces the full n_fft irfft)
        from audio_analysis_tpu.ops.mxfft import irfft_mx_at, rfft_mx

        spec = rfft_mx(x0, n_fft, precision=fft_precision)
        power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
        acorr = irfft_mx_at(power, n_fft, np.arange(max_lag + 1), precision=fft_precision)
    else:
        spec = jnp.fft.rfft(x0, n=n_fft, axis=-1)
        acorr = jnp.fft.irfft(spec * jnp.conj(spec), n=n_fft, axis=-1)
    denom = acorr[..., 0]  # = sum x0^2
    lag_slice = jnp.abs(acorr[..., 1 : max_lag + 1])
    # Reference caps the lag range at window-2 (diffusion.py:147); with
    # win >= max_lag+2 (the practical regime) the ranges coincide.
    usable = min(max_lag, win - 2)
    lag_mask = jnp.arange(1, max_lag + 1) <= usable
    best = jnp.max(jnp.where(lag_mask, lag_slice, 0.0), axis=-1)
    denom_ok = denom > 1e-20
    max_abs_ac = jnp.where(denom_ok, best / jnp.where(denom_ok, denom, 1.0), jnp.nan)

    # --- echo density ---
    rms = jnp.sqrt(jnp.mean(x0 * x0, axis=-1))
    thr = threshold_rms * rms
    frac = jnp.mean((jnp.abs(x0) > thr[..., None]).astype(jnp.float32), axis=-1)
    if normalise_to_gaussian:
        from math import erf, sqrt

        phi = 0.5 * (1.0 + erf(threshold_rms / sqrt(2.0)))
        expected = 2.0 * (1.0 - phi)
        frac = frac / expected if expected > 1e-12 else frac * jnp.nan
    echo = jnp.where(rms > 1e-20, frac, jnp.nan)

    invalid = ~frame_valid
    t = frames.shape[-2]
    times = (jnp.arange(t, dtype=jnp.float32) * hop + 0.5 * win) / float(sample_rate_hz)
    return DiffusionSeries(
        time_seconds=times,
        max_abs_autocorr=jnp.where(invalid, jnp.nan, max_abs_ac),
        echo_density=jnp.where(invalid, jnp.nan, echo),
        num_frames=jnp.sum(frame_valid, axis=-1).astype(jnp.int32),
    )


@partial(jax.jit, static_argnames=("win", "hop", "max_lag", "fft_impl",
                                   "fft_precision"))
def stereo_diffusion_metrics(
    left: jnp.ndarray,
    right: jnp.ndarray,
    length: jnp.ndarray,
    win: int,
    hop: int,
    max_lag: int,
    fft_impl: str = "xla",
    fft_precision: "str | None" = None,
) -> StereoDiffusionSeries:
    """corr0 + IACC max over +-lags for aligned stereo pairs (..., N)."""
    lf, frame_valid = _frames_and_validity(left, length, win, hop)
    rf, _ = _frames_and_validity(right, length, win, hop)
    x0, y0 = _centered(lf), _centered(rf)

    ex = jnp.sum(x0 * x0, axis=-1)
    ey = jnp.sum(y0 * y0, axis=-1)
    denom = jnp.sqrt(ex * ey)
    denom_ok = denom > 1e-20
    safe = jnp.where(denom_ok, denom, 1.0)

    corr0 = jnp.where(denom_ok, jnp.sum(x0 * y0, axis=-1) / safe, jnp.nan)

    # Cross-correlation for all lags at once: c[l] = sum x0[n] y0[n+l].
    n_fft = next_pow2(win + max_lag + 1)
    if fft_impl == "mx":
        # matmul path: inverse evaluated only at the +-max_lag lags actually
        # used (two synthesis matmuls instead of the full n_fft irfft)
        from audio_analysis_tpu.ops.mxfft import irfft_mx_at, rfft_mx

        fx = rfft_mx(x0, n_fft, precision=fft_precision)
        fy = rfft_mx(y0, n_fft, precision=fft_precision)
        z = jnp.conj(fx) * fy
        xc_pos = irfft_mx_at(z, n_fft, np.arange(max_lag + 1), precision=fft_precision)
        xc_neg = irfft_mx_at(
            z, n_fft, n_fft - np.arange(1, max_lag + 1), precision=fft_precision
        )
    else:
        fx = jnp.fft.rfft(x0, n=n_fft, axis=-1)
        fy = jnp.fft.rfft(y0, n=n_fft, axis=-1)
        xc = jnp.fft.irfft(jnp.conj(fx) * fy, n=n_fft, axis=-1)
        xc_pos = xc[..., : max_lag + 1]
        xc_neg = xc[..., n_fft - max_lag :][..., ::-1]
    usable = min(max_lag, win - 2)
    lag_ok_pos = jnp.arange(0, max_lag + 1) <= usable
    lag_ok_neg = jnp.arange(1, max_lag + 1) <= usable
    pos = jnp.max(jnp.where(lag_ok_pos, jnp.abs(xc_pos), 0.0), axis=-1)
    neg = jnp.max(jnp.where(lag_ok_neg, jnp.abs(xc_neg), 0.0), axis=-1)
    iacc = jnp.where(denom_ok, jnp.maximum(pos, neg) / safe, jnp.nan)

    invalid = ~frame_valid
    return StereoDiffusionSeries(
        corr0=jnp.where(invalid, jnp.nan, corr0),
        iacc_max=jnp.where(invalid, jnp.nan, iacc),
    )


@partial(
    jax.jit,
    static_argnames=("win", "hop", "max_lag", "fft_impl", "fft_precision"),
)
def stereo_diffusion_metrics_rows(
    samples: jnp.ndarray,
    length: jnp.ndarray,
    win: int,
    hop: int,
    max_lag: int,
    fft_impl: str = "xla",
    fft_precision: "str | None" = None,
) -> StereoDiffusionSeries:
    """`stereo_diffusion_metrics` on the (..., 2, N) aligned L/R row layout:
    the row slicing happens INSIDE the program (bare `samples[0:1]` slices
    at the call site each dispatched a tiny eager program — a separate
    compile per shape)."""
    return stereo_diffusion_metrics(
        samples[..., 0:1, :],
        samples[..., 1:2, :],
        length[..., 0:1],
        win,
        hop,
        max_lag,
        fft_impl,
        fft_precision,
    )


def diffusion_frame_times(n: int, win: int, hop: int, sample_rate_hz: int) -> np.ndarray:
    t = num_frames_static(n, win, hop)
    return ((np.arange(t) * hop + 0.5 * win) / float(sample_rate_hz)).astype(np.float32)
