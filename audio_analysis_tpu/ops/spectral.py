"""
Single-segment spectral kernels: magnitude spectrum, phase, group delay,
spectral diagnostics, and regularised sweep deconvolution.

Reference semantics covered here:
- frequency response magnitude + peak/centroid (frequency_response.py:173-271)
- filter magnitude+phase with optional unwrap (filterplot.py:112-203)
- group delay -dphi/dw from unwrapped phase (group_delay.py:89-137)
- Tikhonov deconvolution H = Y conj(X) / (|X|^2 + eps) (deconvolve.py:124-193)

Segments arrive aligned at index 0 in a static buffer with a runtime valid
length (see ops.trim); windows are built at the runtime length, and the FFT
runs at the static buffer length (zero-padded — i.e. spectrally
interpolated, identical underlying DTFT).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from audio_analysis_tpu.ops import selectq
from audio_analysis_tpu.ops.common import (
    bool_valid_mask,
    box_smooth_same,
    db_from_magnitude,
    hann_window_dynamic,
)

_HIGHEST = jax.lax.Precision.HIGHEST


class SpectrumResult(NamedTuple):
    mag_db: jnp.ndarray  # (..., F)
    phase: jnp.ndarray  # (..., F) radians (unwrapped if requested)
    peak_frequency_hz: jnp.ndarray  # (...,) within [f_min, f_max]
    spectral_centroid_hz: jnp.ndarray  # (...,) amplitude-weighted
    magnitude_at_1khz_db: jnp.ndarray  # (...,)


@partial(
    jax.jit,
    static_argnames=(
        "sample_rate_hz",
        "use_hann_window",
        "magnitude_floor_db",
        "f_min_hz",
        "f_max_hz",
        "unwrap_phase",
    ),
)
def segment_spectrum(
    x: jnp.ndarray,
    length: jnp.ndarray,
    sample_rate_hz: int,
    use_hann_window: bool = True,
    magnitude_floor_db: float = -120.0,
    f_min_hz: float = 20.0,
    f_max_hz: float = 20000.0,
    unwrap_phase: bool = True,
) -> SpectrumResult:
    """
    x: (..., N) aligned segment. One rfft feeds magnitude, phase, and the
    diagnostics for fr / filter / group-delay views.
    """
    n = x.shape[-1]
    if use_hann_window:
        xw = x * hann_window_dynamic(n, length)
    else:
        xw = jnp.where(bool_valid_mask(n, length), x, 0.0)

    spectrum = jnp.fft.rfft(xw, axis=-1)
    mag_db = db_from_magnitude(jnp.abs(spectrum).astype(jnp.float32), magnitude_floor_db)

    phase = jnp.angle(spectrum).astype(jnp.float32)
    if unwrap_phase:
        phase = jnp.unwrap(phase, axis=-1)

    freqs_np = np.fft.rfftfreq(n, d=1.0 / float(sample_rate_hz)).astype(np.float32)
    nyquist = 0.5 * float(sample_rate_hz)
    f_lo = float(np.clip(f_min_hz, 0.0, nyquist))
    f_hi = float(np.clip(f_max_hz, f_lo, nyquist))
    sel_np = (freqs_np >= f_lo) & (freqs_np <= f_hi)
    first_sel_freq = float(freqs_np[np.argmax(sel_np)]) if np.any(sel_np) else 0.0
    freqs = jnp.asarray(freqs_np)
    sel = jnp.asarray(sel_np)

    mag_sel_db = jnp.where(sel, mag_db, -jnp.inf)
    peak_idx = jnp.argmax(mag_sel_db, axis=-1)
    peak_freq = freqs[peak_idx]

    mag_sel_lin = jnp.where(sel, 10.0 ** (mag_db / 20.0), 0.0)
    weight_sum = jnp.sum(mag_sel_lin, axis=-1)
    centroid = jnp.sum(mag_sel_lin * freqs, axis=-1) / jnp.where(weight_sum > 0.0, weight_sum, 1.0)
    centroid = jnp.where(weight_sum > 0.0, centroid, first_sel_freq)

    idx_1k = int(np.argmin(np.abs(np.fft.rfftfreq(n, 1.0 / sample_rate_hz) - 1000.0)))
    mag_1k = mag_db[..., idx_1k]

    return SpectrumResult(mag_db, phase, peak_freq, centroid, mag_1k)


class GroupDelayResult(NamedTuple):
    group_delay_samples: jnp.ndarray  # (..., F)
    median: jnp.ndarray  # (...,) over [f_min, f_max]
    p10: jnp.ndarray
    p90: jnp.ndarray


@partial(
    jax.jit,
    static_argnames=("sample_rate_hz", "use_hann_window", "unwrap", "smoothing_bins",
                     "f_min_hz", "f_max_hz"),
)
def group_delay(
    x: jnp.ndarray,
    length: jnp.ndarray,
    sample_rate_hz: int,
    use_hann_window: bool = True,
    unwrap: bool = True,
    smoothing_bins: int = 0,
    f_min_hz: float = 20.0,
    f_max_hz: float = 20000.0,
) -> GroupDelayResult:
    """
    gd(w) = -dphi/dw with w in rad/sample, phi from the (optionally
    unwrapped) rfft phase, central differences matching np.gradient
    (group_delay.py:109-125). The FFT length is the static buffer size
    (the reference pads to next pow2 capped at 2^20, group_delay.py:103-105).
    """
    n = x.shape[-1]
    if use_hann_window:
        xw = x * hann_window_dynamic(n, length)
    else:
        xw = jnp.where(bool_valid_mask(n, length), x, 0.0)

    spectrum = jnp.fft.rfft(xw, axis=-1)
    phase = jnp.angle(spectrum)
    if unwrap:
        phase = jnp.unwrap(phase, axis=-1)

    # w axis is uniform: dw = 2*pi / n (rad/sample). np.gradient central
    # differences with one-sided ends.
    dw = 2.0 * jnp.pi / n
    dphi = jnp.gradient(phase, axis=-1) / dw
    gd = (-dphi).astype(jnp.float32)

    if smoothing_bins and smoothing_bins > 1:
        gd = box_smooth_same(gd, int(smoothing_bins))

    freqs = np.fft.rfftfreq(n, d=1.0 / float(sample_rate_hz))
    sel = jnp.asarray((freqs >= f_min_hz) & (freqs <= f_max_hz))
    # sort-free exact order statistics (ops/selectq) — XLA's bitonic sort
    # over the F bins was 4x slower; same kernel the engine block uses
    valid = jnp.broadcast_to(sel, gd.shape)
    q = selectq.masked_percentiles(gd, valid, (10.0, 50.0, 90.0))
    return GroupDelayResult(gd, q[..., 1], q[..., 0], q[..., 2])


@partial(jax.jit, static_argnames=("n_fft",))
def deconvolve_spectral(
    recorded: jnp.ndarray,  # (..., C, Ny) zero-padded to static Ny
    sweep: jnp.ndarray,  # (Nx,) mono excitation, zero-padded ok
    n_fft: int,
    regularization_relative: float = 1e-10,
) -> jnp.ndarray:
    """
    H = Y conj(X) / (|X|^2 + eps), eps = rel * max|X|^2 (deconvolve.py:150-171).
    Returns the time-domain IR, shape (..., C, n_fft); the caller trims to
    the recorded length / applies DC removal / peak normalisation.
    """
    X = jnp.fft.rfft(sweep, n=n_fft)
    power = jnp.abs(X) ** 2
    eps = regularization_relative * jnp.maximum(1e-30, jnp.max(power))
    denom = power + eps
    Y = jnp.fft.rfft(recorded, n=n_fft, axis=-1)
    H = Y * jnp.conj(X) / denom
    return jnp.fft.irfft(H, n=n_fft, axis=-1).astype(jnp.float32)


class ArFitResult(NamedTuple):
    gram: jnp.ndarray  # (..., p, p) A^T A
    moment: jnp.ndarray  # (..., p)   A^T y


@partial(jax.jit, static_argnames=("order", "chunk"))
def ar_normal_equations(
    x: jnp.ndarray,
    length: jnp.ndarray,
    order: int,
    chunk: int = 65536,
) -> ArFitResult:
    """
    Accumulate the exact least-squares normal equations of the AR(p) model
    x[n] + sum_k a[k] x[n-k] = e[n] (regression build as zplane.py:100-108):
    rows n = p..L-1, row_k = x[n-k], y = -x[n]. The heavy part — the Gram
    matrix over ~10^6 samples — runs as chunked (chunk, p) x (chunk, p)
    matmuls on the device in full f32 (Precision.HIGHEST: the Gram's
    conditioning reaches ~1e8, far past what TF32 products keep); the tiny
    (p, p) solve happens on the host in f64.
    """
    n = x.shape[-1]
    p = int(order)
    num_rows = max(0, n - p)
    num_chunks = max(1, -(-num_rows // chunk))

    batch_shape = x.shape[:-1]
    xf = x.reshape((-1, n))
    lf = jnp.broadcast_to(jnp.asarray(length, jnp.int32), batch_shape).reshape((-1,))

    lag_idx = jnp.arange(1, p + 1, dtype=jnp.int32)

    def one_signal(sig: jnp.ndarray, valid_len: jnp.ndarray):
        def body(c, carry):
            gram, moment = carry
            row0 = p + c * chunk
            rows = row0 + jnp.arange(chunk, dtype=jnp.int32)
            ok = (rows < jnp.minimum(valid_len, n)).astype(jnp.float32)
            # A[r, k-1] = x[rows[r] - k]
            gidx = jnp.clip(rows[:, None] - lag_idx[None, :], 0, n - 1)
            a = sig[gidx] * ok[:, None]
            y = -sig[jnp.clip(rows, 0, n - 1)] * ok
            gram = gram + jnp.dot(
                a.T, a, precision=_HIGHEST, preferred_element_type=jnp.float32
            )
            moment = moment + jnp.dot(
                a.T, y, precision=_HIGHEST, preferred_element_type=jnp.float32
            )
            return gram, moment

        init = (jnp.zeros((p, p), jnp.float32), jnp.zeros((p,), jnp.float32))
        return jax.lax.fori_loop(0, num_chunks, body, init)

    gram, moment = jax.vmap(one_signal)(xf, lf)
    return ArFitResult(
        gram.reshape(batch_shape + (p, p)), moment.reshape(batch_shape + (p,))
    )


def solve_ar_coefficients(
    gram: np.ndarray,
    moment: np.ndarray,
    ridge_lambda: float = 0.0,
    rcond: float = 1e-6,
) -> np.ndarray:
    """
    Host-side f64 solve of the normal equations -> AR coefficients with
    a[0] = 1.

    The Gram is accumulated on device in float32, so its entries carry
    ~1e-7 relative noise regardless of the f64 cast here. Singular
    directions smaller than `rcond` (default: f32 epsilon scale) relative
    to the largest are therefore pure accumulation noise — a plain solve
    or machine-eps lstsq amplifies them into wild, often unstable poles
    whenever the Gram is ill-conditioned (order >> true modes). Truncating
    at the data's actual precision recovers the reference's f64
    design-matrix lstsq answer (zplane.py:117-118) to ~1%; for
    well-conditioned fits (sv ratio > rcond) it is identical to the exact
    solve. Applied to the ridge path too: ridge values smaller than the
    f32 noise floor can't stabilise the solve on their own.
    """
    g = np.asarray(gram, dtype=np.float64)
    m = np.asarray(moment, dtype=np.float64)
    p = g.shape[-1]
    if ridge_lambda and ridge_lambda > 0.0:
        g = g + ridge_lambda * np.eye(p)
    rest, *_ = np.linalg.lstsq(g, m, rcond=rcond)
    return np.concatenate(([1.0], rest))


def ar_poles(a: np.ndarray) -> np.ndarray:
    """
    Poles of A(z) = 1 + a1 z^-1 + ... + ap z^-p = roots of
    z^p + a1 z^(p-1) + ... + ap (zplane.py:145-158). Complex nonsymmetric
    eigensolve — host only.
    """
    poly = np.asarray(a, dtype=np.float64)
    while poly.size > 1 and abs(poly[-1]) < 1e-14:
        poly = poly[:-1]
    if poly.size <= 1:
        return np.array([], dtype=np.complex128)
    return np.roots(poly)


def derive_fir_numerator_from_ar(a: np.ndarray, h: np.ndarray, zero_order: int) -> np.ndarray:
    """b[n] = sum_k a[k] h[n-k] for n = 0..Q (zplane.py:123-142) — one convolution."""
    a = np.asarray(a, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    q = int(max(0, zero_order))
    full = np.convolve(a, h)
    b = np.zeros(q + 1)
    take = min(q + 1, full.size)
    b[:take] = full[:take]
    return b
