"""
FFT-domain filterbank with raised-cosine transitions.

Same filter definitions as the reference's rt60bands (rt60bands.py:116-175:
half-cosine ramps in linear frequency between band edge and edge*2^±trans),
but the masks for ALL bands are built as one (bands, F) matrix on the host
and applied with a single batched rfft/irfft — the reference loops bands and
runs a full-length FFT per band (rt60bands.py:362-406).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class BandDefinition:
    name: str
    centre_hz: float
    kind: str  # "lowpass" | "bandpass" | "highpass"
    low_edge_hz: Optional[float] = None
    high_edge_hz: Optional[float] = None


# ----------------------------------------------------------------------------
# host-side mask construction (tiny, static per settings)
# ----------------------------------------------------------------------------


def _ramp(freqs: np.ndarray, x0: float, x1: float) -> np.ndarray:
    if x1 <= x0:
        return (freqs >= x1).astype(np.float64)
    t = np.clip((freqs - x0) / (x1 - x0), 0.0, 1.0)
    return 0.5 - 0.5 * np.cos(np.pi * t)


def make_lowpass_mask(
    freqs: np.ndarray, pass_hz: float, transition_oct: float, nyquist_hz: float
) -> np.ndarray:
    pass_hz = float(np.clip(pass_hz, 1.0, nyquist_hz))
    stop_hz = float(min(nyquist_hz, pass_hz * 2.0**transition_oct))
    if stop_hz <= pass_hz:
        stop_hz = min(nyquist_hz, pass_hz + 1.0)
    mask = 1.0 - _ramp(freqs, pass_hz, stop_hz)
    mask[freqs <= pass_hz] = 1.0
    mask[freqs >= stop_hz] = 0.0
    return mask


def make_highpass_mask(
    freqs: np.ndarray, pass_hz: float, transition_oct: float, nyquist_hz: float
) -> np.ndarray:
    pass_hz = float(np.clip(pass_hz, 1.0, nyquist_hz))
    stop_hz = float(max(1.0, pass_hz / 2.0**transition_oct))
    if pass_hz <= stop_hz:
        stop_hz = max(1.0, pass_hz - 1.0)
    mask = _ramp(freqs, stop_hz, pass_hz)
    mask[freqs <= stop_hz] = 0.0
    mask[freqs >= pass_hz] = 1.0
    return mask


def make_bandpass_mask(
    freqs: np.ndarray,
    low_edge_hz: float,
    high_edge_hz: float,
    transition_oct: float,
    nyquist_hz: float,
) -> np.ndarray:
    low_edge_hz = float(np.clip(low_edge_hz, 1.0, nyquist_hz))
    high_edge_hz = float(np.clip(high_edge_hz, 1.0, nyquist_hz))
    if high_edge_hz <= low_edge_hz:
        return np.zeros_like(freqs)
    return make_highpass_mask(freqs, low_edge_hz, transition_oct, nyquist_hz) * make_lowpass_mask(
        freqs, high_edge_hz, transition_oct, nyquist_hz
    )


def build_band_mask_matrix(
    bands: List[BandDefinition],
    num_samples: int,
    sample_rate_hz: int,
    transition_width_octaves: float,
) -> np.ndarray:
    """(bands, F) float32 mask matrix for rfft of length `num_samples`."""
    freqs = np.fft.rfftfreq(num_samples, d=1.0 / float(sample_rate_hz))
    nyquist = 0.5 * float(sample_rate_hz)
    rows = []
    for band in bands:
        if band.kind == "lowpass":
            rows.append(
                make_lowpass_mask(freqs, band.high_edge_hz, transition_width_octaves, nyquist)
            )
        elif band.kind == "highpass":
            rows.append(
                make_highpass_mask(freqs, band.low_edge_hz, transition_width_octaves, nyquist)
            )
        elif band.kind == "bandpass":
            rows.append(
                make_bandpass_mask(
                    freqs, band.low_edge_hz, band.high_edge_hz, transition_width_octaves, nyquist
                )
            )
        else:
            raise ValueError(f"Unknown band kind: {band.kind}")
    return np.stack(rows, axis=0).astype(np.float32)


# ----------------------------------------------------------------------------
# band definition generation (rt60bands.py:183-253 semantics)
# ----------------------------------------------------------------------------


def build_three_band_definitions(
    sample_rate_hz: int,
    low_upper_hz: float = 250.0,
    mid_center_hz: float = 1000.0,
    mid_width_octaves: float = 2.0,
    high_lower_hz: float = 4000.0,
) -> List[BandDefinition]:
    nyquist = 0.5 * float(sample_rate_hz)
    low_upper = float(np.clip(low_upper_hz, 20.0, nyquist))
    mid_center = float(np.clip(mid_center_hz, 20.0, nyquist))
    mid_width = float(max(0.1, mid_width_octaves))
    high_lower = float(np.clip(high_lower_hz, 20.0, nyquist))

    half = 0.5 * mid_width
    mid_low = float(np.clip(mid_center / 2.0**half, 20.0, nyquist))
    mid_high = float(np.clip(mid_center * 2.0**half, 20.0, nyquist))

    return [
        BandDefinition("Low", float(np.sqrt(20.0 * low_upper)), "lowpass", high_edge_hz=low_upper),
        BandDefinition("Mid", mid_center, "bandpass", low_edge_hz=mid_low, high_edge_hz=mid_high),
        BandDefinition(
            "High",
            float(np.sqrt(max(20.0, high_lower) * nyquist)),
            "highpass",
            low_edge_hz=high_lower,
        ),
    ]


def build_fractional_octave_band_definitions(
    sample_rate_hz: int,
    bands_per_octave: int,
    f_min_hz: float = 31.5,
    f_max_hz: float = 16000.0,
) -> List[BandDefinition]:
    """Centres at 1000 * 2^(k/n), edges at fc * 2^(±1/(2n)), clipped to range."""
    nyquist = 0.5 * float(sample_rate_hz)
    f_min = float(max(20.0, min(f_min_hz, nyquist)))
    f_max = float(max(f_min, min(f_max_hz, nyquist)))

    n = float(bands_per_octave)
    step = 2.0 ** (1.0 / n)
    half_band = 2.0 ** (1.0 / (2.0 * n))
    anchor = 1000.0

    k_min = int(np.floor(np.log(f_min / anchor) / np.log(step)))
    k_max = int(np.ceil(np.log(f_max / anchor) / np.log(step)))

    bands: List[BandDefinition] = []
    for k in range(k_min, k_max + 1):
        fc = anchor * step**k
        if fc < f_min or fc > f_max:
            continue
        low = float(np.clip(fc / half_band, 20.0, nyquist))
        high = float(np.clip(fc * half_band, 20.0, nyquist))
        if high <= low:
            continue
        bands.append(
            BandDefinition(f"{int(round(fc))}Hz", float(fc), "bandpass", low, high)
        )
    bands.sort(key=lambda b: b.centre_hz)
    return bands


# ----------------------------------------------------------------------------
# band decimation factors (host-side, from the mask matrix)
# ----------------------------------------------------------------------------


def band_decimation_factors(
    masks: np.ndarray,
    num_samples: int,
    max_factor: int = 64,
    min_length: int = 16384,
) -> tuple:
    """
    Per-band power-of-two decimation factors for the cropped-spectrum
    inverse (`banded_from_spectrum` with decimation > 1).

    A band whose mask support lies entirely below the decimated Nyquist is
    EXACTLY representable at sample rate sr/k: the length-(N/k) inverse of
    the cropped masked spectrum equals the full-rate band signal sampled at
    every k-th instant (no approximation — the discarded bins are zero).
    By the same token (Poisson summation on the bandlimited x²) its energy
    partial-sums match the full-rate Schroeder integrals up to windowed
    Riemann/boundary terms that grow ~linearly with k (measured ~0.01·k dB
    on the band EDC above -30 dB for noise-excited decays), so band EDC +
    decay fits can run on planes k times smaller. The reference's Low band
    (rt60bands.py:127-137: pass 250 Hz × 2^(1/6) transition) supports
    k = 32 at N = 2^20 / 48 kHz under the margin rule below.

    Constraints per band: mask support bin ≤ (N/k)/4 — a 2x oversampling
    margin beyond bare representability, which both keeps x² (bandwidth
    twice the band's) alias-free on the decimated grid and bounds the
    measured EDC deviation at ≤ ~0.4 dB — N % k == 0 with N/k even (the
    packed-stereo mirror needs an even length), N/k ≥ `min_length` (fit
    resolution; the default keeps N/k a multiple of 16384 for pow-2 N),
    and k ≤ `max_factor`.
    """
    factors = []
    for row in np.asarray(masks):
        nonzero = np.nonzero(row > 0.0)[0]
        support_stop = int(nonzero[-1]) if nonzero.size else 1
        k = 1
        while (
            k * 2 <= max_factor
            and num_samples % (k * 2) == 0
            and num_samples // (k * 2) >= min_length
            and (num_samples // (k * 2)) % 2 == 0
            and support_stop <= (num_samples // (k * 2)) // 4
        ):
            k *= 2
        factors.append(k)
    return tuple(factors)


def crop_half_masks(masks: np.ndarray, num_samples: int, decimation: int) -> np.ndarray:
    """
    Host-side companion of `banded_from_spectrum`: crop the (bands, N/2+1)
    half-spectrum masks to the decimated grid's (bands, M/2+1) and fold in
    the 1/k inverse-length rescale (irfft at length M = N/k scales by 1/M
    where the full-rate inverse scales by 1/N — dividing the mask by k makes
    the decimated output equal the full-rate band signal's samples exactly).
    """
    m = num_samples // decimation
    return (np.asarray(masks)[:, : m // 2 + 1] / float(decimation)).astype(np.float32)


# ----------------------------------------------------------------------------
# device-side batched application
# ----------------------------------------------------------------------------


@jax.jit
def _packed_fft(x: jnp.ndarray) -> jnp.ndarray:
    z = jax.lax.complex(x[..., 0, :], x[..., 1, :])  # (..., N)
    return jnp.fft.fft(z, axis=-1)


@jax.jit
def _real_fft(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.fft.rfft(x, axis=-1)


def full_band_spectrum(x: jnp.ndarray):
    """
    The forward transform shared by every band/decimation group.

    Returns ("packed", fft(L + iR)) for a stereo pair — one c2c transform
    carries both channels because the band masks are real and even
    (conjugate-symmetric), so filtering commutes with the packing — or
    ("real", rfft(x)) otherwise.
    """
    n = x.shape[-1]
    if x.ndim >= 2 and x.shape[-2] == 2 and n % 2 == 0:
        return "packed", _packed_fft(x)
    return "real", _real_fft(x)


@partial(jax.jit, static_argnames=("kind", "num_samples", "decimation"))
def banded_from_spectrum(
    kind: str,
    spectrum: jnp.ndarray,
    masks: jnp.ndarray,
    num_samples: int,
    decimation: int = 1,
) -> jnp.ndarray:
    """
    Apply (bands, M/2+1) half-spectrum masks (see `crop_half_masks`) to a
    precomputed full-signal spectrum and inverse-transform at length
    M = num_samples / decimation.

    kind "real":   spectrum (..., N/2+1) -> (..., bands, M)
    kind "packed": spectrum (..., N) c2c of L + iR -> (..., 2, bands, M)

    With decimation > 1 the crop keeps only the bins below the decimated
    Nyquist — exact for bands whose mask support fits (see
    `band_decimation_factors`); the spectrum slices are contiguous
    (gather-free). The filter still sees the FULL signal (the reference's
    filter-then-trim order, rt60bands.py:392-394) — only the inverse grid
    is coarser.
    """
    m = num_samples // decimation
    if kind == "packed":
        # decimated c2c grid: positive freqs 0..M/2, negative freqs are the
        # LAST M/2-1 bins of the full spectrum (identity slices at k = 1)
        pos = spectrum[..., : m // 2 + 1]
        neg = spectrum[..., num_samples - (m // 2 - 1) :]
        spectrum_m = jnp.concatenate([pos, neg], axis=-1)  # (..., M)
        # mirror the rfft-half mask to the full grid: mask_full[g] =
        # mask[M-g] for g > M/2 (reverse of the interior — a flip, NOT a
        # gather)
        masks_full = jnp.concatenate([masks, masks[:, 1:-1][:, ::-1]], axis=-1)
        z_banded = jnp.fft.ifft(spectrum_m[..., None, :] * masks_full, axis=-1)
        return jnp.stack(
            [jnp.real(z_banded), jnp.imag(z_banded)], axis=-3
        ).astype(jnp.float32)
    banded = spectrum[..., None, : m // 2 + 1] * masks  # (..., bands, M/2+1)
    return jnp.fft.irfft(banded, n=m, axis=-1).astype(jnp.float32)


def apply_band_masks(x: jnp.ndarray, masks: jnp.ndarray) -> jnp.ndarray:
    """
    x: (..., N) real signal; masks: (bands, F) with F = N//2 + 1.
    Returns (..., bands, N): all bands filtered with ONE batched rfft+irfft.

    Stereo fast path: when the second-to-last axis is exactly 2 (an L/R
    pair) and N is even, the pair packs into ONE complex signal z = L + iR —
    a real, even (conjugate-symmetric) filter commutes with the packing, so
    one c2c fft + one c2c ifft per band yields BOTH channels' band signals
    (real part = L, imag = R). Exact in exact arithmetic; halves the FFT
    work of a c2c FFT (whether it beats two R2C transforms on the current
    card is ROADMAP queue 1 item 5).
    """
    kind, spectrum = full_band_spectrum(x)
    return banded_from_spectrum(kind, spectrum, masks, x.shape[-1])
