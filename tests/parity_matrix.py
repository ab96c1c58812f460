"""
Shared settings-variant table for live cross-tool parity testing.

tests/test_reference_parity.py pins parity at DEFAULT settings against
vendored fixtures. This module declares a matrix of NON-default settings
variants that tests/test_reference_parity_matrix.py runs through BOTH
implementations — the reference tool (/root/reference, pure NumPy, in a
subprocess via tests/_reference_matrix_runner.py) and this framework —
and diffs the deterministic text summaries. That exercises the flag
plumbing the fixture test cannot: trim/ignore/duration policies, band
modes, STFT geometries, slice selection, smoothing, phase modes.

Two inputs:
- "noise": the frozen golden IR (golden_utils.make_golden_ir) — a noisy
  exponential tail. Used for wideband analyses.
- "modal": a deterministic sum of exponentially-decaying sinusoids at
  third-octave centres (below). Used for the band-split and modal-cloud
  variants: narrowband decay fits on NOISY tails are chaotically
  sensitive to f32 accumulation (docs/PERFORMANCE.md, fit sensitivity), so cross-tool comparisons there need smooth
  single-mode-per-band decays, where the fits are rock stable and the
  reliability gates have huge margins.

Settings field names are identical on both sides by declared API parity
(reference decay.py:44-73, rt60bands.py:48-69, frequency_response.py:43-77,
spectrogram.py:37-63, waterfall.py:43-80, modalcloud.py:45-82,
diffusion.py:42-60, group_delay.py:38-58, filterplot.py:43-74), so each
variant's kwargs construct the settings dataclass in either tree.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SR = 48_000
MODAL_N = 1 << 16
MODAL_ONSET = 480


def make_modal_ir() -> np.ndarray:
    """Deterministic stereo IR: decaying sinusoids at third-octave centres.

    One mode per third-octave band from 125 Hz to 8 kHz (19 modes,
    f = 125·2^(k/3)), RT60 geometrically interpolated 0.9 → 0.35 s, plus
    a direct-sound delta at the onset so trim_to_peak is unambiguous.
    Returns (N, 2) float32 in [-1, 1].
    """
    n, sr = MODAL_N, SR
    t = np.arange(n - MODAL_ONSET, dtype=np.float64) / sr
    n_modes = 19
    ir = np.zeros((n, 2), np.float64)
    for k in range(n_modes):
        f = 125.0 * 2.0 ** (k / 3.0)
        rt60 = 0.9 * (0.35 / 0.9) ** (k / (n_modes - 1))
        env = 10.0 ** (-3.0 * t / rt60)
        ir[MODAL_ONSET:, 0] += 0.08 * np.sin(2 * np.pi * f * t) * env
        ir[MODAL_ONSET:, 1] += 0.07 * np.sin(2 * np.pi * f * t + 0.7 + 0.3 * k) * env
    ir[MODAL_ONSET, 0] += 0.9
    ir[MODAL_ONSET, 1] += 0.85
    return np.clip(ir, -1.0, 1.0).astype(np.float32)


DAMPED_N = 8192
DAMPED_ONSET = 64


def make_damped_ir() -> np.ndarray:
    """Deterministic stereo IR with FAST-decaying modes (RT60 5-20 ms).

    Purpose-built for the z-plane AR-fit variants: pole radii sit at
    0.94-0.99 with real margin to the unit circle, so the cross-tool pole
    statistics (max/median radius, unstable count) are numerically robust.
    A long-reverb input would put every pole within ~2e-4 of |z|=1, where
    the f32-vs-f64 fit difference can flip the unstable-pole count.
    """
    n, sr = DAMPED_N, SR
    t = np.arange(n - DAMPED_ONSET, dtype=np.float64) / sr
    modes = [(300.0, 0.02), (800.0, 0.015), (1700.0, 0.012), (3200.0, 0.008), (6400.0, 0.005)]
    ir = np.zeros((n, 2), np.float64)
    for k, (f, rt60) in enumerate(modes):
        env = 10.0 ** (-3.0 * t / rt60)
        ir[DAMPED_ONSET:, 0] += 0.15 * np.sin(2 * np.pi * f * t) * env
        ir[DAMPED_ONSET:, 1] += 0.13 * np.sin(2 * np.pi * f * t + 0.5 + 0.2 * k) * env
    ir[DAMPED_ONSET, :] += 0.8
    return np.clip(ir, -1.0, 1.0).astype(np.float32)


ODDMONO_N = 50_000
ODDMONO_ONSET = 24_999


def make_oddmono_ir() -> np.ndarray:
    """Deterministic MONO IR at a deliberately awkward length.

    50_000 samples is not a power of two and not a multiple of any STFT
    hop, and the single channel exercises the mono I/O policy — this
    input pins the pad-to-bucket + validity-mask machinery (the
    framework's core jit trick) against the reference's exact-length
    slicing, at DEFAULT settings across every module. Smooth modal
    content (like make_modal_ir) so every fit is stable; RT60s <= 0.35 s
    so the tail fully decays in the 0.52 s after the onset; and the
    onset sits MID-buffer (sample 24_999) so the band-split comparison
    is meaningful: with an onset near the start, the reference's
    exact-length circular FFT masking wraps the direct sound's
    anti-causal filter ringing to the buffer END (its Low-band EDC
    plateaus at -27 dB and the T30 fit reads ~20x long), while our
    padded-bucket filtering wraps it into the trimmed padding —
    measured, and documented as an intentional divergence in
    docs/MIGRATION.md. Mid-buffer onsets give both tools wrap-free
    tails. Returns (N, 1).
    """
    n, sr = ODDMONO_N, SR
    t = np.arange(n - ODDMONO_ONSET, dtype=np.float64) / sr
    ir = np.zeros(n, np.float64)
    for k in range(13):
        f = 180.0 * 2.0 ** (k / 2.0)  # half-octave spacing, 180 Hz - 11.5 kHz
        rt60 = 0.35 * (0.15 / 0.35) ** (k / 12.0)
        env = 10.0 ** (-3.0 * t / rt60)
        ir[ODDMONO_ONSET:] += 0.09 * np.sin(2 * np.pi * f * t + 0.4 * k) * env
    ir[ODDMONO_ONSET] += 0.9
    return np.clip(ir, -1.0, 1.0).astype(np.float32)[:, None]


_TUPLE_FIELDS = {"t20_range_db", "t30_range_db", "edt_range_db"}


def settings_kwargs(variant: Dict) -> Dict:
    """Variant kwargs with range fields coerced to tuples (hashable for jit)."""
    out = {}
    for key, value in variant["settings"].items():
        out[key] = tuple(value) if key in _TUPLE_FIELDS and value is not None else value
    return out


# Each entry: name (unique), module (analyses module key), input
# ("noise" | "modal"), settings (constructor kwargs), optional summary
# kwargs, optional tol override (rel, abs) — defaults to the module row
# in test_reference_parity.TOLERANCES.
VARIANTS: List[Dict] = [
    # --- decay: time-selection + fit policies (reference decay.py:44-73)
    dict(name="decay_mono_downmix", module="decay", input="noise",
         settings={"use_mono_downmix_for_stereo": True}),
    dict(name="decay_no_trim", module="decay", input="noise",
         settings={"trim_to_peak": False}),
    dict(name="decay_ignore_leading", module="decay", input="noise",
         settings={"ignore_leading_seconds": 0.01}),
    dict(name="decay_edt_smoothed", module="decay", input="noise",
         settings={"compute_edt": True, "edc_smoothing_window_samples": 32}),
    dict(name="decay_custom_ranges", module="decay", input="noise",
         settings={"t20_range_db": (-10.0, -30.0), "t30_range_db": (-10.0, -40.0)}),
    # --- rt60bands: band modes + transitions (reference rt60bands.py:48-69)
    dict(name="rt60_three_custom_edges", module="rt60bands", input="modal",
         settings={"low_upper_hz": 300.0, "high_lower_hz": 3000.0,
                   "transition_width_octaves": 0.25},
         summary={"include_t20": False, "include_edt": False},
         tol=(2e-3, 5e-3)),
    dict(name="rt60_octave", module="rt60bands", input="modal",
         settings={"band_mode": "octave", "f_min_hz": 125.0, "f_max_hz": 8000.0},
         summary={"include_t20": False, "include_edt": False},
         tol=(2e-3, 5e-3)),
    dict(name="rt60_third_octave", module="rt60bands", input="modal",
         settings={"band_mode": "third", "f_min_hz": 125.0, "f_max_hz": 8000.0},
         summary={"include_t20": False, "include_edt": False},
         tol=(2e-3, 5e-3)),
    dict(name="rt60_t20_edt", module="rt60bands", input="modal",
         settings={"include_t20": True, "include_edt": True},
         summary={"include_t20": True, "include_edt": True},
         tol=(2e-3, 5e-3)),
    # --- frequency response (reference frequency_response.py:43-77)
    # modal input: a smoothed NOISY spectrum is near-flat, so its argmax
    # peak is degenerate (the two tools legitimately pick opposite edge
    # bins); the modal spectrum has a well-defined strongest mode. The
    # device path's padded-FFT grid resamples the narrow modal peaks, so
    # the smoothed-spectrum centroid moves a few percent (measured 4.6%
    # worst channel — docs/MIGRATION.md grid note); the _exact variant
    # below pins the smoothing MATH itself at printed precision on the
    # reference's own grid.
    dict(name="fr_smoothed", module="frequency_response", input="modal",
         settings={"smoothing_log_bins": 9, "log_bins_per_octave": 48},
         tol=(5e-2, 1.0)),
    dict(name="fr_smoothed_exact", module="frequency_response", input="modal",
         settings={"smoothing_log_bins": 9, "log_bins_per_octave": 48},
         ours_extra={"exact_grid": True},
         tol=(1e-3, 0.051)),
    dict(name="fr_no_hann_no_trim", module="frequency_response", input="noise",
         settings={"use_hann_window": False, "trim_to_peak": False}),
    dict(name="fr_duration_band_limited", module="frequency_response", input="noise",
         settings={"analysis_duration_seconds": 0.5,
                   "f_min_hz": 50.0, "f_max_hz": 10000.0}),
    # --- spectrogram (reference spectrogram.py:37-63)
    dict(name="sg_2048_256", module="spectrogram", input="noise",
         settings={"n_fft": 2048, "hop_length": 256}),
    dict(name="sg_percentile_no_hann", module="spectrogram", input="noise",
         settings={"dynamic_range_db": None, "use_hann_window": False}),
    # --- waterfall slice modes (reference waterfall.py:62-70)
    dict(name="wf_uniform_time", module="waterfall", input="noise",
         settings={"slice_mode": "uniform_time", "num_slices": 10,
                   "slice_spacing_seconds": 0.08}),
    dict(name="wf_frames_slicemax_smoothed", module="waterfall", input="noise",
         settings={"slice_mode": "uniform_frames", "db_reference": "slice_max",
                   "smoothing_log_bins": 5}),
    # --- modal cloud metrics/binning (reference modalcloud.py:64-83)
    dict(name="mc_t20_coarse_bins", module="modalcloud", input="modal",
         settings={"metric": "t20", "log_bins_per_octave": 12}),
    # EDT (0..-10 dB) fits on slow-decay bins sit near zero slope, where
    # tiny f32 diffs move the huge extrapolated RT60s a few percent (the
    # fit-chaos mode); counts and medians still pin parity tightly.
    dict(name="mc_edt_4096", module="modalcloud", input="modal",
         settings={"metric": "edt", "n_fft": 4096, "hop_length": 256},
         tol=(5e-2, 5e-3)),
    # --- diffusion windows/thresholds (reference diffusion.py:42-60)
    dict(name="df_fast_windows", module="diffusion", input="noise",
         settings={"window_seconds": 0.03, "hop_seconds": 0.005,
                   "max_lag_milliseconds": 5.0,
                   "echo_density_normalise_to_gaussian": False}),
    dict(name="df_mono_threshold", module="diffusion", input="noise",
         settings={"use_mono_downmix_for_stereo": True,
                   "echo_density_threshold_rms": 1.5}),
    # --- group delay (reference group_delay.py:38-58)
    dict(name="gd_smoothed", module="group_delay", input="noise",
         settings={"smoothing_bins": 33}),
    dict(name="gd_fixed_fft_no_hann", module="group_delay", input="noise",
         settings={"fft_size": 131072, "use_hann_window": False}),
    # --- odd-length MONO input, default settings across the board: pins
    # the pad-to-bucket + validity-mask machinery against the reference's
    # exact-length slicing (see make_oddmono_ir)
    dict(name="odd_decay", module="decay", input="oddmono", settings={}),
    dict(name="odd_rt60_three", module="rt60bands", input="oddmono", settings={},
         summary={"include_t20": False, "include_edt": False},
         tol=(2e-3, 5e-3)),
    dict(name="odd_fr", module="frequency_response", input="oddmono", settings={}),
    dict(name="odd_spectrogram", module="spectrogram", input="oddmono", settings={}),
    dict(name="odd_waterfall", module="waterfall", input="oddmono", settings={}),
    dict(name="odd_modalcloud", module="modalcloud", input="oddmono", settings={}),
    dict(name="odd_diffusion", module="diffusion", input="oddmono", settings={}),
    # exact_grid: at this odd length the tools' default FFT grids differ
    # (reference next-pow2 32768 vs our 65536 bucket), and group delay on
    # modal content oscillates bin to bin, so equal-weight percentiles
    # are grid-sensitive (same class as fr_smoothed). The exact-grid path
    # still pins the odd-length trim/segment math at printed precision.
    dict(name="odd_group_delay", module="group_delay", input="oddmono", settings={},
         ours_extra={"exact_grid": True},
         tol=(1e-4, 0.0051)),
    # --- z-plane AR fit (reference zplane.py:45-63). Damped input: see
    # make_damped_ir. Our Gram is f32 on device (rcond-truncated f64
    # solve on host) vs the reference's f64 design-matrix lstsq, so pole
    # radii agree to ~1-2%, counts exactly.
    dict(name="zp_order16", module="zplane", input="damped",
         settings={"ar_order": 16},
         tol=(2e-2, 5e-3)),
    # Looser tol: at order 32 (10 true poles) the summary's median radius
    # sits among the 22 NOISE poles, whose radii move ~3% between the
    # reference's f64 fit and an accelerator's f32 Gram (the dominant pole
    # agrees to 0.02%). 8e-2 still fails an unstable-count
    # flip (integer step 1 >> 0.08).
    dict(name="zp_order32_ridge_zeros", module="zplane", input="damped",
         settings={"ar_order": 32, "ridge_lambda": 1e-5,
                   "derive_zeros": True, "zero_order": 16},
         tol=(8e-2, 5e-3)),
    # --- filter response (reference filterplot.py:43-74)
    dict(name="fp_radians_no_unwrap", module="filterplot", input="noise",
         settings={"phase_mode": "radians", "unwrap_phase": False}),
    # modal input for the same reason as fr_smoothed: a short noisy
    # segment's jagged spectrum makes peak/@1kHz grid-sensitive.
    dict(name="fp_duration_no_hann", module="filterplot", input="modal",
         settings={"analysis_duration_seconds": 0.4, "use_hann_window": False}),
]


# Deconvolution has no text summary — its output artifact IS a float32 IR
# WAV (reference deconvolve.py:110-116), so parity is asserted at the
# waveform level. Both tools read the same PCM16 sweep + recorded files
# and use the same next-pow2 FFT length policy (deconvolve.py:147), so
# the grids match exactly; the only drift is f32-vs-f64 FFT accumulation.
DECONVOLVE_VARIANTS: List[Dict] = [
    dict(name="dc_default", settings={}),
    dict(name="dc_fullfft_raw",
         settings={"output_length_mode": "full_fft", "normalise_peak": False,
                   "remove_dc": False, "regularization_relative": 1e-8}),
]

SWEEP_N = 48_000


def make_sweep() -> np.ndarray:
    """Deterministic 1 s log sweep 20 Hz - 20 kHz with half-cosine fades,
    mono float32 (the reference's exact exponential phase formula,
    gen/signals.py:413-425)."""
    sr, n = SR, SWEEP_N
    t = np.arange(n, dtype=np.float64) / sr
    f0, f1, duration = 20.0, 20000.0, n / sr
    k = np.log(f1 / f0)
    phase = 2.0 * np.pi * f0 * duration / k * (np.exp(t / duration * k) - 1.0)
    x = 0.5 * np.sin(phase)
    fade = 2048
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(fade) / fade)
    x[:fade] *= ramp
    x[-fade:] *= ramp[::-1]
    return x.astype(np.float32)


def make_recorded(ir: np.ndarray) -> np.ndarray:
    """The sweep played through the golden IR: per-channel f64 FFT
    convolution, full length, peak-scaled to 0.5. Returns (N, C) f32."""
    sweep = make_sweep().astype(np.float64)
    n_out = sweep.size + ir.shape[0] - 1
    n_fft = 1 << (n_out - 1).bit_length()
    sw = np.fft.rfft(sweep, n_fft)
    rec = np.empty((n_out, ir.shape[1]), np.float64)
    for c in range(ir.shape[1]):
        rec[:, c] = np.fft.irfft(sw * np.fft.rfft(ir[:, c].astype(np.float64), n_fft), n_fft)[:n_out]
    rec *= 0.5 / np.max(np.abs(rec))
    return rec.astype(np.float32)


def variant_by_name(name: str) -> Dict:
    for v in VARIANTS:
        if v["name"] == name:
            return v
    raise KeyError(name)
