"""
The fused batched analysis engine.

One jit-compiled program computes EVERY report metric for a whole batch of
taps at once — load once, one shared STFT per (tap, channel), every fit
vectorised — where the reference runs the full per-module stack
sequentially per tap (bundle.py:56-68 over report.py:222-398, re-reading
the WAV ~10x and recomputing the STFT 3x per tap).

Shapes: samples (B, C, N) float32 zero-padded, lengths (B,) int32.
All config is static (a frozen dataclass) so the compiled program is reused
across runs; enable the persistent compilation cache to reuse it across
processes.

The engine returns a flat dict of device arrays, everything needed to write
the deterministic text summaries of a full report for every tap without
further device work.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from audio_analysis_tpu.ops import (
    dbfit,
    diffusion as dops,
    edc,
    fftmask,
    logfreq,
    selectq,
    stft,
    trim,
)
from audio_analysis_tpu.ops.common import hann_window_dynamic


def enable_persistent_compilation_cache() -> None:
    """Cache compiled programs across processes (enabled at ops import)."""
    from audio_analysis_tpu.ops import _enable_persistent_compilation_cache

    _enable_persistent_compilation_cache()


STFT_FFT_IMPLS = ("mx", "xla")


@dataclass(frozen=True)
class EngineConfig:
    """Static analysis configuration (the report defaults of the reference)."""

    sample_rate_hz: int = 48_000
    trim_to_peak: bool = True
    ignore_leading_seconds: float = 0.0

    # decay (decay.py:44-73)
    edc_floor_db: float = -120.0
    edc_epsilon: float = 1e-20
    fit_lower_limit_db: float = -80.0
    t20_range_db: Tuple[float, float] = (-5.0, -25.0)
    t30_range_db: Tuple[float, float] = (-5.0, -35.0)
    edt_range_db: Tuple[float, float] = (0.0, -10.0)

    # rt60 bands (rt60bands.py:44-69): "three" | "octave" | "third"
    band_mode: str = "three"
    low_upper_hz: float = 250.0
    mid_center_hz: float = 1000.0
    mid_width_octaves: float = 2.0
    high_lower_hz: float = 4000.0
    band_f_min_hz: float = 31.5
    band_f_max_hz: float = 16000.0
    transition_width_octaves: float = 1.0 / 6.0
    # Spectrum-crop decimation for low bands (fftmask.band_decimation_factors):
    # the Low band's inverse FFT + EDC + fit planes shrink 32x, Mid 4x at the
    # default edges (2x oversampling margin). Band samples are exact; the EDC
    # partial sums differ by windowed Riemann/boundary terms that grow with k
    # — <= 0.4 dB above -30 dB and <= 0.5% on T30/T20/EDT fits for smooth
    # decays (tests/test_bands_decimate.py). DELIBERATELY opt-in: fits on
    # NOISE-like narrowband content move percent-level under ANY grid change.
    # The auto-guard investigation (docs/PERFORMANCE.md) tried every
    # candidate guard — 4x/8x oversampling margins, capping k at 2, an
    # Euler-Maclaurin boundary correction — and none bounds the movement,
    # because it is the FIT's intrinsic sensitivity: the same full-rate fits
    # move by the same order under +-0.5 LSB of PCM16 input dither
    # (tests/test_bands_decimate.py::test_decimation_movement_is_intrinsic_
    # fit_sensitivity). Full-rate stays the default so the engine remains
    # numerically consistent with the per-file analyses modules (which keep
    # the reference's grid, rt60bands.py:392-399); enable via
    # --bands-decimate when bundle throughput matters more than last-percent
    # reproducibility of noisy narrowband fits.
    bands_decimate: bool = False

    # spectra
    f_min_hz: float = 20.0
    f_max_hz: float = 20000.0
    magnitude_floor_db: float = -120.0

    # stft (spectrogram.py:51-53) + modal cloud (modalcloud.py:56)
    n_fft: int = 4096
    hop_length: int = 512
    modal_n_fft: int = 8192
    modal_log_bins_per_octave: int = 24
    modal_min_bins: int = 24
    modal_min_fit_points: int = 10
    modal_min_peak_db_above_floor: float = 20.0
    # Stop the modal STFT at the last rfft bin any log bin uses (f_max is
    # 20 kHz of a 24 kHz Nyquist -> bins 3415.. of 4097 are zero-weight in
    # the bin matrix): stage-2 of the mx FFT and the magnitude/binning
    # planes shrink by the same ~17%. The trimmed path differs from the
    # untrimmed one only by an ~1e-4 dB accumulation reorder in the binning
    # matmul (oracle tolerances cover it). Set False for bit-compatibility
    # with the untrimmed output.
    modal_trim_bins: bool = True
    # mx stage split override for the modal 8192 FFT (None = balanced
    # 64x128; see ops/mxfft.rfft_mx). Untuned on the current accelerator.
    modal_fft_n1: int | None = None

    # diffusion with the report defaults (report.py:360-361)
    diffusion_window_seconds: float = 0.050
    diffusion_hop_seconds: float = 0.05
    diffusion_max_lag_ms: float = 5.0
    echo_density_threshold_rms: float = 1.0

    # rfft implementation for the frame STFT blocks (spectrogram/waterfall
    # STFT, modal 8192 STFT, diffusion correlations): "mx" = the four-step
    # matmul FFT (ops/mxfft.py), "xla" = jnp.fft (cuFFT on the GPU).
    # Full-signal FFTs (bands/FR/deconvolve) always use jnp.fft. Which one
    # is faster on the current card is an open measurement (ROADMAP).
    stft_fft_impl: str = "mx"
    # Matmul precision for the mx frame-FFT + diffusion-correlation stages.
    # On an H100, "highest" runs the f32 matmuls in full f32 (CUDA cores),
    # "high" and "default" let them run in TF32 on the tensor cores (~10
    # mantissa bits): modal fits move visibly at TF32, so the accurate
    # default stands.
    stft_fft_precision: str = "highest"

    # 0.5*(L+R) downmix ON DEVICE before analysis (io.py:89-92 policy) —
    # lets the mono path keep the raw int16 host->device transfer
    downmix_to_mono: bool = False

    # toggles (heavier blocks can be dropped for pure decay workloads)
    run_bands: bool = True
    run_fr: bool = True
    run_group_delay: bool = True
    run_stft: bool = True
    run_modal: bool = True
    run_diffusion: bool = True

    def __post_init__(self) -> None:
        if self.stft_fft_impl not in STFT_FFT_IMPLS:
            raise ValueError(
                f"Unknown stft_fft_impl: {self.stft_fft_impl!r} "
                f"(expected one of {STFT_FFT_IMPLS})"
            )


def _band_definitions(config: EngineConfig):
    if config.band_mode == "three":
        return fftmask.build_three_band_definitions(
            config.sample_rate_hz,
            config.low_upper_hz,
            config.mid_center_hz,
            config.mid_width_octaves,
            config.high_lower_hz,
        )
    if config.band_mode in ("octave", "third"):
        per_octave = 1 if config.band_mode == "octave" else 3
        return fftmask.build_fractional_octave_band_definitions(
            config.sample_rate_hz, per_octave, config.band_f_min_hz, config.band_f_max_hz
        )
    raise ValueError(f"Unknown band_mode: {config.band_mode!r}")


def band_names(config: EngineConfig) -> Tuple[str, ...]:
    """Band labels matching the engine's band_* output axis (host-side)."""
    return tuple(band.name for band in _band_definitions(config))


def _band_masks(config: EngineConfig, n: int) -> np.ndarray:
    return fftmask.build_band_mask_matrix(
        _band_definitions(config), n, config.sample_rate_hz, config.transition_width_octaves
    )


def _modal_bin_matrix(config: EngineConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    freq = np.fft.rfftfreq(config.modal_n_fft, 1.0 / config.sample_rate_hz)
    nyquist = 0.5 * config.sample_rate_hz
    f_min = float(np.clip(config.f_min_hz, 1.0, nyquist))
    f_max = float(np.clip(config.f_max_hz, f_min, nyquist))
    fsel = (freq >= f_min) & (freq <= f_max)
    edges = logfreq.build_log_bin_edges(
        f_min, f_max, config.modal_log_bins_per_octave, config.modal_min_bins
    )
    centres, mat_sel, nonempty = logfreq.build_log_bin_matrix(freq[fsel], edges)
    mat = np.zeros((centres.size, freq.size), dtype=np.float32)
    mat[:, fsel] = mat_sel
    return centres, mat, nonempty


def _edc(samples: jnp.ndarray, length: jnp.ndarray, config: "EngineConfig") -> edc.EdcResult:
    # the "edc" scope names these ops in profiler traces
    with jax.named_scope("edc"):
        return edc.schroeder_edc_db(
            samples, length, edc_epsilon=config.edc_epsilon, edc_floor_db=config.edc_floor_db
        )


def _fit_metrics(fit: dbfit.DecayFit, prefix: str) -> Dict[str, jnp.ndarray]:
    return {
        f"{prefix}_rt60": fit.rt60_seconds,
        f"{prefix}_slope": fit.slope_db_per_second,
        f"{prefix}_r2": fit.r_squared,
        f"{prefix}_t_start": fit.start_time_seconds,
        f"{prefix}_t_end": fit.end_time_seconds,
        f"{prefix}_ok": fit.ok,
    }


@partial(jax.jit, static_argnames=("config",))
def analyze_batch(
    samples: jnp.ndarray,  # (B, C, N) float32
    lengths: jnp.ndarray,  # (B,) int32
    config: EngineConfig = EngineConfig(),
) -> Dict[str, jnp.ndarray]:
    """The full fused metric computation. Returns a dict of (B, C, ...) arrays."""
    sr = config.sample_rate_hz
    if samples.dtype == jnp.int16:
        # PCM16 arrives raw and converts ON DEVICE (io.py:58-64 scaling):
        # the host->device transfer ships half the bytes of float32.
        samples = samples.astype(jnp.float32) * (1.0 / 32768.0)
    if config.downmix_to_mono and samples.shape[1] > 1:
        samples = jnp.mean(samples, axis=1, keepdims=True)
    b, c, n = samples.shape
    lengths_bc = jnp.broadcast_to(lengths[:, None], (b, c))

    out: Dict[str, jnp.ndarray] = {}

    # ---- alignment (per channel, like every reference module) ----
    aligned = trim.align_for_analysis(
        samples, lengths_bc, sr, config.trim_to_peak, config.ignore_leading_seconds
    )
    out["start_index"] = aligned.start_index
    out["segment_length"] = aligned.length

    # ---- IR view stats (peak of the raw signal, pre-trim) ----
    valid = jnp.arange(n, dtype=jnp.int32) < lengths_bc[..., None]
    out["peak_abs"] = jnp.max(jnp.where(valid, jnp.abs(samples), 0.0), axis=-1)

    # ---- decay: EDC + fits ----
    curve = _edc(aligned.samples, aligned.length, config)
    c0 = dbfit.crossing_time(curve.edc_db, curve.length, 0.0, sr)
    c10 = dbfit.crossing_time(curve.edc_db, curve.length, -10.0, sr)
    out["early10_time"] = c10.time_seconds - c0.time_seconds
    out["early10_ok"] = c0.found & c10.found & (c10.time_seconds >= c0.time_seconds)
    for name, range_db in (
        ("edt", config.edt_range_db),
        ("t20", config.t20_range_db),
        ("t30", config.t30_range_db),
    ):
        fit = dbfit.fit_decay_slope_over_db_range(
            curve.edc_db, curve.length, range_db, config.fit_lower_limit_db, sr
        )
        out.update(_fit_metrics(fit, name))

    # ---- rt60 bands: one batched filterbank + one batched fit set ----
    if config.run_bands:
        masks_np = _band_masks(config, n)
        num_bands = masks_np.shape[0]
        band_ranges = (
            ("band_t30", config.t30_range_db),
            ("band_t20", config.t20_range_db),
            ("band_edt", config.edt_range_db),
        )
        # per-band spectrum-crop decimation (opt-in): bands whose mask
        # support fits below a coarser Nyquist inverse-transform at N/k and
        # run their EDC + fits on planes k times smaller — exact band
        # samples (ops/fftmask.band_decimation_factors), the filter still
        # sees the full signal (rt60bands.py:392-394 order). Groups are
        # static per config, so each distinct k compiles one batched
        # inverse. The deviation vs the full-rate path is the fit sample
        # grid + a < k-sample trim-boundary sliver (parity-tested).
        factors = (
            fftmask.band_decimation_factors(masks_np, n)
            if config.bands_decimate
            else (1,) * num_bands
        )
        # only one branch of bands_one traces, so only its mask constants
        # are built and captured (each is a multi-MB f32 matrix)
        decimated = factors != (1,) * num_bands
        if decimated:
            dec_groups: Dict[int, Tuple[int, ...]] = {}
            for band_idx, factor in enumerate(factors):
                dec_groups[factor] = dec_groups.get(factor, ()) + (band_idx,)
            group_masks = {
                factor: jnp.asarray(fftmask.crop_half_masks(masks_np[list(idxs)], n, factor))
                for factor, idxs in dec_groups.items()
            }
        else:
            masks = jnp.asarray(masks_np)

        def bands_one(args):
            samples_1, start_1, length_1 = args  # (C, N), (C,), (C,)
            if not decimated:
                banded = fftmask.apply_band_masks(samples_1, masks)  # (C, bands, N)
                banded_aligned = trim.shift_to(
                    banded,
                    jnp.broadcast_to(start_1[..., None], banded.shape[:-1]),
                    jnp.broadcast_to(length_1[..., None], banded.shape[:-1]),
                )
                band_curve = _edc(banded_aligned.samples, banded_aligned.length, config)
                res = {}
                for name, range_db in band_ranges:
                    fit = dbfit.fit_decay_slope_over_db_range(
                        band_curve.edc_db, band_curve.length, range_db, config.fit_lower_limit_db, sr
                    )
                    res[f"{name}_rt60"] = fit.rt60_seconds  # (C, bands)
                    res[f"{name}_ok"] = fit.ok
                return res
            # grouped decimated path: one forward transform, one inverse +
            # EDC + fit set per distinct factor; columns stitched back into
            # the band order
            kind, spectrum = fftmask.full_band_spectrum(samples_1)
            cols: Dict[str, list] = {}
            for name, _range in band_ranges:
                cols[f"{name}_rt60"] = [None] * num_bands
                cols[f"{name}_ok"] = [None] * num_bands
            for factor, idxs in sorted(dec_groups.items()):
                banded = fftmask.banded_from_spectrum(
                    kind, spectrum, group_masks[factor], n, factor
                )  # (C, group, N // factor)
                banded_aligned = trim.shift_to(
                    banded,
                    jnp.broadcast_to((start_1 // factor)[..., None], banded.shape[:-1]),
                    jnp.broadcast_to((length_1 // factor)[..., None], banded.shape[:-1]),
                )
                band_curve = _edc(banded_aligned.samples, banded_aligned.length, config)
                for name, range_db in band_ranges:
                    fit = dbfit.fit_decay_slope_over_db_range(
                        band_curve.edc_db,
                        band_curve.length,
                        range_db,
                        config.fit_lower_limit_db,
                        sr / factor,
                    )
                    for group_col, band_idx in enumerate(idxs):
                        cols[f"{name}_rt60"][band_idx] = fit.rt60_seconds[..., group_col]
                        cols[f"{name}_ok"][band_idx] = fit.ok[..., group_col]
            return {key: jnp.stack(vals, axis=-1) for key, vals in cols.items()}

        if num_bands > 3:
            # octave/third-octave: the (B, C, bands, N) filterbank intermediate
            # is the device-memory high-water mark — lax.map over taps bounds
            # it to one tap at a time (like the STFT blocks)
            out.update(jax.lax.map(bands_one, (samples, aligned.start_index, lengths_bc)))
        else:
            out.update(bands_one((samples, aligned.start_index, lengths_bc)))

    # ---- frequency response diagnostics ----
    nyquist = 0.5 * sr
    f_min = float(np.clip(config.f_min_hz, 0.0, nyquist))
    f_max = float(np.clip(config.f_max_hz, f_min, nyquist))
    freqs_np = np.fft.rfftfreq(n, 1.0 / sr).astype(np.float32)
    sel_np = (freqs_np >= f_min) & (freqs_np <= f_max)
    freqs = jnp.asarray(freqs_np)
    sel = jnp.asarray(sel_np)

    if config.run_fr or config.run_group_delay:
        windowed = aligned.samples * hann_window_dynamic(n, aligned.length)
        spectrum = jnp.fft.rfft(windowed, axis=-1)

    if config.run_fr:
        mag = jnp.abs(spectrum).astype(jnp.float32)
        floor_lin = 10.0 ** (config.magnitude_floor_db / 20.0)
        mag = jnp.maximum(mag, floor_lin)
        mag_sel = jnp.where(sel, mag, 0.0)
        out["fr_peak_hz"] = freqs[jnp.argmax(mag_sel, axis=-1)]
        wsum = jnp.sum(mag_sel, axis=-1)
        out["fr_centroid_hz"] = jnp.sum(mag_sel * freqs, axis=-1) / jnp.maximum(wsum, 1e-30)

    # ---- group delay ----
    if config.run_group_delay:
        phase = jnp.unwrap(jnp.angle(spectrum), axis=-1)
        dw = 2.0 * jnp.pi / n
        gd = -(jnp.gradient(phase, axis=-1) / dw)
        # sort-free exact percentiles (ops/selectq): the F-bin bitonic sort
        # behind nanpercentile was this block's entire cost
        q = selectq.masked_percentiles(gd, sel, (10.0, 50.0, 90.0))
        out["gd_p10"] = q[..., 0]
        out["gd_median"] = q[..., 1]
        out["gd_p90"] = q[..., 2]

    # ---- shared STFT (spectrogram + waterfall consume this one) ----
    # The (B, C, T, n_fft) frame intermediates are the device-memory
    # high-water mark at bundle scale; lax.map over taps bounds them to one tap at a time
    # while each tap still batch-FFTs thousands of frames.
    if config.run_stft:
        # max in LINEAR magnitude, dB once on the (C,) result: log10 is
        # monotonic, so max(dB plane) == dB(max linear plane) — this skips a
        # transcendental pass over the full (T, F) plane per tap.
        stft_floor_lin = 10.0 ** (config.magnitude_floor_db / 20.0)

        def stft_one(args):
            samples_1, length_1 = args
            st = stft.stft_magnitude(
                samples_1,
                length_1,
                config.n_fft,
                config.hop_length,
                True,
                stft_floor_lin,
                config.stft_fft_impl,
                fft_precision=config.stft_fft_precision,
            )
            return st.num_frames, jnp.max(st.mag, axis=(-2, -1))

        num_frames, global_max_lin = jax.lax.map(stft_one, (aligned.samples, aligned.length))
        out["stft_num_frames"] = num_frames
        # waterfall-style global max per (tap, channel) — plot normalisation
        out["stft_global_max_db"] = 20.0 * jnp.log10(
            jnp.maximum(global_max_lin, stft_floor_lin)
        )

    # ---- modal cloud ----
    if config.run_modal:
        centres, bin_matrix, nonempty = _modal_bin_matrix(config)
        k_out = None
        if config.modal_trim_bins:
            nonzero_cols = np.nonzero(bin_matrix.any(axis=0))[0]
            if nonzero_cols.size:
                k_out = int(nonzero_cols[-1]) + 1
                bin_matrix = bin_matrix[:, :k_out]
        bin_matrix_dev = jnp.asarray(bin_matrix)

        floor_lin = 10.0 ** (config.magnitude_floor_db / 20.0)

        def modal_one(args):
            samples_1, length_1 = args
            stm1 = stft.stft_magnitude(
                samples_1,
                length_1,
                config.modal_n_fft,
                config.hop_length,
                True,
                floor_lin,
                config.stft_fft_impl,
                k_out,
                config.modal_fft_n1,
                config.stft_fft_precision,
            )
            # bin means in LINEAR magnitude (one matmul), dB once at the end;
            # full f32 (a TF32 matmul would move the modal fits)
            binned = jax.lax.dot_general(
                stm1.mag,
                bin_matrix_dev.T,
                dimension_numbers=(((stm1.mag.ndim - 1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )
            curves1 = jnp.swapaxes(
                20.0 * jnp.log10(jnp.maximum(binned, 1e-30)), -1, -2
            )
            return curves1, stm1.num_frames

        # per-tap mapping bounds the 8192-FFT frame intermediates in device
        # memory
        curves_db, modal_num_frames = jax.lax.map(
            modal_one, (aligned.samples, aligned.length)
        )
        # mask frames past validity out of the per-bin peak
        t_total = curves_db.shape[-1]
        frame_valid = jnp.arange(t_total) < modal_num_frames[..., None]
        curves_db = jnp.where(frame_valid[..., None, :], curves_db, config.magnitude_floor_db)
        peak = jnp.max(curves_db, axis=-1, keepdims=True)
        rel = curves_db - peak
        frame_rate = sr / config.hop_length
        frame_len = jnp.broadcast_to(modal_num_frames[..., None], rel.shape[:-1])
        fit = dbfit.fit_decay_slope_over_db_range(
            rel,
            frame_len,
            config.t30_range_db,
            config.fit_lower_limit_db,
            frame_rate,
            min_points=config.modal_min_fit_points,
        )
        reliable = (
            fit.ok
            & jnp.asarray(nonempty)
            & (
                (peak[..., 0] - config.magnitude_floor_db)
                >= config.modal_min_peak_db_above_floor
            )
        )
        rt60 = jnp.where(reliable, fit.rt60_seconds, jnp.nan)
        out["modal_count"] = jnp.sum(reliable, axis=-1)
        out["modal_median_rt60"] = jnp.nanmedian(rt60, axis=-1)
        out["modal_p90_rt60"] = jnp.nanpercentile(rt60, 90.0, axis=-1)
        out["modal_max_rt60"] = jnp.nanmax(rt60, axis=-1)
        out["modal_rt60"] = rt60  # (B, C, bins) for scatter plots
        out["modal_r2"] = jnp.where(reliable, fit.r_squared, jnp.nan)

    # ---- diffusion (report defaults) ----
    if config.run_diffusion:
        win = max(16, int(round(config.diffusion_window_seconds * sr)))
        hop = max(1, int(round(config.diffusion_hop_seconds * sr)))
        max_lag = max(1, int(round(config.diffusion_max_lag_ms / 1000.0 * sr)))
        series = dops.diffusion_metrics(
            aligned.samples,
            aligned.length,
            win,
            hop,
            max_lag,
            sr,
            config.echo_density_threshold_rms,
            True,
            config.stft_fft_impl,
            config.stft_fft_precision,
        )
        out["diff_median_autocorr"] = jnp.nanmedian(series.max_abs_autocorr, axis=-1)
        out["diff_median_echo_density"] = jnp.nanmedian(series.echo_density, axis=-1)
        out["diff_num_frames"] = series.num_frames

        # stereo-only metrics: the reference gates corr0/IACC on an actual
        # stereo file (diffusion.py:154-202) — a mono batch has no L/R pair
        # (corr0 would be identically 1.0), so C is gated statically here.
        if c == 2:
            # align L/R at the peak of the (L+R)/2 downmix
            combined = jnp.mean(samples, axis=1)  # (B, N)
            comb_aligned = trim.align_for_analysis(
                combined, lengths, sr, config.trim_to_peak, config.ignore_leading_seconds
            )
            start = comb_aligned.start_index
            l_al = trim.shift_to(samples[:, 0, :], start, lengths)
            r_al = trim.shift_to(samples[:, -1, :], start, lengths)
            stereo = dops.stereo_diffusion_metrics(
                l_al.samples, r_al.samples, l_al.length, win, hop, max_lag,
                config.stft_fft_impl, config.stft_fft_precision,
            )
            out["diff_median_corr0"] = jnp.nanmedian(stereo.corr0, axis=-1)
            out["diff_median_iacc"] = jnp.nanmedian(stereo.iacc_max, axis=-1)

    return out


# ----------------------------------------------------------------------------
# packed transport: one device->host fetch for the whole metric dict
# ----------------------------------------------------------------------------
#
# One contiguous D2H copy per step costs one transfer latency instead of
# one per metric: the engine therefore offers a "flat" variant that
# concatenates every metric into a single float32 vector on device; the
# host unpacks by the statically known shapes.


@partial(jax.jit, static_argnames=("config",))
def analyze_batch_flat(
    samples: jnp.ndarray, lengths: jnp.ndarray, config: EngineConfig = EngineConfig()
) -> jnp.ndarray:
    out = analyze_batch(samples, lengths, config)
    parts = [out[k].astype(jnp.float32).ravel() for k in sorted(out)]
    return jnp.concatenate(parts)


def _flat_spec(batch_shape, lengths_shape, config: EngineConfig):
    """(key, shape, dtype) layout of the flat vector, via eval_shape (no compute)."""
    shapes = jax.eval_shape(
        partial(analyze_batch, config=config),
        jax.ShapeDtypeStruct(batch_shape, jnp.float32),
        jax.ShapeDtypeStruct(lengths_shape, jnp.int32),
    )
    return [(k, shapes[k].shape, shapes[k].dtype) for k in sorted(shapes)]


def unpack_flat(flat: np.ndarray, spec) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    offset = 0
    for key, shape, dtype in spec:
        size = int(np.prod(shape)) if shape else 1
        chunk = flat[offset : offset + size].reshape(shape)
        if np.issubdtype(dtype, np.bool_):
            chunk = chunk > 0.5
        elif np.issubdtype(dtype, np.integer):
            chunk = chunk.astype(dtype)
        out[key] = chunk
        offset += size
    return out


def _pad_fill_length(n_max: int) -> int:
    """Claimed valid-length for the all-zero taps that pad a short final
    chunk up to the compiled chunk size. Any value in [a few hundred, n_max]
    works — it only has to be long enough that the padded rows' fits/masks
    stay in-range (they run on zeros and are DROPPED after the fetch, never
    merged into results). n_max//2 keeps it comfortably inside every
    analysis window without special-casing n_max itself."""
    return n_max // 2


def analyze_bundle(
    batch: np.ndarray,
    lengths: np.ndarray,
    config: EngineConfig = EngineConfig(),
    chunk_taps: int = 16,
) -> Dict[str, np.ndarray]:
    """
    Host entry: run the fused engine over a (B, C, N) bundle batch, chunking
    the tap axis to bound peak device memory (the STFT intermediate is the
    big one).
    Returns host numpy arrays concatenated over taps.
    """
    b = batch.shape[0]
    chunk_taps = min(chunk_taps, b)
    spec = _flat_spec((chunk_taps,) + batch.shape[1:], (chunk_taps,), config)

    pad_len = _pad_fill_length(batch.shape[-1])

    flats = []
    takes = []
    for lo in range(0, b, chunk_taps):
        hi = min(b, lo + chunk_taps)
        # pad the last chunk to the chunk size so every chunk reuses the
        # same compiled program
        take = hi - lo
        if take < chunk_taps:
            pad = chunk_taps - take
            cb = np.concatenate([batch[lo:hi], np.zeros_like(batch[:pad])], axis=0)
            cl = np.concatenate([lengths[lo:hi], np.full(pad, pad_len, np.int32)])
        else:
            cb, cl = batch[lo:hi], lengths[lo:hi]
        flats.append(
            analyze_batch_flat(jnp.asarray(cb), jnp.asarray(cl.astype(np.int32)), config)
        )
        takes.append(take)

    # all chunks dispatched; ONE packed host fetch for the whole bundle
    # (every fetch costs a full transfer latency)
    chunks = []
    for res, take in zip(fetch_packed(flats, spec), takes):
        if take < chunk_taps:
            res = {k: v[:take] for k, v in res.items()}
        chunks.append(res)

    return {k: np.concatenate([ch[k] for ch in chunks], axis=0) for k in chunks[0]}


def analyze_bundle_pipelined(
    loader,
    lengths: np.ndarray,
    n_max: int,
    config: EngineConfig = EngineConfig(),
    chunk_taps: int = 16,
    channels: int = 2,
    mesh=None,
    timings: "Dict[str, float] | None" = None,
    device_chunk_cache=None,
    prefetch_chunks: int = 2,
    on_chunk_result=None,
) -> Dict[str, np.ndarray]:
    """
    Pipelined host entry: `loader(lo, hi)` decodes taps [lo, hi) into a
    (hi-lo, channels, n_max) host chunk (see io.bundle.open_bundle_chunks_i16).
    Chunk k+1 decodes on a worker thread while chunk k's host->device
    transfer + engine dispatch are in flight, so WAV decode rides inside the
    device timeline instead of in front of it. Output matches analyze_bundle.

    With `mesh` (a 1D "taps" Mesh) each chunk is `chunk_taps` taps PER
    DEVICE, dispatched via shard_map (engine.mesh) with the decoded host
    chunk device_put straight onto the tap sharding; results still come
    back in one packed fetch.

    `prefetch_chunks` is how many chunks decode + upload ahead of the one
    the engine is consuming (>= 1): depth 2 keeps a second chunk's upload
    in flight while the worker that finished chunk k's upload decodes
    chunk k+2. Results are still consumed strictly in order; peak extra
    host+device memory is `prefetch_chunks` padded chunks.

    `device_chunk_cache`: an object with `get(chunk_index) -> device_array
    | None` and `put(chunk_index, arr)`. A hit skips that chunk's WAV
    decode AND its host->device upload, so re-analysing a bundle moves
    only the chunks whose audio changed — the unchanged-bundle rerun moves
    nothing, and a 1-tap iteration moves one chunk. Under `mesh` the
    cached entries are tap-SHARDED device arrays (device_put onto the
    mesh's tap sharding in the worker thread), so the same iterate-loop
    economics hold on multi-chip runs; the caller owns invalidation per
    chunk INCLUDING keying by the mesh (engine_report._ChunkCache does —
    a single-device entry must never serve a mesh run or vice versa).

    `on_chunk_result(lo, hi, res)`: when given, results are fetched ONE
    CHUNK AT A TIME, in order, and the callback runs on each (already
    pad-trimmed) chunk dict while LATER chunks are still computing on
    device — host consumers (the engine report's markdown writer) overlap
    the device timeline instead of serialising after it. Chunk k's fetch
    round-trip also hides under chunk k+1..n's compute, so the exposed
    fetch latency is one round trip either way; the per-chunk copies give
    up only the single-packed-fetch convention, which matters for MANY
    SMALL fetches (33 per chunk, the round-2 decay bug), not one per
    chunk. Callback time is reported separately (chunk_callback_s).
    """
    from concurrent.futures import ThreadPoolExecutor

    b = int(len(lengths))
    n_shards = int(mesh.shape["taps"]) if mesh is not None else 1
    chunk_taps = max(1, min(chunk_taps, -(-b // n_shards)))
    chunk = chunk_taps * n_shards
    lengths = np.asarray(lengths, np.int32)
    spec = None

    if mesh is not None:
        from audio_analysis_tpu.engine.mesh import analyze_batch_sharded_flat

        def dispatch(cb, cl):
            return analyze_batch_sharded_flat(mesh, cb, cl, config)

    else:

        def dispatch(cb, cl):
            return analyze_batch_flat(jnp.asarray(cb), jnp.asarray(cl), config)

    import time as _time

    # The worker thread decodes AND device_puts the padded chunk — onto the
    # default device, or straight onto the mesh's tap sharding — so the
    # host->device transfer of chunk k+1 overlaps chunk k's engine compute:
    # on a link where the upload is ~1/3 of warm e2e this is the difference
    # between serial and pipelined uploads.
    use_cache = device_chunk_cache is not None

    def load_chunk(lo: int, hi: int):
        if use_cache:
            hit = device_chunk_cache.get(lo // chunk)
            if hit is not None:
                return hit
        cb = loader(lo, hi)
        take = hi - lo
        if take < chunk:
            pad = chunk - take
            cb = np.concatenate([cb, np.zeros((pad,) + cb.shape[1:], cb.dtype)], axis=0)
        if mesh is not None:
            from audio_analysis_tpu.engine.mesh import tap_sharding

            cb = jax.device_put(cb, tap_sharding(mesh))
        else:
            cb = jnp.asarray(cb)
        if use_cache:
            device_chunk_cache.put(lo // chunk, cb)
        return cb

    decode_wait_s = dispatch_s = 0.0
    flats = []
    takes = []
    prefetch = max(1, int(prefetch_chunks))
    starts = list(range(0, b, chunk))
    with ThreadPoolExecutor(max_workers=prefetch) as ex:
        futs = {
            i: ex.submit(load_chunk, starts[i], min(b, starts[i] + chunk))
            for i in range(min(prefetch, len(starts)))
        }
        for i, lo in enumerate(starts):
            hi = min(b, lo + chunk)
            t0 = _time.perf_counter()
            cb = futs.pop(i).result()
            decode_wait_s += _time.perf_counter() - t0
            nxt = i + prefetch
            if nxt < len(starts):
                futs[nxt] = ex.submit(
                    load_chunk, starts[nxt], min(b, starts[nxt] + chunk)
                )
            if spec is None:
                spec = _flat_spec((chunk, channels, n_max), (chunk,), config)
            take = hi - lo
            cl = lengths[lo:hi]
            if take < chunk:
                cl = np.concatenate([cl, np.full(chunk - take, _pad_fill_length(n_max), np.int32)])
            t0 = _time.perf_counter()
            flats.append(dispatch(cb, cl))
            dispatch_s += _time.perf_counter() - t0
            takes.append(take)

    chunks = []
    callback_s = 0.0
    if on_chunk_result is None:
        t0 = _time.perf_counter()
        fetched = fetch_packed(flats, spec)
        fetch_s = _time.perf_counter() - t0
        for res, take in zip(fetched, takes):
            if take < chunk:
                res = {k: v[:take] for k, v in res.items()}
            chunks.append(res)
    else:
        fetch_s = 0.0
        for k_idx, (flat, take) in enumerate(zip(flats, takes)):
            t0 = _time.perf_counter()
            res = unpack_flat(np.asarray(flat), spec)
            fetch_s += _time.perf_counter() - t0
            if take < chunk:
                res = {k: v[:take] for k, v in res.items()}
            lo = k_idx * chunk
            t0 = _time.perf_counter()
            on_chunk_result(lo, lo + take, res)
            callback_s += _time.perf_counter() - t0
            chunks.append(res)
    if timings is not None:
        # decode_wait = time the pipeline actually BLOCKED on the worker's
        # WAV-decode + (single-device) h2d upload — work overlapped with
        # device compute doesn't show up here; dispatch = any non-overlapped
        # upload + trace/dispatch; fetch = the device->host metric copies
        # (includes waiting out device compute).
        timings["decode_wait_s"] = round(decode_wait_s, 4)
        timings["h2d_dispatch_s"] = round(dispatch_s, 4)
        timings["fetch_s"] = round(fetch_s, 4)
        if on_chunk_result is not None:
            timings["chunk_callback_s"] = round(callback_s, 4)
    return {k: np.concatenate([ch[k] for ch in chunks], axis=0) for k in chunks[0]}


def fetch_packed(flats, spec) -> "list[Dict[str, np.ndarray]]":
    """Fetch many dispatched flat metric vectors in ONE device->host copy
    (concatenated on device), then unpack each against `spec`."""
    packed = np.asarray(jnp.concatenate(flats)) if len(flats) > 1 else np.asarray(flats[0])
    per = int(flats[0].shape[0])
    return [unpack_flat(packed[i * per : (i + 1) * per], spec) for i in range(len(flats))]
