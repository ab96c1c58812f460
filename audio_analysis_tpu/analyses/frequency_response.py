"""
Frequency response / magnitude spectrum view.

Parity with analyse/frequency_response.py: same settings (fr:43-77), Hann
window over the analysed segment, dB floor, optional log-frequency
smoothing (96 bins/oct grid), peak + amplitude-weighted centroid
diagnostics (fr:249-260), `<basename>_fr.png`, and the one-line-per-channel
summary (fr:424-432).

Grid note: the rfft runs at the padded bucket length (zero-padded = denser
sampling of the same windowed DTFT), so the bin grid is finer than the
reference's exact-length FFT; diagnostics agree within a bin width.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import matplotlib.ticker as mticker
import numpy as np

from audio_analysis_tpu.analyses._common import (
    FileDsp,
    fetch_db_plane_i16,
    host_aligned_segments,
    single_channel_dsp,
    suffixed_png,
)
from audio_analysis_tpu.ops import logfreq, spectral
from audio_analysis_tpu.plot import (
    create_figure_and_axis,
    decimate_minmax_log,
    finalize_and_show_or_save,
    hz_tick_formatter,
    label_decibel_axis,
    render_line_figure,
)


@dataclass(frozen=True)
class FrequencyResponseAnalysisSettings:
    use_mono_downmix_for_stereo: bool = False
    trim_to_peak: bool = True
    ignore_leading_seconds: float = 0.0
    analysis_duration_seconds: Optional[float] = None
    use_hann_window: bool = True
    magnitude_floor_db: float = -120.0
    f_min_hz: float = 20.0
    f_max_hz: float = 20000.0
    smoothing_log_bins: int = 0
    log_bins_per_octave: int = 96
    # CPU NumPy fallback at the reference's EXACT segment-length FFT grid
    # (frequency_response.py:216-218) instead of the padded pow-2 bucket —
    # for byte-level cross-tool diffing; ~1e-6 agreement with the reference.
    exact_grid: bool = False


@dataclass(frozen=True)
class FrequencyResponsePlotSettings:
    secondary_channel_alpha: float = 0.7
    ylim_db: Optional[Tuple[float, float]] = None


@dataclass(frozen=True)
class ChannelFrequencyResponse:
    channel_name: str
    sample_rate_hz: int
    analysis_start_sample_index: int
    analysis_length_samples: int
    frequency_hz: np.ndarray
    magnitude_db: np.ndarray
    peak_frequency_hz: float
    spectral_centroid_hz: float


def analyse_frequency_response_channels(
    dsp: FileDsp,
    settings: FrequencyResponseAnalysisSettings,
) -> List[ChannelFrequencyResponse]:
    """All channels in one batched spectrum dispatch."""
    sample_rate_hz = dsp.sample_rate_hz
    aligned = dsp.aligned(
        settings.trim_to_peak,
        settings.ignore_leading_seconds,
        settings.analysis_duration_seconds,
    )
    starts, seg_lens = dsp.aligned_host_meta(
        settings.trim_to_peak,
        settings.ignore_leading_seconds,
        settings.analysis_duration_seconds,
    )
    if int(seg_lens.min()) < 32:
        raise ValueError("Not enough samples after trimming/selection to analyse spectrum.")

    nyquist = 0.5 * sample_rate_hz
    f_min = float(np.clip(settings.f_min_hz, 0.0, nyquist))
    f_max = float(np.clip(settings.f_max_hz, f_min, nyquist))

    if settings.exact_grid:
        return _analyse_exact_grid(dsp, settings, f_min, f_max)

    spec = spectral.segment_spectrum(
        aligned.samples,
        aligned.length,
        sample_rate_hz,
        use_hann_window=settings.use_hann_window,
        magnitude_floor_db=settings.magnitude_floor_db,
        f_min_hz=f_min,
        f_max_hz=f_max,
        unwrap_phase=False,
    )

    n_pad = dsp.bucket_samples
    freq_hz = np.fft.rfftfreq(n_pad, d=1.0 / sample_rate_hz).astype(np.float32)
    # (C, F) dB plane crosses the link as 1/128-dB int16 (plot feed; the
    # peak/centroid diagnostics are computed on device from the full f32)
    mag_db_all = fetch_db_plane_i16(spec.mag_db)

    sel = (freq_hz >= f_min) & (freq_hz <= f_max)
    if not np.any(sel):
        raise ValueError("Selected frequency range is empty (check f_min_hz/f_max_hz).")

    smoothed = settings.smoothing_log_bins and int(settings.smoothing_log_bins) > 1
    if smoothed:
        f_min_s = float(np.clip(settings.f_min_hz, 1.0, nyquist))
        f_max_s = float(np.clip(settings.f_max_hz, f_min_s, nyquist))
        import jax.numpy as jnp

        mag_db_all = np.asarray(
            logfreq.smooth_mag_db_log_frequency(
                freq_hz,
                jnp.asarray(mag_db_all),
                f_min_s,
                f_max_s,
                int(settings.smoothing_log_bins),
                int(settings.log_bins_per_octave),
            )
        )
    else:
        from audio_analysis_tpu.ops import transport

        # one packed transfer instead of two
        peak_all, centroid_all = transport.fetch_packed_tree(
            (spec.peak_frequency_hz, spec.spectral_centroid_hz)
        )

    results = []
    for i, channel_name in enumerate(dsp.channel_names):
        mag_db = mag_db_all[i]
        if smoothed:
            # recompute diagnostics on the smoothed curve (fr:238-260)
            mag_sel_lin = 10.0 ** (mag_db[sel].astype(np.float64) / 20.0)
            peak_freq = float(freq_hz[sel][np.argmax(mag_db[sel])])
            wsum = float(mag_sel_lin.sum())
            centroid = (
                float((freq_hz[sel] * mag_sel_lin).sum() / wsum)
                if wsum > 0
                else float(freq_hz[sel][0])
            )
        else:
            peak_freq = float(peak_all[i])
            centroid = float(centroid_all[i])

        results.append(
            ChannelFrequencyResponse(
                channel_name=channel_name,
                sample_rate_hz=int(sample_rate_hz),
                analysis_start_sample_index=int(starts[i]),
                analysis_length_samples=int(seg_lens[i]),
                frequency_hz=freq_hz,
                magnitude_db=mag_db.astype(np.float32),
                peak_frequency_hz=peak_freq,
                spectral_centroid_hz=centroid,
            )
        )
    return results


def _analyse_exact_grid(
    dsp: FileDsp,
    settings: FrequencyResponseAnalysisSettings,
    f_min: float,
    f_max: float,
) -> List[ChannelFrequencyResponse]:
    """
    Host float64 fallback on the reference's EXACT segment-length FFT grid
    (frequency_response.py:203-260): rfft of the hann-windowed exact
    segment, dB floor, peak/centroid over the selected range. Log-frequency
    smoothing reuses ops.logfreq on the exact grid.
    """
    sample_rate_hz = dsp.sample_rate_hz
    segments, starts, seg_lens = host_aligned_segments(
        dsp, settings.trim_to_peak, settings.ignore_leading_seconds,
        settings.analysis_duration_seconds,
    )
    floor_lin = 10.0 ** (float(settings.magnitude_floor_db) / 20.0)
    smoothed = settings.smoothing_log_bins and int(settings.smoothing_log_bins) > 1

    results = []
    for i, (channel_name, x) in enumerate(zip(dsp.channel_names, segments)):
        n = int(x.size)
        xw = x * np.hanning(n) if settings.use_hann_window else x
        mag = np.maximum(np.abs(np.fft.rfft(xw)), floor_lin)
        mag_db = (20.0 * np.log10(mag)).astype(np.float32)
        freq_hz = np.fft.rfftfreq(n, d=1.0 / float(sample_rate_hz)).astype(np.float32)

        if smoothed:
            import jax.numpy as jnp

            nyq = 0.5 * float(sample_rate_hz)
            f_min_s = float(np.clip(settings.f_min_hz, 1.0, nyq))
            f_max_s = float(np.clip(settings.f_max_hz, f_min_s, nyq))
            mag_db = np.asarray(
                logfreq.smooth_mag_db_log_frequency(
                    freq_hz,
                    jnp.asarray(mag_db[None, :]),
                    f_min_s,
                    f_max_s,
                    int(settings.smoothing_log_bins),
                    int(settings.log_bins_per_octave),
                )
            )[0]

        sel = (freq_hz >= f_min) & (freq_hz <= f_max)
        if not np.any(sel):
            raise ValueError("Selected frequency range is empty (check f_min_hz/f_max_hz).")
        mag_sel_db = mag_db[sel]
        mag_sel_lin = 10.0 ** (mag_sel_db.astype(np.float64) / 20.0)
        peak_freq = float(freq_hz[sel][int(np.argmax(mag_sel_db))])
        wsum = float(mag_sel_lin.sum())
        centroid = (
            float((freq_hz[sel].astype(np.float64) * mag_sel_lin).sum() / wsum)
            if wsum > 0.0
            else float(freq_hz[sel][0])
        )

        results.append(
            ChannelFrequencyResponse(
                channel_name=channel_name,
                sample_rate_hz=int(sample_rate_hz),
                analysis_start_sample_index=int(starts[i]),
                analysis_length_samples=int(seg_lens[i]),
                frequency_hz=freq_hz,
                magnitude_db=mag_db.astype(np.float32),
                peak_frequency_hz=peak_freq,
                spectral_centroid_hz=centroid,
            )
        )
    return results


def analyse_frequency_response_for_channel(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    settings: FrequencyResponseAnalysisSettings,
) -> ChannelFrequencyResponse:
    return analyse_frequency_response_channels(
        single_channel_dsp(samples, sample_rate_hz, channel_name), settings
    )[0]


def analyse_frequency_response_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[FrequencyResponseAnalysisSettings] = None,
    dsp: Optional[FileDsp] = None,
) -> List[ChannelFrequencyResponse]:
    if settings is None:
        settings = FrequencyResponseAnalysisSettings()
    if dsp is None:
        dsp = FileDsp.from_wav_file(input_wav_file_path, settings.use_mono_downmix_for_stereo)
    return analyse_frequency_response_channels(dsp, settings)


def _fr_band_limits(
    channel_results: List[ChannelFrequencyResponse],
    analysis_settings: FrequencyResponseAnalysisSettings,
) -> Tuple[float, float]:
    nyquist = 0.5 * float(channel_results[0].sample_rate_hz)
    f_min = float(np.clip(analysis_settings.f_min_hz, 1.0, nyquist))
    f_max = float(np.clip(analysis_settings.f_max_hz, f_min, nyquist))
    return f_min, f_max


def _fr_plot_lines(
    channel_results: List[ChannelFrequencyResponse],
    plot_settings: FrequencyResponsePlotSettings,
    f_min: float,
    f_max: float,
) -> List[tuple]:
    """(x, y, Line2D-kwargs) for the FR figure — the ONE construction both
    the interactive figure and the templated render path consume."""
    lines: List[tuple] = []
    for idx, r in enumerate(channel_results):
        alpha = 1.0 if idx == 0 else float(plot_settings.secondary_channel_alpha)
        # 500k-bin spectrum -> log-bucketed min-max envelope at display res
        f_plot, m_plot = decimate_minmax_log(r.frequency_hz, r.magnitude_db, f_min, f_max)
        lines.append(
            (
                f_plot,
                m_plot,
                {
                    "alpha": alpha,
                    "label": (
                        f"{r.channel_name}  peak={r.peak_frequency_hz:.0f}Hz  "
                        f"centroid={r.spectral_centroid_hz:.0f}Hz"
                    ),
                },
            )
        )
    return lines


def _fr_axis_setup(
    axis,
    channel_results: List[ChannelFrequencyResponse],
    plot_settings: FrequencyResponsePlotSettings,
    f_min: float,
    f_max: float,
) -> None:
    """Static FR axis config, idempotent (shared by both render paths)."""
    axis.set_xscale("log")
    axis.set_xticks([20, 50, 100, 200, 500, 1000, 2000, 5000, 10000, 20000])
    axis.xaxis.set_major_formatter(mticker.FuncFormatter(hz_tick_formatter))
    axis.xaxis.set_minor_locator(mticker.NullLocator())  # majors carry the scale
    axis.set_xlabel("Frequency (Hz)")
    label_decibel_axis(axis)

    if plot_settings.ylim_db is not None:
        axis.set_ylim(*plot_settings.ylim_db)
    else:
        vals = [
            r.magnitude_db[(r.frequency_hz >= f_min) & (r.frequency_hz <= f_max)]
            for r in channel_results
        ]
        y = np.concatenate(vals) if vals else np.array([], np.float32)
        if y.size:
            axis.set_ylim(float(np.percentile(y, 1.0)) - 6.0, float(np.percentile(y, 99.5)) + 6.0)

    axis.set_xlim(f_min, f_max)
    axis.grid(True, which="both", linestyle=":", linewidth=0.5)


def plot_frequency_response_figure(
    channel_results: List[ChannelFrequencyResponse],
    analysis_settings: FrequencyResponseAnalysisSettings,
    plot_settings: FrequencyResponsePlotSettings,
    title: Optional[str] = None,
):
    figure, axis = create_figure_and_axis(title=title)
    f_min, f_max = _fr_band_limits(channel_results, analysis_settings)
    for x, y, props in _fr_plot_lines(channel_results, plot_settings, f_min, f_max):
        axis.plot(x, y, **props)
    _fr_axis_setup(axis, channel_results, plot_settings, f_min, f_max)
    axis.legend(loc="best")
    return figure


def plot_frequency_response_from_wav_file(
    input_wav_file_path: str | Path,
    analysis_settings: Optional[FrequencyResponseAnalysisSettings] = None,
    plot_settings: Optional[FrequencyResponsePlotSettings] = None,
    output_basename: Optional[str | Path] = None,
    show_interactive: bool = True,
    dsp: Optional[FileDsp] = None,
) -> List[ChannelFrequencyResponse]:
    if analysis_settings is None:
        analysis_settings = FrequencyResponseAnalysisSettings()
    if plot_settings is None:
        plot_settings = FrequencyResponsePlotSettings()

    results = analyse_frequency_response_from_wav_file(
        input_wav_file_path, analysis_settings, dsp=dsp
    )
    render_frequency_response_plots(
        results, analysis_settings, plot_settings, output_basename, show_interactive,
        input_wav_file_path,
    )
    return results


def render_frequency_response_plots(
    results: List[ChannelFrequencyResponse],
    analysis_settings: FrequencyResponseAnalysisSettings,
    plot_settings: FrequencyResponsePlotSettings,
    output_basename: Optional[str | Path],
    show_interactive: bool,
    title_source: str | Path,
) -> None:
    """Figure + save only (host matplotlib); results come from analyse_*.

    Template path mirrors plot_frequency_response_figure exactly — the
    byte-identity guard is tests/test_figure_templates.py."""
    title = f"Frequency response (spectrum) — {title_source}"
    output_path = None if output_basename is None else suffixed_png(output_basename, "_fr")
    if output_path is None or show_interactive:
        figure = plot_frequency_response_figure(
            results, analysis_settings, plot_settings, title=title
        )
        finalize_and_show_or_save(figure, output_path, show_interactive)
        return

    f_min, f_max = _fr_band_limits(results, analysis_settings)
    lines = _fr_plot_lines(results, plot_settings, f_min, f_max)

    def setup(axis):
        _fr_axis_setup(axis, results, plot_settings, f_min, f_max)

    render_line_figure(
        "frequency_response",
        (analysis_settings, plot_settings, int(results[0].sample_rate_hz), len(results)),
        title,
        lines,
        output_path,
        show_interactive,
        legend_kwargs={"loc": "best"},
        setup=setup,
    )


def summarise_frequency_response_results_text(
    channel_results: List[ChannelFrequencyResponse],
) -> str:
    return "\n".join(
        f"[{r.channel_name}] start_sample={r.analysis_start_sample_index}  "
        f"len_samples={r.analysis_length_samples}  "
        f"peak={r.peak_frequency_hz:.1f}Hz  centroid={r.spectral_centroid_hz:.1f}Hz"
        for r in channel_results
    )
