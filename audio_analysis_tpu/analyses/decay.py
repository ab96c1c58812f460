"""
Decay analysis: Schroeder EDC + T20/T30/EDT line fits + RT60.

Capability parity with the reference's analyse/decay.py: same settings
fields and defaults (decay.py:44-73), same fit definitions
(T20 -5..-25 dB, T30 -5..-35 dB, EDT 0..-10 dB, RT60 = -60/slope,
decay.py:202-260), same plot (`<basename>_decay.png`, decay.py:486) and the
same diff-stable text summary format (decay.py:502-542).

The compute path is the batched device kernel library (ops.edc / ops.dbfit);
this module is the thin per-file result layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from audio_analysis_tpu.analyses._common import FileDsp, single_channel_dsp, suffixed_png
from audio_analysis_tpu.ops import dbfit, edc, transport
from audio_analysis_tpu.plot import (
    create_figure_and_axis,
    decimate_minmax,
    finalize_and_show_or_save,
    label_decibel_axis,
    label_time_axis_seconds,
    render_line_figure,
)


@dataclass(frozen=True)
class DecayAnalysisSettings:
    use_mono_downmix_for_stereo: bool = False
    trim_to_peak: bool = True
    ignore_leading_seconds: float = 0.0
    edc_floor_db: float = -120.0
    edc_epsilon: float = 1e-20
    fit_lower_limit_db: float = -80.0
    t20_range_db: Tuple[float, float] = (-5.0, -25.0)
    t30_range_db: Tuple[float, float] = (-5.0, -35.0)
    compute_edt: bool = False
    edt_range_db: Tuple[float, float] = (0.0, -10.0)
    edc_smoothing_window_samples: int = 0


@dataclass(frozen=True)
class LinearDecayFit:
    name: str
    range_db: Tuple[float, float]
    start_time_seconds: float
    end_time_seconds: float
    slope_db_per_second: float
    intercept_db: float
    r_squared: float
    rt60_seconds: float


@dataclass(frozen=True)
class ChannelDecayAnalysis:
    channel_name: str
    sample_rate_hz: int
    analysis_start_sample_index: int
    time_seconds: np.ndarray
    edc_db: np.ndarray
    early_decay_10db_time_seconds: Optional[float]
    fits: Dict[str, LinearDecayFit]


@dataclass(frozen=True)
class DecayPlotSettings:
    show_fit_lines: bool = True
    secondary_channel_alpha: float = 0.7
    ylim_db: Tuple[float, float] = (-120.0, 5.0)


# ----------------------------------------------------------------------------
# analysis
# ----------------------------------------------------------------------------


def _fit_from_kernel(
    fit: dbfit.DecayFit, row: int, name: str, range_db: Tuple[float, float]
) -> Optional[LinearDecayFit]:
    if not bool(np.asarray(fit.ok)[row]):
        return None
    return LinearDecayFit(
        name=name,
        range_db=(float(range_db[0]), float(range_db[1])),
        start_time_seconds=float(np.asarray(fit.start_time_seconds)[row]),
        end_time_seconds=float(np.asarray(fit.end_time_seconds)[row]),
        slope_db_per_second=float(np.asarray(fit.slope_db_per_second)[row]),
        intercept_db=float(np.asarray(fit.intercept_db)[row]),
        r_squared=float(np.asarray(fit.r_squared)[row]),
        rt60_seconds=float(np.asarray(fit.rt60_seconds)[row]),
    )


def analyse_decay_channels(
    dsp: FileDsp,
    settings: DecayAnalysisSettings,
) -> List[ChannelDecayAnalysis]:
    """All channels in one batched EDC + fit dispatch."""
    sample_rate_hz = dsp.sample_rate_hz
    aligned = dsp.aligned(settings.trim_to_peak, settings.ignore_leading_seconds)
    starts, seg_lens = dsp.aligned_host_meta(
        settings.trim_to_peak, settings.ignore_leading_seconds
    )
    if int(seg_lens.min()) < 4:
        raise ValueError("Not enough samples after trimming/ignoring to compute EDC.")

    curve = edc.schroeder_edc_db(
        aligned.samples,
        aligned.length,
        edc_epsilon=settings.edc_epsilon,
        edc_floor_db=settings.edc_floor_db,
        smoothing_window_samples=settings.edc_smoothing_window_samples,
    )

    c0 = dbfit.crossing_time(curve.edc_db, curve.length, 0.0, sample_rate_hz)
    c10 = dbfit.crossing_time(curve.edc_db, curve.length, -10.0, sample_rate_hz)

    plan = []
    if settings.compute_edt:
        plan.append(("EDT", settings.edt_range_db))
    plan.append(("T20", settings.t20_range_db))
    plan.append(("T30", settings.t30_range_db))
    fits_dev = [
        dbfit.fit_decay_slope_over_db_range(
            curve.edc_db, curve.length, range_db, settings.fit_lower_limit_db, sample_rate_hz
        )
        for _, range_db in plan
    ]

    # ONE packed device->host transfer for crossings + every fit field (the
    # per-field fetches here were 33 separate transfers); the EDC dB curve
    # crosses separately as 1/128-dB int16 fixed point (half the bytes,
    # exact to ±0.002 dB — it only feeds the plot)
    from audio_analysis_tpu.analyses._common import fetch_db_plane_i16

    c0, c10, fits_host = transport.fetch_packed_tree((c0, c10, fits_dev))
    edc_host = fetch_db_plane_i16(curve.edc_db)
    c0_found, c0_t = c0.found, c0.time_seconds
    c10_found, c10_t = c10.found, c10.time_seconds
    kernel_fits = [
        (name, range_db, fit) for (name, range_db), fit in zip(plan, fits_host)
    ]

    results = []
    for i, channel_name in enumerate(dsp.channel_names):
        early: Optional[float] = None
        if bool(c0_found[i]) and bool(c10_found[i]):
            t0, t10 = float(c0_t[i]), float(c10_t[i])
            if t10 >= t0:
                early = t10 - t0

        fits: Dict[str, LinearDecayFit] = {}
        for name, range_db, kfit in kernel_fits:
            made = _fit_from_kernel(kfit, i, name, range_db)
            if made is not None:
                fits[name] = made

        seg_len = int(seg_lens[i])
        results.append(
            ChannelDecayAnalysis(
                channel_name=channel_name,
                sample_rate_hz=int(sample_rate_hz),
                analysis_start_sample_index=int(starts[i]),
                time_seconds=(
                    np.arange(seg_len, dtype=np.float32) / float(sample_rate_hz)
                ).astype(np.float32),
                edc_db=edc_host[i][:seg_len].astype(np.float32),
                early_decay_10db_time_seconds=early,
                fits=fits,
            )
        )
    return results


def analyse_decay_for_channel(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    settings: DecayAnalysisSettings,
) -> ChannelDecayAnalysis:
    return analyse_decay_channels(
        single_channel_dsp(samples, sample_rate_hz, channel_name), settings
    )[0]


def analyse_decay_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[DecayAnalysisSettings] = None,
    dsp: Optional[FileDsp] = None,
) -> List[ChannelDecayAnalysis]:
    if settings is None:
        settings = DecayAnalysisSettings()
    if dsp is None:
        dsp = FileDsp.from_wav_file(input_wav_file_path, settings.use_mono_downmix_for_stereo)
    return analyse_decay_channels(dsp, settings)


# ----------------------------------------------------------------------------
# plotting
# ----------------------------------------------------------------------------


def _decay_plot_lines(
    channel_analyses: List[ChannelDecayAnalysis],
    plot_settings: DecayPlotSettings,
) -> List[tuple]:
    """(x, y, Line2D-kwargs) for every decay figure line — the ONE place
    the EDC curves and fit lines (with their labels) are constructed; both
    the interactive figure and the templated render path consume it."""
    lines: List[tuple] = []
    for idx, result in enumerate(channel_analyses):
        alpha = 1.0 if idx == 0 else float(plot_settings.secondary_channel_alpha)
        # min-max envelope decimation: the EDC spans ~10^6 samples, far
        # below pixel resolution; rendering cost must scale with pixels
        t_plot, edc_plot = decimate_minmax(result.time_seconds, result.edc_db)
        lines.append((t_plot, edc_plot, {"alpha": alpha, "label": None}))

        if plot_settings.show_fit_lines:
            for fit_name in ("EDT", "T20", "T30"):
                fit = result.fits.get(fit_name)
                if fit is None:
                    continue
                t_line = np.array([fit.start_time_seconds, fit.end_time_seconds], np.float32)
                y_line = fit.slope_db_per_second * t_line + fit.intercept_db
                if fit.name == "EDT":
                    if result.early_decay_10db_time_seconds is not None:
                        label = (
                            f"EDT {result.channel_name}  {fit.rt60_seconds:.2f}s  "
                            f"Δ10dB={result.early_decay_10db_time_seconds:.3f}s"
                        )
                    else:
                        label = f"EDT {result.channel_name}  {fit.rt60_seconds:.2f}s  Δ10dB=NA"
                else:
                    label = f"{fit.name} {result.channel_name}  {fit.rt60_seconds:.2f}s"
                lines.append(
                    (t_line, y_line, {"alpha": alpha, "linestyle": "--", "label": label})
                )
    return lines


def _decay_axhlines(axis, analysis_settings: DecayAnalysisSettings) -> None:
    axis.axhline(float(analysis_settings.t20_range_db[0]), linestyle=":", linewidth=1.0)
    axis.axhline(float(analysis_settings.t20_range_db[1]), linestyle=":", linewidth=1.0)
    axis.axhline(float(analysis_settings.t30_range_db[1]), linestyle=":", linewidth=1.0)
    axis.axhline(float(analysis_settings.fit_lower_limit_db), linestyle=":", linewidth=1.0)


def plot_decay_figure(
    channel_analyses: List[ChannelDecayAnalysis],
    analysis_settings: DecayAnalysisSettings,
    plot_settings: DecayPlotSettings,
    title: Optional[str] = None,
):
    figure, axis = create_figure_and_axis(title=title)
    label_time_axis_seconds(axis)
    label_decibel_axis(axis)
    axis.set_ylim(*plot_settings.ylim_db)

    for x, y, props in _decay_plot_lines(channel_analyses, plot_settings):
        axis.plot(x, y, **props)

    _decay_axhlines(axis, analysis_settings)
    axis.grid(True, which="both", linestyle=":", linewidth=0.5)
    axis.legend(loc="best")
    return figure


def render_decay_plots(
    results: List[ChannelDecayAnalysis],
    analysis_settings: DecayAnalysisSettings,
    plot_settings: DecayPlotSettings,
    output_basename: Optional[str | Path],
    show_interactive: bool,
    title_source: str | Path,
) -> None:
    """Figure + save only (host matplotlib); results come from analyse_*.

    Template path mirrors plot_decay_figure exactly — the byte-identity
    guard is tests/test_figure_templates.py. A tap whose set of found fits
    differs changes the line-count key and rebuilds fresh."""
    title = f"Decay (EDC) — {title_source}"
    output_path = None if output_basename is None else suffixed_png(output_basename, "_decay")
    if output_path is None or show_interactive:
        figure = plot_decay_figure(results, analysis_settings, plot_settings, title=title)
        finalize_and_show_or_save(figure, output_path, show_interactive)
        return

    lines = _decay_plot_lines(results, plot_settings)

    def build_extras(axis):
        _decay_axhlines(axis, analysis_settings)

    def setup(axis):
        label_time_axis_seconds(axis)
        label_decibel_axis(axis)
        axis.set_ylim(*plot_settings.ylim_db)
        axis.grid(True, which="both", linestyle=":", linewidth=0.5)

    render_line_figure(
        "decay",
        (analysis_settings, plot_settings, tuple(r.channel_name for r in results)),
        title,
        lines,
        output_path,
        show_interactive,
        legend_kwargs={"loc": "best"},
        setup=setup,
        build_extras=build_extras,
    )


def plot_decay_from_wav_file(
    input_wav_file_path: str | Path,
    analysis_settings: Optional[DecayAnalysisSettings] = None,
    plot_settings: Optional[DecayPlotSettings] = None,
    output_basename: Optional[str | Path] = None,
    show_interactive: bool = True,
    dsp: Optional[FileDsp] = None,
) -> List[ChannelDecayAnalysis]:
    """Analyse then plot; writes <basename>_decay.png when saving."""
    if analysis_settings is None:
        analysis_settings = DecayAnalysisSettings()
    if plot_settings is None:
        plot_settings = DecayPlotSettings()

    results = analyse_decay_from_wav_file(input_wav_file_path, analysis_settings, dsp=dsp)
    render_decay_plots(
        results, analysis_settings, plot_settings, output_basename, show_interactive,
        input_wav_file_path,
    )
    return results


# ----------------------------------------------------------------------------
# summary
# ----------------------------------------------------------------------------


def summarise_decay_results_text(channel_analyses: List[ChannelDecayAnalysis]) -> str:
    """Deterministic, diff-stable summary (same format as decay.py:502-542)."""
    lines: List[str] = []
    for result in channel_analyses:
        lines.append(
            f"[{result.channel_name}] analysis_start_sample_index={result.analysis_start_sample_index}"
        )
        if result.early_decay_10db_time_seconds is None:
            lines.append("  early_0_to_-10_time=NA")
        else:
            lines.append(f"  early_0_to_-10_time={result.early_decay_10db_time_seconds:.4f}s")

        if not result.fits:
            lines.append("  fits=NA")
            lines.append("")
            continue

        for fit_name in ("EDT", "T20", "T30"):
            fit = result.fits.get(fit_name)
            if fit is None:
                lines.append(f"  {fit_name}: NA")
                continue
            lines.append(
                "  "
                f"{fit.name}: "
                f"range=[{fit.range_db[0]:.1f},{fit.range_db[1]:.1f}]dB "
                f"time=[{fit.start_time_seconds:.4f},{fit.end_time_seconds:.4f}]s "
                f"slope={fit.slope_db_per_second:.6f}dB/s "
                f"r2={fit.r_squared:.6f} "
                f"rt60={fit.rt60_seconds:.4f}s"
            )
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"
