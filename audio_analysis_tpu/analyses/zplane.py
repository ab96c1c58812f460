"""
Z-plane pole/zero cloud from an AR (all-pole) fit of an IR segment.

Parity with analyse/zplane.py: AR least squares with optional ridge
(zplane.py:83-120), poles from the companion polynomial (zplane.py:145-158),
optional approximate FIR zeros (zplane.py:123-142), RT60-from-pole-radius
annotation ln(1000)*tau (zplane.py:161-173), unit-circle plot per channel
`<basename>_zplane_<CH>.png`, summary format (zplane.py:288-302).

Device/host split: the heavy Gram accumulation over ~10^6 samples runs on
device as chunked full-f32 matmuls (ops.spectral.ar_normal_equations); the tiny (p, p)
solve and the complex nonsymmetric root-finding run on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from audio_analysis_tpu.analyses._common import FileDsp, single_channel_dsp, suffixed_png
from audio_analysis_tpu.ops import spectral
from audio_analysis_tpu.plot import create_figure_and_axis, finalize_and_show_or_save


@dataclass(frozen=True)
class ZPlaneAnalysisSettings:
    use_mono_downmix_for_stereo: bool = False
    trim_to_peak: bool = True
    ignore_leading_seconds: float = 0.0
    analysis_duration_seconds: Optional[float] = None
    model: str = "ar"
    ar_order: int = 256
    derive_zeros: bool = False
    zero_order: int = 64
    normalise_segment: bool = True
    ridge_lambda: float = 0.0


@dataclass(frozen=True)
class ZPlanePlotSettings:
    secondary_channel_alpha: float = 0.7
    show_unit_circle: bool = True
    show_axes: bool = True
    limit_radius: float = 1.2
    annotate_stats: bool = True


@dataclass(frozen=True)
class ChannelZPlaneResult:
    channel_name: str
    sample_rate_hz: int
    poles: np.ndarray  # complex
    zeros: Optional[np.ndarray]  # complex or None


def rt60_from_pole_radius(radius: float, sample_rate_hz: int) -> float:
    """RT60 ~= ln(1000) * tau with tau_samples = -1/ln(r) (zplane.py:161-173)."""
    radius = float(radius)
    if radius <= 0.0 or radius >= 1.0:
        return float("inf")
    tau_seconds = (-1.0 / np.log(radius)) / float(sample_rate_hz)
    return float(np.log(1000.0) * tau_seconds)


def analyse_zplane_channels(
    dsp: FileDsp,
    settings: ZPlaneAnalysisSettings,
) -> List[ChannelZPlaneResult]:
    """
    All channels' Gram accumulations in one batched device dispatch (the
    heavy part); the tiny (p, p) solves and companion-root finding stay on
    host per channel (complex nonsymmetric eig stays on the host — SURVEY
    hard parts).
    """
    import jax.numpy as jnp

    sample_rate_hz = dsp.sample_rate_hz
    aligned = dsp.aligned(
        settings.trim_to_peak,
        settings.ignore_leading_seconds,
        settings.analysis_duration_seconds,
    )
    _, seg_lens = dsp.aligned_host_meta(
        settings.trim_to_peak,
        settings.ignore_leading_seconds,
        settings.analysis_duration_seconds,
    )
    host = np.asarray(aligned.samples)  # (C, N_pad), one fetch for all channels

    order = int(settings.ar_order)
    min_seg = int(seg_lens.min())
    if min_seg <= order:
        order = max(1, min_seg - 1)

    n_pad = dsp.bucket_samples
    segs64 = []
    seg_batch = np.zeros((dsp.num_channels, n_pad), np.float32)
    for i in range(dsp.num_channels):
        seg = host[i][: int(seg_lens[i])].astype(np.float64)
        if settings.normalise_segment and seg.size:
            peak = float(np.max(np.abs(seg)))
            if peak > 0.0:
                seg = seg / peak
        segs64.append(seg)
        seg_batch[i, : seg.size] = seg.astype(np.float32)

    normal = spectral.ar_normal_equations(
        jnp.asarray(seg_batch),
        jnp.asarray(seg_lens.astype(np.int32)),
        order,
    )
    grams = np.asarray(normal.gram)
    moments = np.asarray(normal.moment)

    results = []
    for i, channel_name in enumerate(dsp.channel_names):
        a = spectral.solve_ar_coefficients(grams[i], moments[i], float(settings.ridge_lambda))
        poles = spectral.ar_poles(a)

        zeros: Optional[np.ndarray] = None
        if settings.derive_zeros:
            b = spectral.derive_fir_numerator_from_ar(a, segs64[i], int(settings.zero_order))
            zeros = spectral.ar_poles(b)  # same companion-root helper

        results.append(
            ChannelZPlaneResult(
                channel_name=channel_name,
                sample_rate_hz=int(sample_rate_hz),
                poles=poles,
                zeros=zeros,
            )
        )
    return results


def analyse_zplane_for_channel(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    settings: ZPlaneAnalysisSettings,
) -> ChannelZPlaneResult:
    return analyse_zplane_channels(
        single_channel_dsp(samples, sample_rate_hz, channel_name), settings
    )[0]


def analyse_zplane_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[ZPlaneAnalysisSettings] = None,
    dsp: Optional[FileDsp] = None,
) -> List[ChannelZPlaneResult]:
    if settings is None:
        settings = ZPlaneAnalysisSettings()
    if dsp is None:
        dsp = FileDsp.from_wav_file(input_wav_file_path, settings.use_mono_downmix_for_stereo)
    return analyse_zplane_channels(dsp, settings)


def plot_zplane_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[ZPlaneAnalysisSettings] = None,
    plot_settings: Optional[ZPlanePlotSettings] = None,
    output_basename: Optional[str | Path] = None,
    show_interactive: bool = True,
    dsp: Optional[FileDsp] = None,
) -> List[ChannelZPlaneResult]:
    if settings is None:
        settings = ZPlaneAnalysisSettings()
    if plot_settings is None:
        plot_settings = ZPlanePlotSettings()

    results = analyse_zplane_from_wav_file(input_wav_file_path, settings, dsp=dsp)

    for result in results:
        fig, ax = create_figure_and_axis(
            title=f"Z-plane pole cloud ({result.channel_name})", figure_size=(7.5, 7.5)
        )
        if plot_settings.show_axes:
            ax.axhline(0.0, linewidth=1.0)
            ax.axvline(0.0, linewidth=1.0)
        if plot_settings.show_unit_circle:
            t = np.linspace(0.0, 2.0 * np.pi, 512)
            ax.plot(np.cos(t), np.sin(t), linestyle="--", linewidth=1.0)

        poles = result.poles
        if poles.size:
            ax.scatter(np.real(poles), np.imag(poles), marker="x", s=30, label="Poles")
        if result.zeros is not None and result.zeros.size:
            ax.scatter(
                np.real(result.zeros),
                np.imag(result.zeros),
                marker="o",
                s=18,
                facecolors="none",
                label="Zeros",
            )

        ax.set_aspect("equal", adjustable="box")
        lim = float(plot_settings.limit_radius)
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_xlabel("Re{z}")
        ax.set_ylabel("Im{z}")
        ax.legend(loc="upper right")

        if plot_settings.annotate_stats and poles.size:
            radii = np.abs(poles)
            med_r, max_r = float(np.median(radii)), float(np.max(radii))
            rt60_med = rt60_from_pole_radius(min(med_r, 0.999999), result.sample_rate_hz)
            rt60_max = rt60_from_pole_radius(min(max_r, 0.999999), result.sample_rate_hz)
            ax.text(
                0.02,
                0.02,
                (
                    f"AR order: {int(settings.ar_order)}\n"
                    f"poles: {poles.size}\n"
                    f"unstable (|p|>=1): {int(np.sum(radii >= 1.0))}\n"
                    f"radius median: {med_r:.6f}\n"
                    f"radius max: {max_r:.6f}\n"
                    f"RT60~ (median r): {rt60_med:.3f} s\n"
                    f"RT60~ (max r): {rt60_max:.3f} s"
                ),
                transform=ax.transAxes,
                fontsize=9,
                va="bottom",
                ha="left",
            )

        output_path = (
            None
            if output_basename is None
            else suffixed_png(output_basename, f"_zplane_{result.channel_name}")
        )
        finalize_and_show_or_save(fig, output_path, show_interactive)

    return results


def summarise_zplane_results_text(results: List[ChannelZPlaneResult]) -> str:
    lines: List[str] = []
    for r in results:
        if r.poles.size == 0:
            lines.append(f"- {r.channel_name}: no poles (fit failed or order=0)")
            continue
        radii = np.abs(r.poles)
        lines.append(
            f"- {r.channel_name}: poles={r.poles.size}, "
            f"max|p|={float(np.max(radii)):.6f}, median|p|={float(np.median(radii)):.6f}, "
            f"unstable(|p|>=1)={int(np.sum(radii >= 1.0))}"
        )
    if not lines:
        return "No z-plane results."
    return "Z-plane summary:\n" + "\n".join(lines)
