"""
CLI for offline analysis — drop-in compatible with the reference's
`python -m analyse.cli` surface (analyse/cli.py:110-1186): the same 13
subcommands (ir, zplane, groupdelay, bundle, deconvolve, decay, rt60bands,
fr, filter, spectrogram, diffusion, waterfall, modalcloud, report), flags,
defaults, and deterministic stdout summaries.

Each subcommand imports its analyses module when it runs: the plotting
modules need matplotlib, the engine paths (`bundle --no-plots`, `batch
--no-plots`, `watch`, `compare`) do not.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

BoolOpt = argparse.BooleanOptionalAction


def _add_input(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--input",
        dest="input_wav_file_path",
        type=str,
        required=True,
        help="Path to input WAV file (mono or stereo, 48 kHz expected).",
    )


def _add_output_noshow(p: argparse.ArgumentParser, help_text: str, underscore: bool) -> None:
    p.add_argument("--output", dest="output_basename", type=str, default=None, help=help_text)
    flag = "--no_show" if underscore else "--no-show"
    p.add_argument(flag, dest="no_show", action="store_true",
                   help="Do not display plots interactively (useful when saving files).")
    p.add_argument("--json", dest="json_path", type=str, default=None,
                   help="Also write the result pytree as JSON to this path.")


def _add_engine_config_flags(p: argparse.ArgumentParser) -> None:
    """Tri-state engine kernel knobs shared by the engine fast paths
    (bundle --no-plots / --multi-host, watch): absent = EngineConfig
    default; --flag / --no-flag force it. Each is the documented escape
    hatch for a measured-default flip (EngineConfig docstrings)."""
    p.add_argument("--bands-decimate", dest="bands_decimate", action=BoolOpt,
                   default=None,
                   help="Run band EDC/fits on spectrum-crop decimated planes where the "
                        "band's oversampling margin allows (exact band samples; see "
                        "EngineConfig.bands_decimate). --no-bands-decimate restores "
                        "full-rate planes for every band.")
    p.add_argument("--modal-trim-bins", dest="modal_trim_bins", action=BoolOpt,
                   default=None,
                   help="Trim the modal STFT at the last log-bin-weighted rfft bin "
                        "(EngineConfig.modal_trim_bins). --no-modal-trim-bins restores "
                        "round-2 bit-compatible modal output.")
    p.add_argument("--prefetch-chunks", dest="prefetch_chunks", type=int, default=None,
                   help="Audio chunks decoded + uploaded ahead of the one the engine "
                        "is consuming (EngineBundleSettings.prefetch_chunks, default 2; "
                        "1 = fully serialized pipeline).")


def _engine_config_overrides(args: argparse.Namespace) -> dict:
    """kwargs for dataclasses.replace(EngineConfig(), ...) from the tri-state
    flags added by _add_engine_config_flags (None = keep the default)."""
    overrides = {}
    for name in ("bands_decimate", "modal_trim_bins"):
        value = getattr(args, name, None)
        if value is not None:
            overrides[name] = bool(value)
    return overrides


def _bundle_settings_overrides(args: argparse.Namespace) -> dict:
    """kwargs for EngineBundleSettings(...) from the shared engine-path
    flags (None = keep the dataclass default)."""
    overrides = {}
    value = getattr(args, "prefetch_chunks", None)
    if value is not None:
        overrides["prefetch_chunks"] = max(1, int(value))
    return overrides


def _maybe_write_json(args: argparse.Namespace, results) -> None:
    json_path = getattr(args, "json_path", None)
    if json_path:
        from audio_analysis_tpu.utils import write_results_json

        print(f"Wrote JSON: {write_results_json(json_path, results)}")


def build_parser() -> argparse.ArgumentParser:
    top = argparse.ArgumentParser(
        prog="analyse",
        description="Offline analysis tools for reverb outputs (plots, metrics).",
    )
    sub = top.add_subparsers(dest="command_name", required=True,
                             help="Analysis to run. Use: analyse <command> --help")

    # --- ir ---
    p = sub.add_parser("ir", help="Plot waveform (full + early zoom) and log-magnitude tail view.")
    _add_input(p)
    p.add_argument("--early-window", dest="early_window_seconds", type=float, default=0.08)
    p.add_argument("--floor-db", dest="log_magnitude_floor_db", type=float, default=-120.0)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    _add_output_noshow(p, "Save PNGs: <basename>.png, _early.png, _tail.png", underscore=True)

    # --- zplane ---
    p = sub.add_parser("zplane", help="Estimate poles (and optional zeros) from an IR.")
    _add_input(p)
    _add_output_noshow(p, "Output basename -> <basename>_zplane_<CH>.png", underscore=False)
    p.add_argument("--mono", dest="use_mono_downmix_for_stereo", action="store_true")
    p.add_argument("--no-trim", dest="trim_to_peak", action="store_false")
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--ar-order", dest="ar_order", type=int, default=256)
    p.add_argument("--zeros", dest="derive_zeros", action="store_true")
    p.add_argument("--zero-order", dest="zero_order", type=int, default=64)
    p.add_argument("--radius", dest="limit_radius", type=float, default=1.2)
    p.add_argument("--ridge", dest="ridge_lambda", type=float, default=0.0)

    # --- groupdelay ---
    p = sub.add_parser("groupdelay", help="Plot group delay vs frequency from an IR/filter output.")
    _add_input(p)
    _add_output_noshow(p, "Output basename -> <basename>_groupdelay_<CH>.png", underscore=False)
    p.add_argument("--mono", dest="use_mono_downmix_for_stereo", action="store_true")
    p.add_argument("--no-trim", dest="trim_to_peak", action="store_false")
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--fft", dest="fft_size", type=int, default=None)
    p.add_argument("--smooth", dest="smoothing_bins", type=int, default=0)
    p.add_argument("--fmin", dest="f_min_hz", type=float, default=20.0)
    p.add_argument("--fmax", dest="f_max_hz", type=float, default=20000.0)
    p.add_argument("--exact-grid", dest="exact_grid", action="store_true",
                   help="CPU fallback on the reference's exact next-pow2 FFT grid.")

    # --- bundle ---
    p = sub.add_parser("bundle", help="Analyse an IR bundle folder (meta.json + taps/*.wav).")
    p.add_argument("--input", dest="bundle_root", type=str, required=True)
    p.add_argument("--reports-subdir", dest="reports_subdir", type=str, default="reports")
    p.add_argument("--resume", action="store_true",
                   help="Skip taps whose report already exists.")
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true",
                   help="Downmix stereo to mono in every tap report.")
    p.add_argument("--no-plots", dest="no_plots", action="store_true",
                   help="Engine fast path: text/JSON metric reports only, one fused device "
                        "pass for the whole bundle (no PNG rendering).")
    p.add_argument("--bands", dest="band_mode", type=str, default="three",
                   choices=["three", "octave", "third"],
                   help="RT60 band mode for the engine fast path (rt60bands.py band modes).")
    _add_engine_config_flags(p)
    p.add_argument("--plot-processes", dest="plot_processes", type=int, default=0,
                   help="Render figures on a process pool of this many workers "
                        "(multi-core hosts); 0 = single render thread.")
    p.add_argument("--compare", dest="compare_to", type=str, default=None, metavar="PREV",
                   help="With --no-plots: diff this run's headline metrics against a "
                        "previous run's bundle_metrics.json (file, reports dir, or bundle "
                        "root — the CURRENT reports dir works: the previous file is read "
                        "before being overwritten) and append a 'Changes vs previous' "
                        "section to the index.")
    p.add_argument("--compare-threshold", dest="compare_threshold", type=float, default=1.0,
                   metavar="PCT", help="Relative change (%%) above which --compare flags "
                        "a metric (default 1.0).")
    p.add_argument("--fail-on-change", dest="fail_on_change", action="store_true",
                   help="With --compare: exit 3 when any change is flagged — a CI "
                        "regression gate for DSP changes.")
    p.add_argument("--tap-shard", dest="tap_shard", type=str, default=None,
                   metavar="I/N",
                   help="Render only taps with index %% N == I (0-based) — fan the "
                        "plot bundle over N independent processes/machines sharing "
                        "the filesystem, then merge the index with one --resume run.")
    p.add_argument("--multi-host", dest="multi_host", action="store_true",
                   help="Multi-host engine fast path (text reports): every process "
                        "analyses the taps its devices own over a shared filesystem; "
                        "process 0 writes the index. Run one process per host; each "
                        "owns all of its host's cards.")
    p.add_argument("--coordinator", dest="coordinator", type=str, default=None,
                   help="host:port of the jax.distributed coordinator (with "
                        "--multi-host when the environment doesn't auto-initialize).")
    p.add_argument("--num-processes", dest="num_processes", type=int, default=None)
    p.add_argument("--process-id", dest="process_id", type=int, default=None)

    # --- batch (bundle-less: loose WAV files through the bundle tooling) ---
    p = sub.add_parser(
        "batch",
        help="Analyse a set of loose WAV files as one batch: materialises a "
             "bundle view (meta.json + tap symlinks) in --output, then runs "
             "the bundle pipeline over it (fused engine with --no-plots).",
    )
    p.add_argument("--inputs", dest="input_wav_paths", type=str, nargs="+", required=True,
                   help="WAV files to analyse (shell globs expand naturally).")
    p.add_argument("--output", dest="bundle_root", type=str, required=True,
                   help="Directory for the bundle view + reports (created).")
    p.add_argument("--reports-subdir", dest="reports_subdir", type=str, default="reports")
    p.add_argument("--resume", action="store_true",
                   help="Skip files whose PLOT report already exists "
                        "(plot path only; the fused --no-plots engine "
                        "re-analyses the whole batch in one pass).")
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--no-plots", dest="no_plots", action="store_true",
                   help="Engine fast path: text/JSON metric reports only, one "
                        "fused device pass for the whole file set.")
    p.add_argument("--bands", dest="band_mode", type=str, default="three",
                   choices=["three", "octave", "third"])
    _add_engine_config_flags(p)
    p.add_argument("--plot-processes", dest="plot_processes", type=int, default=0)
    p.add_argument("--compare", dest="compare_to", type=str, default=None, metavar="PREV")
    p.add_argument("--compare-threshold", dest="compare_threshold", type=float,
                   default=1.0, metavar="PCT")
    p.add_argument("--fail-on-change", dest="fail_on_change", action="store_true")

    # --- watch ---
    p = sub.add_parser(
        "watch",
        help="Watch a recorder output dir: analyse each new complete bundle "
             "(engine fast path) and diff it against the previous run.",
    )
    p.add_argument("--input", dest="watch_root", type=str, required=True,
                   help="Directory the recorder writes timestamped bundles into "
                        "(or a single bundle dir, re-analysed when re-recorded).")
    p.add_argument("--interval", dest="poll_seconds", type=float, default=2.0,
                   help="Poll interval in seconds (default 2).")
    p.add_argument("--reports-subdir", dest="reports_subdir", type=str, default="reports")
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--bands", dest="band_mode", type=str, default="three",
                   choices=["three", "octave", "third"])
    _add_engine_config_flags(p)
    p.add_argument("--no-compare", dest="no_compare", action="store_true",
                   help="Skip the automatic diff against the previously analysed bundle.")
    p.add_argument("--compare-threshold", dest="compare_threshold", type=float, default=1.0,
                   metavar="PCT")
    p.add_argument("--max-bundles", dest="max_bundles", type=int, default=None,
                   help="Exit after analysing this many bundles (default: run forever).")
    p.add_argument("--plots", dest="watch_plots", action="store_true",
                   help="Also render the full plot report per bundle (into "
                        "<reports-subdir>_plots; host-bound, ~seconds per tap).")
    p.add_argument("--plot-processes", dest="plot_processes", type=int, default=0)

    # --- compare ---
    p = sub.add_parser(
        "compare",
        help="Diff two existing engine runs' headline metrics "
             "(bundle_metrics.json files, reports dirs, or bundle roots).",
    )
    p.add_argument("previous", type=str, help="Older run (the baseline).")
    p.add_argument("current", type=str, help="Newer run.")
    p.add_argument("--threshold", "--compare-threshold", dest="compare_threshold",
                   type=float, default=1.0, metavar="PCT",
                   help="Relative change (%%) to flag (default 1.0; "
                        "--compare-threshold accepted for bundle-flag parity).")
    p.add_argument("--fail-on-change", dest="fail_on_change", action="store_true",
                   help="Exit 3 when any change is flagged.")

    # --- deconvolve ---
    p = sub.add_parser("deconvolve", help="Deconvolve recorded sweep output into an IR WAV.")
    p.add_argument("--recorded_wav_file_path", type=str, required=True)
    p.add_argument("--sweep_wav_file_path", type=str, required=True)
    p.add_argument("--output_ir_wav_file_path", type=str, default=None)
    p.add_argument("--regularization_relative", type=float, default=1e-10)
    p.add_argument("--normalise_peak", action=BoolOpt, default=True)
    p.add_argument("--target_peak", type=float, default=0.95)
    p.add_argument("--remove_dc", action=BoolOpt, default=True)
    p.add_argument("--output_length_mode", type=str, choices=["recorded", "full_fft"],
                   default="recorded")

    # --- decay ---
    p = sub.add_parser("decay", help="Schroeder EDC + T20/T30/RT60 decay estimation")
    _add_input(p)
    _add_output_noshow(p, "If provided, saves a PNG: <basename>_decay.png", underscore=True)
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--edc_floor_db", type=float, default=-120.0)
    p.add_argument("--fit_lower_limit_db", type=float, default=-80.0)
    p.add_argument("--smoothing", dest="edc_smoothing_window_samples", type=int, default=0)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true", default=False)
    p.add_argument("--compute_edt", action=BoolOpt, default=True)

    # --- rt60bands ---
    p = sub.add_parser("rt60bands",
                       help="Band-limited RT60: Low/Mid/High T30 (optional T20/EDT).")
    _add_input(p)
    _add_output_noshow(p, "If provided, saves one PNG: <basename>_rt60bands.png", underscore=True)
    p.add_argument("--band_mode", type=str, default="three", choices=["three", "octave", "third"])
    p.add_argument("--f_min_hz", type=float, default=31.5)
    p.add_argument("--f_max_hz", type=float, default=16000.0)
    p.add_argument("--legend_values", action=BoolOpt, default=None)
    p.add_argument("--low_upper_hz", type=float, default=250.0)
    p.add_argument("--mid_center_hz", type=float, default=1000.0)
    p.add_argument("--mid_width_octaves", type=float, default=2.0)
    p.add_argument("--high_lower_hz", type=float, default=4000.0)
    p.add_argument("--transition_width_octaves", type=float, default=1.0 / 6.0)
    p.add_argument("--include_t20", action="store_true")
    p.add_argument("--include_edt", action="store_true")
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action="store_true", default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--edc_floor_db", type=float, default=-120.0)
    p.add_argument("--fit_lower_limit_db", type=float, default=-80.0)
    p.add_argument("--smoothing", dest="edc_smoothing_window_samples", type=int, default=0)

    # --- fr ---
    p = sub.add_parser("fr", help="Plot magnitude spectrum (dB) vs frequency (log-x).")
    _add_input(p)
    _add_output_noshow(p, "If provided, saves a PNG: <basename>_fr.png", underscore=True)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--magnitude_floor_db", type=float, default=-120.0)
    p.add_argument("--f_min_hz", type=float, default=20.0)
    p.add_argument("--f_max_hz", type=float, default=20000.0)
    p.add_argument("--smoothing_log_bins", type=int, default=0)
    p.add_argument("--log_bins_per_octave", type=int, default=96)
    p.add_argument("--no_hann_window", action="store_true")
    p.add_argument("--exact-grid", dest="exact_grid", action="store_true",
                   help="CPU fallback on the reference's exact segment-length FFT grid.")

    # --- filter ---
    p = sub.add_parser("filter", help="Plot filter frequency response: magnitude (dB) and phase.")
    _add_input(p)
    _add_output_noshow(p, "If provided, saves a PNG: <basename>_filter.png", underscore=True)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--magnitude_floor_db", type=float, default=-120.0)
    p.add_argument("--f_min_hz", type=float, default=20.0)
    p.add_argument("--f_max_hz", type=float, default=20000.0)
    p.add_argument("--phase_mode", type=str, choices=["degrees", "radians"], default="degrees")
    p.add_argument("--no_unwrap_phase", action="store_true")
    p.add_argument("--no_hann_window", action="store_true")
    p.add_argument("--exact-grid", dest="exact_grid", action="store_true",
                   help="CPU fallback on the reference's exact segment-length FFT grid.")

    # --- spectrogram ---
    p = sub.add_parser("spectrogram", help="Plot time-frequency magnitude spectrogram.")
    _add_input(p)
    _add_output_noshow(p, "Saves PNG(s): <basename>_spectrogram_<CH>.png", underscore=True)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--n_fft", type=int, default=4096)
    p.add_argument("--hop_length", type=int, default=512)
    p.add_argument("--no_hann_window", action="store_true")
    p.add_argument("--floor_db", type=float, default=-120.0)
    p.add_argument("--f_min_hz", type=float, default=20.0)
    p.add_argument("--f_max_hz", type=float, default=20000.0)
    p.add_argument("--dynamic_range_db", type=float, default=90.0,
                   help="Color scale range below max (default: 90). 0 -> percentiles.")
    p.add_argument("--renderer", type=str, choices=["image", "quadmesh"], default="image",
                   help="'image' (fast log-f raster, default) or 'quadmesh' "
                        "(the reference's exact per-bin mesh).")

    # --- diffusion ---
    p = sub.add_parser("diffusion",
                       help="Diffusion metrics over time: autocorr, echo density, decorrelation.")
    _add_input(p)
    _add_output_noshow(p, "If provided, saves one PNG: <basename>_diffusion.png", underscore=True)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--window_seconds", type=float, default=0.050)
    p.add_argument("--hop_seconds", type=float, default=0.010)
    p.add_argument("--max_lag_milliseconds", type=float, default=10.0)
    p.add_argument("--echo_density_threshold_rms", type=float, default=1.0)
    p.add_argument("--echo_density_normalise_to_gaussian", action=BoolOpt, default=True)

    # --- waterfall ---
    p = sub.add_parser("waterfall", help="Waterfall (CSD-style) plot: spectral slices over time.")
    _add_input(p)
    _add_output_noshow(p, "Saves PNG(s): <basename>_waterfall_<CH>.png", underscore=True)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--n_fft", type=int, default=4096)
    p.add_argument("--hop_length", type=int, default=512)
    p.add_argument("--no_hann_window", action="store_true")
    p.add_argument("--f_min_hz", type=float, default=20.0)
    p.add_argument("--f_max_hz", type=float, default=20000.0)
    p.add_argument("--style", type=str, choices=["3d", "2d"], default="3d")
    p.add_argument("--slice_mode", type=str, choices=["auto", "uniform_time", "uniform_frames"],
                   default="auto")
    p.add_argument("--num_slices", type=int, default=18)
    p.add_argument("--slice_spacing_seconds", type=float, default=0.05)
    p.add_argument("--start_time_seconds", type=float, default=0.0)
    p.add_argument("--end_time_seconds", type=float, default=None)
    p.add_argument("--db_reference", type=str, choices=["global_max", "slice_max"],
                   default="global_max")
    p.add_argument("--dynamic_range_db", type=float, default=80.0)
    p.add_argument("--floor_db", type=float, default=-120.0)
    p.add_argument("--smoothing_log_bins", type=int, default=0)
    p.add_argument("--log_bins_per_octave", type=int, default=96)
    p.add_argument("--elev_deg", type=float, default=30.0)
    p.add_argument("--azim_deg", type=float, default=-60.0)
    p.add_argument("--ridge_offset_db", type=float, default=6.0)

    # --- modalcloud ---
    p = sub.add_parser("modalcloud",
                       help="Modal cloud: frequency vs RT60 points from per-bin STFT decay fits.")
    _add_input(p)
    _add_output_noshow(p, "Saves PNG(s): <basename>_modalcloud_<CH>.png", underscore=True)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--n_fft", type=int, default=8192)
    p.add_argument("--hop_length", type=int, default=512)
    p.add_argument("--no_hann_window", action="store_true")
    p.add_argument("--f_min_hz", type=float, default=20.0)
    p.add_argument("--f_max_hz", type=float, default=20000.0)
    p.add_argument("--metric", type=str, choices=["t30", "t20", "edt"], default="t30")
    p.add_argument("--log_bins_per_octave", type=int, default=24)
    p.add_argument("--min_bins", type=int, default=24)
    p.add_argument("--fit_lower_limit_db", type=float, default=-80.0)
    p.add_argument("--min_fit_points", type=int, default=10)
    p.add_argument("--min_peak_db_above_floor", type=float, default=20.0)
    p.add_argument("--floor_db", type=float, default=-120.0)
    p.add_argument("--show_median_curve", action=BoolOpt, default=True)
    p.add_argument("--median_octave_window", type=float, default=0.25)
    p.add_argument("--ylim_seconds_min", type=float, default=None)
    p.add_argument("--ylim_seconds_max", type=float, default=None)

    # --- report ---
    p = sub.add_parser("report", help="Run a standard analysis suite; write plots + summary.")
    _add_input(p)
    p.add_argument("--output", dest="output_basename", type=str, required=True,
                   help="Output basename/prefix (folder + base name).")
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--ir", dest="run_ir", action=BoolOpt, default=True)
    p.add_argument("--decay", dest="run_decay", action=BoolOpt, default=True)
    p.add_argument("--rt60bands", dest="run_rt60bands", action=BoolOpt, default=True)
    p.add_argument("--fr", dest="run_fr", action=BoolOpt, default=True)
    p.add_argument("--gd", dest="run_gd", action=BoolOpt, default=True)
    p.add_argument("--spectrogram", dest="run_spectrogram", action=BoolOpt, default=True)
    p.add_argument("--waterfall", dest="run_waterfall", action=BoolOpt, default=True)
    p.add_argument("--diffusion", dest="run_diffusion", action=BoolOpt, default=True)
    p.add_argument("--modalcloud", dest="run_modalcloud", action=BoolOpt, default=True)
    p.add_argument("--echodensity", dest="run_echodensity", action=BoolOpt, default=True)
    p.add_argument("--timing", dest="include_timing", action="store_true",
                   help="Append a per-block wall-clock table to the report.")
    p.add_argument("--profile-dir", dest="profile_dir", type=str, default=None,
                   help="Write a jax.profiler trace of the device work to this directory.")

    return top


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cmd = str(args.command_name)

    def out_base() -> Optional[str]:
        ob = getattr(args, "output_basename", None)
        return None if ob is None else str(Path(ob))

    def show() -> bool:
        return not bool(getattr(args, "no_show", False))

    if cmd == "ir":
        from audio_analysis_tpu.analyses.impulse_response import (
            ImpulseResponseViewSettings,
            plot_ir_from_wav_file,
        )

        results = plot_ir_from_wav_file(
            wav_file_path=str(args.input_wav_file_path),
            settings=ImpulseResponseViewSettings(
                early_window_seconds=float(args.early_window_seconds),
                log_magnitude_floor_db=float(args.log_magnitude_floor_db),
                use_mono_downmix=bool(args.use_mono_downmix),
            ),
            output_basename=out_base(),
            show_interactive=show(),
        )
        _maybe_write_json(args, results)
        return

    if cmd == "deconvolve":
        from audio_analysis_tpu.analyses.deconvolve import (
            DeconvolveSettings,
            deconvolve_from_wav_files,
            default_output_ir_path,
        )

        output_path = args.output_ir_wav_file_path
        if output_path is None:
            output_path = str(default_output_ir_path(args.recorded_wav_file_path))
        result = deconvolve_from_wav_files(
            recorded_wav_file_path=str(args.recorded_wav_file_path),
            sweep_wav_file_path=str(args.sweep_wav_file_path),
            settings=DeconvolveSettings(
                regularization_relative=float(args.regularization_relative),
                normalise_peak=bool(args.normalise_peak),
                target_peak=float(args.target_peak),
                remove_dc=bool(args.remove_dc),
                output_length_mode=str(args.output_length_mode),
            ),
            output_ir_wav_file_path=output_path,
        )
        print(f"Wrote IR WAV: {output_path}")
        print(f"  sample_rate_hz={result.sample_rate_hz}")
        print(f"  channels={result.samples.shape[1]}")
        print(f"  length_seconds={result.samples.shape[0] / float(result.sample_rate_hz):.3f}")
        return

    if cmd == "decay":
        from audio_analysis_tpu.analyses.decay import (
            DecayAnalysisSettings,
            DecayPlotSettings,
            plot_decay_from_wav_file,
            summarise_decay_results_text,
        )

        results = plot_decay_from_wav_file(
            input_wav_file_path=str(args.input_wav_file_path),
            analysis_settings=DecayAnalysisSettings(
                trim_to_peak=bool(args.trim_to_peak),
                ignore_leading_seconds=float(args.ignore_leading_seconds),
                edc_floor_db=float(args.edc_floor_db),
                fit_lower_limit_db=float(args.fit_lower_limit_db),
                edc_smoothing_window_samples=int(args.edc_smoothing_window_samples),
                use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                compute_edt=bool(args.compute_edt),
            ),
            plot_settings=DecayPlotSettings(),
            output_basename=out_base(),
            show_interactive=show(),
        )
        _maybe_write_json(args, results)
        print(summarise_decay_results_text(results))
        return

    if cmd == "rt60bands":
        from audio_analysis_tpu.analyses.decay import DecayAnalysisSettings
        from audio_analysis_tpu.analyses.rt60bands import (
            Rt60BandsAnalysisSettings,
            Rt60BandsPlotSettings,
            plot_rt60_bands_from_wav_file,
            summarise_rt60_bands_results_text,
        )

        decay_settings = DecayAnalysisSettings(
            trim_to_peak=bool(args.trim_to_peak),
            ignore_leading_seconds=float(args.ignore_leading_seconds),
            edc_floor_db=float(args.edc_floor_db),
            fit_lower_limit_db=float(args.fit_lower_limit_db),
            edc_smoothing_window_samples=int(args.edc_smoothing_window_samples),
            use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
            compute_edt=bool(args.include_edt),
        )
        rt_settings = Rt60BandsAnalysisSettings(
            band_mode=str(args.band_mode),
            low_upper_hz=float(args.low_upper_hz),
            mid_center_hz=float(args.mid_center_hz),
            mid_width_octaves=float(args.mid_width_octaves),
            high_lower_hz=float(args.high_lower_hz),
            f_min_hz=float(args.f_min_hz),
            f_max_hz=float(args.f_max_hz),
            transition_width_octaves=float(args.transition_width_octaves),
            include_t20=bool(args.include_t20),
            include_edt=bool(args.include_edt),
            decay_settings=decay_settings,
        )
        legend_values = (
            str(args.band_mode) == "three" if args.legend_values is None else bool(args.legend_values)
        )
        results = plot_rt60_bands_from_wav_file(
            input_wav_file_path=str(args.input_wav_file_path),
            settings=rt_settings,
            plot_settings=Rt60BandsPlotSettings(legend_values=legend_values),
            output_basename=out_base(),
            show_interactive=show(),
        )
        _maybe_write_json(args, results)
        print(
            summarise_rt60_bands_results_text(
                results, include_t20=rt_settings.include_t20, include_edt=rt_settings.include_edt
            )
        )
        return

    if cmd == "fr":
        from audio_analysis_tpu.analyses.frequency_response import (
            FrequencyResponseAnalysisSettings,
            FrequencyResponsePlotSettings,
            plot_frequency_response_from_wav_file,
            summarise_frequency_response_results_text,
        )

        results = plot_frequency_response_from_wav_file(
            input_wav_file_path=str(args.input_wav_file_path),
            analysis_settings=FrequencyResponseAnalysisSettings(
                use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                trim_to_peak=bool(args.trim_to_peak),
                ignore_leading_seconds=float(args.ignore_leading_seconds),
                analysis_duration_seconds=args.analysis_duration_seconds,
                use_hann_window=not bool(args.no_hann_window),
                magnitude_floor_db=float(args.magnitude_floor_db),
                f_min_hz=float(args.f_min_hz),
                f_max_hz=float(args.f_max_hz),
                smoothing_log_bins=int(args.smoothing_log_bins),
                log_bins_per_octave=int(args.log_bins_per_octave),
                exact_grid=bool(getattr(args, "exact_grid", False)),
            ),
            plot_settings=FrequencyResponsePlotSettings(),
            output_basename=out_base(),
            show_interactive=show(),
        )
        _maybe_write_json(args, results)
        print(summarise_frequency_response_results_text(results))
        return

    if cmd == "filter":
        from audio_analysis_tpu.analyses.filterplot import (
            FilterAnalysisSettings,
            FilterPlotSettings,
            plot_filter_response_from_wav_file,
            summarise_filter_response_results_text,
        )

        results = plot_filter_response_from_wav_file(
            input_wav_file_path=str(args.input_wav_file_path),
            analysis_settings=FilterAnalysisSettings(
                use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                trim_to_peak=bool(args.trim_to_peak),
                ignore_leading_seconds=float(args.ignore_leading_seconds),
                analysis_duration_seconds=args.analysis_duration_seconds,
                use_hann_window=not bool(args.no_hann_window),
                magnitude_floor_db=float(args.magnitude_floor_db),
                f_min_hz=float(args.f_min_hz),
                f_max_hz=float(args.f_max_hz),
                phase_mode=str(args.phase_mode),
                unwrap_phase=not bool(args.no_unwrap_phase),
                exact_grid=bool(getattr(args, "exact_grid", False)),
            ),
            plot_settings=FilterPlotSettings(),
            output_basename=out_base(),
            show_interactive=show(),
        )
        _maybe_write_json(args, results)
        print(summarise_filter_response_results_text(results))
        return

    if cmd == "spectrogram":
        from audio_analysis_tpu.analyses.spectrogram import (
            SpectrogramAnalysisSettings,
            SpectrogramPlotSettings,
            plot_spectrogram_from_wav_file,
            summarise_spectrogram_results_text,
        )

        dyn = float(args.dynamic_range_db)
        results = plot_spectrogram_from_wav_file(
            input_wav_file_path=str(args.input_wav_file_path),
            analysis_settings=SpectrogramAnalysisSettings(
                use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                trim_to_peak=bool(args.trim_to_peak),
                ignore_leading_seconds=float(args.ignore_leading_seconds),
                analysis_duration_seconds=args.analysis_duration_seconds,
                n_fft=int(args.n_fft),
                hop_length=int(args.hop_length),
                use_hann_window=not bool(args.no_hann_window),
                floor_db=float(args.floor_db),
                f_min_hz=float(args.f_min_hz),
                f_max_hz=float(args.f_max_hz),
                dynamic_range_db=None if dyn <= 0.0 else dyn,
            ),
            plot_settings=SpectrogramPlotSettings(renderer=str(args.renderer)),
            output_basename=out_base(),
            show_interactive=show(),
        )
        _maybe_write_json(args, results)
        print(summarise_spectrogram_results_text(results))
        return

    if cmd == "diffusion":
        from audio_analysis_tpu.analyses.diffusion import (
            DiffusionAnalysisSettings,
            plot_diffusion_from_wav_file,
            summarise_diffusion_results_text,
        )

        results = plot_diffusion_from_wav_file(
            input_wav_file_path=str(args.input_wav_file_path),
            analysis_settings=DiffusionAnalysisSettings(
                use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                trim_to_peak=bool(args.trim_to_peak),
                ignore_leading_seconds=float(args.ignore_leading_seconds),
                window_seconds=float(args.window_seconds),
                hop_seconds=float(args.hop_seconds),
                max_lag_milliseconds=float(args.max_lag_milliseconds),
                echo_density_threshold_rms=float(args.echo_density_threshold_rms),
                echo_density_normalise_to_gaussian=bool(args.echo_density_normalise_to_gaussian),
            ),
            output_basename=out_base(),
            show_interactive=show(),
        )
        _maybe_write_json(args, results)
        print(summarise_diffusion_results_text(results))
        return

    if cmd == "waterfall":
        from audio_analysis_tpu.analyses.waterfall import (
            WaterfallAnalysisSettings,
            WaterfallPlotSettings,
            plot_waterfall_from_wav_file,
            summarise_waterfall_results_text,
        )

        results = plot_waterfall_from_wav_file(
            input_wav_file_path=str(args.input_wav_file_path),
            analysis_settings=WaterfallAnalysisSettings(
                use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                trim_to_peak=bool(args.trim_to_peak),
                ignore_leading_seconds=float(args.ignore_leading_seconds),
                analysis_duration_seconds=args.analysis_duration_seconds,
                n_fft=int(args.n_fft),
                hop_length=int(args.hop_length),
                use_hann_window=not bool(args.no_hann_window),
                f_min_hz=float(args.f_min_hz),
                f_max_hz=float(args.f_max_hz),
                slice_mode=str(args.slice_mode),
                num_slices=int(args.num_slices),
                slice_spacing_seconds=float(args.slice_spacing_seconds),
                start_time_seconds=float(args.start_time_seconds),
                end_time_seconds=args.end_time_seconds,
                db_reference=str(args.db_reference),
                smoothing_log_bins=int(args.smoothing_log_bins),
                log_bins_per_octave=int(args.log_bins_per_octave),
                dynamic_range_db=float(args.dynamic_range_db),
                floor_db=float(args.floor_db),
            ),
            plot_settings=WaterfallPlotSettings(
                style=str(args.style),
                elev_deg=float(args.elev_deg),
                azim_deg=float(args.azim_deg),
                ridge_offset_db=float(args.ridge_offset_db),
            ),
            output_basename=out_base(),
            show_interactive=show(),
        )
        _maybe_write_json(args, results)
        print(summarise_waterfall_results_text(results))
        return

    if cmd == "modalcloud":
        from audio_analysis_tpu.analyses.modalcloud import (
            ModalCloudAnalysisSettings,
            ModalCloudPlotSettings,
            plot_modal_cloud_from_wav_file,
            summarise_modal_cloud_results_text,
        )

        ylim = None
        if args.ylim_seconds_min is not None and args.ylim_seconds_max is not None:
            ylim = (float(args.ylim_seconds_min), float(args.ylim_seconds_max))
        results = plot_modal_cloud_from_wav_file(
            input_wav_file_path=str(args.input_wav_file_path),
            analysis_settings=ModalCloudAnalysisSettings(
                use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                trim_to_peak=bool(args.trim_to_peak),
                ignore_leading_seconds=float(args.ignore_leading_seconds),
                analysis_duration_seconds=args.analysis_duration_seconds,
                n_fft=int(args.n_fft),
                hop_length=int(args.hop_length),
                use_hann_window=not bool(args.no_hann_window),
                f_min_hz=float(args.f_min_hz),
                f_max_hz=float(args.f_max_hz),
                log_bins_per_octave=int(args.log_bins_per_octave),
                min_bins=int(args.min_bins),
                metric=str(args.metric),
                fit_lower_limit_db=float(args.fit_lower_limit_db),
                min_fit_points=int(args.min_fit_points),
                min_peak_db_above_floor=float(args.min_peak_db_above_floor),
                floor_db=float(args.floor_db),
            ),
            plot_settings=ModalCloudPlotSettings(
                show_median_curve=bool(args.show_median_curve),
                median_octave_window=float(args.median_octave_window),
                ylim_seconds=ylim,
            ),
            output_basename=out_base(),
            show_interactive=show(),
        )
        _maybe_write_json(args, results)
        print(summarise_modal_cloud_results_text(results))
        return

    if cmd == "zplane":
        from audio_analysis_tpu.analyses.zplane import (
            ZPlaneAnalysisSettings,
            ZPlanePlotSettings,
            plot_zplane_from_wav_file,
            summarise_zplane_results_text,
        )

        results = plot_zplane_from_wav_file(
            input_wav_file_path=str(args.input_wav_file_path),
            settings=ZPlaneAnalysisSettings(
                use_mono_downmix_for_stereo=bool(args.use_mono_downmix_for_stereo),
                trim_to_peak=bool(args.trim_to_peak),
                ignore_leading_seconds=float(args.ignore_leading_seconds),
                analysis_duration_seconds=args.analysis_duration_seconds,
                ar_order=int(args.ar_order),
                derive_zeros=bool(args.derive_zeros),
                zero_order=int(args.zero_order),
                ridge_lambda=float(args.ridge_lambda),
            ),
            plot_settings=ZPlanePlotSettings(limit_radius=float(args.limit_radius)),
            output_basename=out_base(),
            show_interactive=show(),
        )
        _maybe_write_json(args, results)
        print(summarise_zplane_results_text(results))
        return

    if cmd == "groupdelay":
        from audio_analysis_tpu.analyses.group_delay import (
            GroupDelayAnalysisSettings,
            GroupDelayPlotSettings,
            plot_group_delay_from_wav_file,
            summarise_group_delay_results_text,
        )

        results = plot_group_delay_from_wav_file(
            input_wav_file_path=str(args.input_wav_file_path),
            settings=GroupDelayAnalysisSettings(
                use_mono_downmix_for_stereo=bool(args.use_mono_downmix_for_stereo),
                trim_to_peak=bool(args.trim_to_peak),
                ignore_leading_seconds=float(args.ignore_leading_seconds),
                analysis_duration_seconds=args.analysis_duration_seconds,
                fft_size=args.fft_size,
                smoothing_bins=int(args.smoothing_bins),
                f_min_hz=float(args.f_min_hz),
                f_max_hz=float(args.f_max_hz),
                exact_grid=bool(getattr(args, "exact_grid", False)),
            ),
            plot_settings=GroupDelayPlotSettings(),
            output_basename=out_base(),
            show_interactive=show(),
        )
        _maybe_write_json(args, results)
        print(summarise_group_delay_results_text(results))
        return

    if cmd == "report":
        from audio_analysis_tpu.report import ReportSettings, run_report_from_wav_file
        from audio_analysis_tpu.utils.timing import profile_trace

        with profile_trace(getattr(args, "profile_dir", None)):
            results = run_report_from_wav_file(
                input_wav_file_path=str(args.input_wav_file_path),
                output_basename=str(Path(args.output_basename)),
                settings=ReportSettings(
                    common_use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                    common_trim_to_peak=bool(args.trim_to_peak),
                    common_ignore_leading_seconds=float(args.ignore_leading_seconds),
                    run_impulse_response_plots=bool(args.run_ir),
                    run_decay=bool(args.run_decay),
                    run_rt60_bands=bool(args.run_rt60bands),
                    run_frequency_response=bool(args.run_fr),
                    run_group_delay=bool(args.run_gd),
                    run_spectrogram=bool(args.run_spectrogram),
                    run_waterfall=bool(args.run_waterfall),
                    run_diffusion=bool(args.run_diffusion),
                    run_modal_cloud=bool(args.run_modalcloud),
                    run_echo_density=bool(args.run_echodensity),
                    include_timing_footer=bool(getattr(args, "include_timing", False)),
                ),
            )
        print(results.summary_markdown)
        print(f"Wrote: {results.summary_markdown_path}")
        return

    if cmd == "compare":
        from audio_analysis_tpu.report.compare import (
            count_flagged_in_text,
            format_bundle_comparison,
            load_bundle_metrics,
        )

        section = format_bundle_comparison(
            load_bundle_metrics(args.current),
            load_bundle_metrics(args.previous),
            threshold_pct=float(args.compare_threshold),
            previous_label=f"`{args.previous}`",
        )
        print(section.strip())
        if count_flagged_in_text(section) and bool(getattr(args, "fail_on_change", False)):
            raise SystemExit(3)
        return

    if cmd == "watch":
        from dataclasses import replace as _replace

        from audio_analysis_tpu.engine import EngineConfig
        from audio_analysis_tpu.report import EngineBundleSettings, WatchSettings, watch_bundle_runs

        watch_settings = WatchSettings(
            poll_seconds=float(args.poll_seconds),
            engine=EngineBundleSettings(
                reports_subdir=str(args.reports_subdir),
                use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                config=_replace(EngineConfig(), band_mode=str(args.band_mode),
                                **_engine_config_overrides(args)),
                **_bundle_settings_overrides(args),
            ),
            compare_to_previous=not bool(args.no_compare),
            compare_threshold_pct=float(args.compare_threshold),
            max_bundles=args.max_bundles,
            plots=bool(getattr(args, "watch_plots", False)),
            plot_processes=int(getattr(args, "plot_processes", 0)),
        )
        try:
            watch_bundle_runs(str(args.watch_root), watch_settings)
        except KeyboardInterrupt:
            print("\nwatch stopped")
        return

    if cmd in ("batch", "bundle"):
        # argument validation runs BEFORE any side effect: `batch`
        # materialises its bundle view into --output (overwriting a stale
        # meta.json there), which must not happen for a rejected command
        if getattr(args, "tap_shard", None) and (
            bool(getattr(args, "no_plots", False)) or bool(getattr(args, "multi_host", False))
        ):
            raise SystemExit(
                "--tap-shard shards the PLOT bundle; it cannot combine with "
                "--no-plots or --multi-host (the engine paths batch taps themselves)"
            )
        if getattr(args, "compare_to", None) and not (
            bool(getattr(args, "no_plots", False))
            or bool(getattr(args, "multi_host", False))
        ):
            # silently dropping --compare on an unwired path would make the
            # --fail-on-change CI gate pass vacuously
            raise SystemExit(
                "--compare diffs engine metrics: it requires --no-plots or "
                "--multi-host (the metrics source is the engine's "
                "bundle_metrics.json)"
            )
        if bool(getattr(args, "resume", False)) and bool(getattr(args, "no_plots", False)):
            # the engine fast path has no per-file skip (it re-analyses the
            # whole batch in one fused pass — seconds); pretending to honor
            # --resume there would be a silent lie
            raise SystemExit(
                "--resume skips taps with complete PLOT reports; it cannot "
                "combine with --no-plots (the fused engine always re-analyses "
                "the whole batch - it is the fast path already)"
            )

    if cmd == "batch":
        # loose WAVs -> bundle view in --output, then the ordinary bundle
        # pipeline (engine fast path, plots, --compare, --resume) runs on it
        from audio_analysis_tpu.io.bundle import materialize_bundle_view

        try:
            root = materialize_bundle_view(args.input_wav_paths, args.bundle_root)
        except ValueError as exc:  # bad inputs / refusing a real bundle
            raise SystemExit(str(exc)) from None
        print(f"Materialised bundle view: {root} ({len(args.input_wav_paths)} files)")
        cmd = "bundle"

    if cmd == "bundle":
        if bool(getattr(args, "multi_host", False)):
            from dataclasses import replace as _replace

            import jax

            from audio_analysis_tpu.engine import EngineConfig
            from audio_analysis_tpu.engine.distributed import run_bundle_report_multi_host

            if getattr(args, "coordinator", None):
                if args.num_processes is None or args.process_id is None:
                    raise SystemExit(
                        "bundle --multi-host --coordinator requires both "
                        "--num-processes and --process-id"
                    )
                try:
                    jax.config.update("jax_cpu_collectives_implementation", "gloo")
                except Exception:
                    pass  # gloo is the default for multi-process CPU on newer jax
                jax.distributed.initialize(
                    coordinator_address=str(args.coordinator),
                    num_processes=int(args.num_processes),
                    process_id=int(args.process_id),
                )

            index = run_bundle_report_multi_host(
                str(args.bundle_root),
                _replace(
                    EngineConfig(),
                    band_mode=str(getattr(args, "band_mode", "three")),
                    downmix_to_mono=bool(args.use_mono_downmix),
                    **_engine_config_overrides(args),
                ),
                reports_subdir=str(args.reports_subdir),
                compare_to=getattr(args, "compare_to", None),
                compare_threshold_pct=float(getattr(args, "compare_threshold", 1.0)),
            )
            if index is not None:
                print(f"Wrote bundle report index: {index}")
                if getattr(args, "compare_to", None) and bool(
                    getattr(args, "fail_on_change", False)
                ):
                    from audio_analysis_tpu.report.compare import index_has_flagged_changes

                    if index_has_flagged_changes(index):
                        print("Changes flagged vs previous run (see the index) — exiting 3.")
                        raise SystemExit(3)
            return

        if bool(getattr(args, "no_plots", False)):
            from dataclasses import replace as _replace

            from audio_analysis_tpu.engine import EngineConfig
            from audio_analysis_tpu.report import EngineBundleSettings, run_bundle_report_engine

            index = run_bundle_report_engine(
                str(args.bundle_root),
                EngineBundleSettings(
                    reports_subdir=str(args.reports_subdir),
                    use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                    compare_to=getattr(args, "compare_to", None),
                    compare_threshold_pct=float(getattr(args, "compare_threshold", 1.0)),
                    config=_replace(
                        EngineConfig(),
                        band_mode=str(getattr(args, "band_mode", "three")),
                        **_engine_config_overrides(args),
                    ),
                    **_bundle_settings_overrides(args),
                ),
            )
            print(f"Wrote bundle report index: {index}")
            if getattr(args, "compare_to", None) and bool(getattr(args, "fail_on_change", False)):
                from audio_analysis_tpu.report.compare import index_has_flagged_changes

                if index_has_flagged_changes(index):
                    print("Changes flagged vs previous run (see the index) — exiting 3.")
                    raise SystemExit(3)
            return

        from audio_analysis_tpu.report import BundleRunSettings, ReportSettings, run_bundle_report

        index = run_bundle_report(
            str(args.bundle_root),
            settings=BundleRunSettings(
                reports_subdir=str(args.reports_subdir),
                resume=bool(args.resume),
                tap_shard=getattr(args, "tap_shard", None),
                report_settings=ReportSettings(
                    common_use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                    plot_processes=int(getattr(args, "plot_processes", 0)),
                ),
            ),
        )
        if getattr(args, "tap_shard", None):
            print(f"Wrote bundle shard summary: {index}")
            print("Merge after all shards finish: analyse.cli bundle --input "
                  f"{args.bundle_root} --resume")
        else:
            print(f"Wrote bundle report index: {index}")
        return

    raise ValueError(f"Unknown command: {cmd}")


if __name__ == "__main__":
    main()
