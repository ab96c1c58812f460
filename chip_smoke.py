#!/usr/bin/env python3
"""
Smoke test of the bundle engine on NVIDIA GPUs, at a deployment's real size.

    python chip_smoke.py               # one card: phases bundle, iso, correctness, report
    python chip_smoke.py --four-cards  # four cards: only the mesh path vs one card

Phases (one card):
  bundle       64 stereo PCM16 taps x 2^20 samples (21.8 s at 48 kHz)
               through `analyse.cli bundle --no-plots`, three times: cold,
               warm with the bundle unchanged, and after one tap's WAV is
               rewritten (the device audio cache re-uploads one chunk).
  iso          8 taps through the third-octave band path.
  correctness  2 taps at full width on the card against float64
               compositions of audio_analysis_tpu.oracle, and against the
               same engine program placed on the host CPU.
  report       the per-file plot path (`analyse.cli report`), when
               matplotlib is installed.

Everything runs in this one process: a JAX process reserves most of a
card's memory, so a second one could not use it. The bundle is written
under the system temporary directory and removed at exit. Every line but
the last is a log line; the last is one JSON object
{"ok": true, "device": {...}}. Without a GPU, or when any phase fails, the
script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from collections.abc import Mapping
from dataclasses import dataclass
from pathlib import Path

import numpy as np

SR = 48_000
N = 1 << 20
TAPS = 64
ISO_TAPS = 8
ONSET = 256
SEED = 20261016
# The taps compared against the references: the shortest and longest decay.
CHECK_TAPS = (0, TAPS - 1)


# Known broadband RT60s of the synthetic taps span this range (seconds).
RT60_RANGE = (0.3, 3.0)


def tap_rt60s(taps: int) -> np.ndarray:
    """Known broadband RT60 of each synthetic tap, log-spaced over RT60_RANGE."""
    return np.geomspace(*RT60_RANGE, taps)


def synth_tap(rt60: float, n: int, seed) -> np.ndarray:
    """(n, 2) float32 decaying noise after a direct peak at ONSET."""
    rng = np.random.default_rng(seed)
    env = 10.0 ** (-3.0 * np.arange(n - ONSET) / SR / rt60)
    x = np.zeros((n, 2), np.float32)
    x[ONSET:] = 0.05 * rng.standard_normal((n - ONSET, 2)) * env[:, None]
    x[ONSET] = 0.9
    return x


class _LazyTaps(Mapping):
    """Tap name -> samples, synthesised when written: write_bundle never
    holds more than one tap in memory."""

    def __init__(self, rt60s: np.ndarray, n: int):
        self._rt60 = {tap_name(i): float(r) for i, r in enumerate(rt60s)}
        self._n = n

    def __getitem__(self, name):
        return synth_tap(self._rt60[name], self._n, (SEED, int(name[3:])))

    def __iter__(self):
        return iter(self._rt60)

    def __len__(self):
        return len(self._rt60)


def tap_name(i: int) -> str:
    return f"tap{i:02d}"


def make_bundle(root: Path, taps: int = TAPS, n: int = N) -> list:
    from audio_analysis_tpu.io.bundle import write_bundle

    write_bundle(root, _LazyTaps(tap_rt60s(taps), n), SR)
    return [tap_name(i) for i in range(taps)]


def rewrite_tap(root: Path, index: int, n: int, taps: int) -> None:
    """Re-render one tap (same RT60, new noise), as the iterate loop does."""
    from audio_analysis_tpu.io.wav import write_wav_pcm16

    x = synth_tap(float(tap_rt60s(taps)[index]), n, (SEED, index, 1))
    write_wav_pcm16(root / "taps" / f"{tap_name(index)}.wav", x, SR)


# ----------------------------------------------------------------------------
# comparison
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class Tol:
    """|got - ref| <= abs + rel * |ref|; NaN only where the reference is NaN."""

    rel: float
    abs: float
    why: str


def deviation(got, ref, tol: Tol):
    """(worst |got - ref|, worst ratio to the allowed deviation); a ratio
    above 1 fails. A NaN on one side only counts as infinitely far."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return float("inf"), float("inf")
    both_nan = np.isnan(got) & np.isnan(ref)
    diff = np.where(both_nan, 0.0, np.abs(got - ref))
    diff = np.where(np.isnan(diff), np.inf, diff)
    allowed = tol.abs + tol.rel * np.abs(np.where(np.isnan(ref), 0.0, ref))
    if diff.size == 0:
        return 0.0, 0.0
    return float(diff.max()), float((diff / allowed).max())


def compare(got: dict, ref: dict, tolerances: dict, label: str) -> list:
    """Print one line per metric family; return the families that failed."""
    failed = []
    for key, tol in tolerances.items():
        worst, ratio = deviation(got[key], ref[key], tol)
        ok = ratio <= 1.0
        print(
            f"{label} {key}: worst |diff|={worst:.3g} (limit rel={tol.rel:g} "
            f"abs={tol.abs:g}: {tol.why}) {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            failed.append(key)
    return failed


# tolerances against the float64 oracle compositions
ORACLE_TOLERANCES = {
    "edc_db": Tol(0.0, 0.02, "f32 reverse cumsum over 2^20 samples vs f64, above the -80 dB fit floor"),
    "t20_rt60": Tol(2e-3, 0.0, "fit over the f32 EDC; crossings move by < 1 sample"),
    "t30_rt60": Tol(2e-3, 0.0, "fit over the f32 EDC; crossings move by < 1 sample"),
    "edt_rt60": Tol(2e-3, 0.0, "fit over the f32 EDC; crossings move by < 1 sample"),
    "early10_time": Tol(0.0, 1e-4, "interpolated crossings of the f32 EDC, ~5 samples"),
    "band_t30_rt60": Tol(5e-3, 0.0, "f32 2^20-point FFT band filter + EDC fit on broadband decaying noise"),
    "stft_rel_err": Tol(0.0, 1e-5, "f32 STFT magnitude vs f64, relative to the plane max; TF32 products give ~1e-3"),
    "stft_global_max_db": Tol(0.0, 1e-3, "f32 STFT peak in dB"),
    "diff_median_autocorr": Tol(0.0, 1e-3, "f32 windowed autocorrelation"),
    "diff_median_echo_density": Tol(0.0, 5e-3, "threshold count: one sample crossing the threshold moves a window by 1.3e-3"),
    "diff_median_corr0": Tol(0.0, 1e-3, "f32 windowed correlation"),
    "diff_median_iacc": Tol(0.0, 1e-3, "f32 windowed cross-correlation"),
}

# tolerances of the card against the same program on the host CPU
CPU_TOLERANCES = {
    "fr_peak_hz": Tol(1e-6, 1.5, "the peak bin may hop one bin (0.05 Hz) on near-ties between FFT libraries"),
    "fr_centroid_hz": Tol(1e-3, 2.0, "f32 2^20-point FFT magnitude sums in another order"),
    "gd_p10": Tol(2e-3, 0.5, "unwrapped f32 phase of a 2^20-point FFT"),
    "gd_median": Tol(2e-3, 0.5, "unwrapped f32 phase of a 2^20-point FFT"),
    "gd_p90": Tol(2e-3, 0.5, "unwrapped f32 phase of a 2^20-point FFT"),
    "modal_count": Tol(0.0, 2.0, "a log bin at a reliability threshold may flip"),
    "modal_median_rt60": Tol(1e-2, 1e-2, "narrowband per-bin fits amplify f32 differences"),
    "modal_p90_rt60": Tol(1e-2, 1e-2, "narrowband per-bin fits amplify f32 differences"),
    "modal_max_rt60": Tol(2e-2, 1e-2, "narrowband per-bin fits amplify f32 differences"),
}

# per-tap metrics of the 4-card mesh run against the 1-card run
MESH_TOLERANCES = {
    "t30_rt60": Tol(1e-3, 1e-4, "same card model; shard_map may fuse in another order"),
    "t20_rt60": Tol(1e-3, 1e-4, "same card model; shard_map may fuse in another order"),
    "edt_rt60": Tol(1e-3, 1e-4, "same card model; shard_map may fuse in another order"),
    "early10_time": Tol(1e-3, 1e-4, "same card model; shard_map may fuse in another order"),
    "band_t30_rt60": Tol(5e-3, 1e-3, "band fits amplify f32 differences"),
    **{k: CPU_TOLERANCES[k] for k in ("fr_peak_hz", "fr_centroid_hz", "gd_median")},
    "stft_global_max_db": Tol(0.0, 1e-3, "f32 STFT peak in dB"),
    "diff_median_autocorr": Tol(0.0, 1e-3, "f32 windowed autocorrelation"),
    "diff_median_echo_density": Tol(0.0, 5e-3, "threshold count"),
    "modal_median_rt60": CPU_TOLERANCES["modal_median_rt60"],
}


# ----------------------------------------------------------------------------
# float64 oracle compositions of the engine's metrics
# ----------------------------------------------------------------------------


def oracle_metrics(x: np.ndarray, length: int, config) -> dict:
    """Engine metrics of one (C, N) tap from audio_analysis_tpu.oracle in
    float64: decay fits, early10, the three-band T30s, the STFT peak and
    the diffusion medians (stereo metrics when C == 2)."""
    from audio_analysis_tpu import oracle
    from audio_analysis_tpu.engine.batch import _band_definitions

    x = np.asarray(x, np.float64)
    c_count, n = x.shape
    freqs = np.fft.rfftfreq(n, 1.0 / SR)
    nyq = 0.5 * SR
    tw = config.transition_width_octaves
    masks = []
    for band in _band_definitions(config):
        if band.kind == "lowpass":
            masks.append(oracle.lowpass_mask(freqs, band.high_edge_hz, tw, nyq))
        elif band.kind == "highpass":
            masks.append(oracle.highpass_mask(freqs, band.low_edge_hz, tw, nyq))
        else:
            masks.append(oracle.bandpass_mask(freqs, band.low_edge_hz, band.high_edge_hz, tw, nyq))

    win = int(round(config.diffusion_window_seconds * SR))
    hop = int(round(config.diffusion_hop_seconds * SR))
    max_lag = int(round(config.diffusion_max_lag_ms / 1000.0 * SR))

    def windows(sig):
        return [sig[i * hop : i * hop + win] for i in range(1 + (sig.size - win) // hop)]

    out = {k: [] for k in ("start", "edc_db", "t20_rt60", "t30_rt60", "edt_rt60", "early10_time",
                           "band_t30_rt60", "stft_global_max_db", "stft_mag",
                           "diff_median_autocorr", "diff_median_echo_density")}
    for c in range(c_count):
        start = int(np.argmax(np.abs(x[c, :length])))
        seg = x[c, start:length]
        t, edc_db, _ = oracle.schroeder_edc_db(seg, SR, trim_to_peak=False)
        out["start"].append(start)
        out["edc_db"].append(edc_db)
        for name, rng in (("t20", config.t20_range_db), ("t30", config.t30_range_db),
                          ("edt", config.edt_range_db)):
            fit = oracle.fit_decay_slope(t, edc_db, rng, config.fit_lower_limit_db)
            out[f"{name}_rt60"].append(np.nan if fit is None else fit[3])
        c0 = oracle.crossing_time(t, edc_db, 0.0)
        c10 = oracle.crossing_time(t, edc_db, -10.0)
        out["early10_time"].append(c10 - c0)
        bands = []
        for mask in masks:
            banded = oracle.apply_fft_mask(x[c], mask)[start:length]
            tb, edc_b, _ = oracle.schroeder_edc_db(banded, SR, trim_to_peak=False)
            fit = oracle.fit_decay_slope(tb, edc_b, config.t30_range_db, config.fit_lower_limit_db)
            bands.append(np.nan if fit is None else fit[3])
        out["band_t30_rt60"].append(bands)
        _, _, mag_db = oracle.stft_magnitude_db(
            seg, SR, config.n_fft, config.hop_length, floor_db=config.magnitude_floor_db
        )
        out["stft_global_max_db"].append(mag_db.max())
        out["stft_mag"].append(10.0 ** (mag_db.T / 20.0))  # (T, F) linear
        ws = windows(seg)
        out["diff_median_autocorr"].append(
            np.nanmedian([oracle.windowed_max_abs_autocorr(w, max_lag) for w in ws]))
        out["diff_median_echo_density"].append(np.nanmedian(
            [oracle.windowed_echo_density(w, config.echo_density_threshold_rms, True) for w in ws]))
    if c_count == 2:
        combined = x[:, :length].mean(axis=0)
        start = int(np.argmax(np.abs(combined)))
        pairs = list(zip(windows(x[0, start:length]), windows(x[-1, start:length])))
        out["diff_median_corr0"] = np.nanmedian([oracle.windowed_corr0(a, b) for a, b in pairs])
        out["diff_median_iacc"] = np.nanmedian(
            [oracle.windowed_iacc_max(a, b, max_lag) for a, b in pairs])
    return out


def engine_vs_oracle(batch: np.ndarray, lengths: np.ndarray, config, device=None) -> list:
    """Run the engine (and its EDC and STFT ops, for their full planes) on
    `device` (default: the default device) and compare every
    oracle-composable metric; returns the failed families."""
    import jax
    import jax.numpy as jnp

    from audio_analysis_tpu.engine.batch import analyze_batch
    from audio_analysis_tpu.ops import edc, stft, trim

    def put(a):
        return jax.device_put(a, device) if device is not None else jnp.asarray(a)

    out = jax.device_get(analyze_batch(put(batch), put(lengths), config))
    samples = put(batch).astype(jnp.float32) * (1.0 / 32768.0) if batch.dtype == np.int16 \
        else put(batch)
    lengths_bc = jnp.broadcast_to(put(lengths)[:, None], samples.shape[:2])
    aligned = trim.align_for_analysis(samples, lengths_bc, SR, True, 0.0)
    curve = jax.device_get(edc.schroeder_edc_db(aligned.samples, aligned.length).edc_db)
    floor_lin = 10.0 ** (config.magnitude_floor_db / 20.0)
    mag = jax.device_get(stft.stft_magnitude(
        aligned.samples, aligned.length, config.n_fft, config.hop_length, True, floor_lin,
        config.stft_fft_impl, fft_precision=config.stft_fft_precision).mag)

    scale = 1.0 / 32768.0 if batch.dtype == np.int16 else 1.0
    got = {k: [] for k in ORACLE_TOLERANCES}
    ref = {k: [] for k in ORACLE_TOLERANCES}
    for b in range(batch.shape[0]):
        o = oracle_metrics(batch[b].astype(np.float64) * scale, int(lengths[b]), config)
        for c in range(batch.shape[1]):
            seg_len = int(lengths[b]) - o["start"][c]
            region = o["edc_db"][c] >= config.fit_lower_limit_db
            got["edc_db"].append(curve[b, c, :seg_len][region])
            ref["edc_db"].append(o["edc_db"][c][region])
            for key in ("t20_rt60", "t30_rt60", "edt_rt60"):
                got[key].append(np.where(out[key.replace("rt60", "ok")][b, c], out[key][b, c], np.nan))
                ref[key].append(o[key][c])
            got["early10_time"].append(out["early10_time"][b, c])
            ref["early10_time"].append(o["early10_time"][c])
            got["band_t30_rt60"].append(
                np.where(out["band_t30_ok"][b, c], out["band_t30_rt60"][b, c], np.nan))
            ref["band_t30_rt60"].append(o["band_t30_rt60"][c])
            ref_mag = o["stft_mag"][c]
            plane = mag[b, c, : ref_mag.shape[0]]
            got["stft_rel_err"].append(np.max(np.abs(plane - ref_mag)) / np.max(ref_mag))
            ref["stft_rel_err"].append(0.0)
            got["stft_global_max_db"].append(out["stft_global_max_db"][b, c])
            ref["stft_global_max_db"].append(o["stft_global_max_db"][c])
            for key in ("diff_median_autocorr", "diff_median_echo_density"):
                got[key].append(out[key][b, c])
                ref[key].append(o[key][c])
        for key in ("diff_median_corr0", "diff_median_iacc"):
            if key in o:
                got[key].append(out[key][b])
                ref[key].append(o[key])
    got = {k: np.concatenate([np.ravel(v) for v in vals]) for k, vals in got.items() if vals}
    ref = {k: np.concatenate([np.ravel(v) for v in vals]) for k, vals in ref.items() if vals}
    tolerances = {k: v for k, v in ORACLE_TOLERANCES.items() if k in got}
    return compare(got, ref, tolerances, "correctness vs oracle")


def engine_vs_cpu(batch: np.ndarray, lengths: np.ndarray, config) -> list:
    """The same engine program on the default device and on the host CPU."""
    import jax

    from audio_analysis_tpu.engine.batch import analyze_batch

    cpu = jax.devices("cpu")[0]
    on_device = jax.device_get(analyze_batch(jax.device_put(batch), jax.device_put(lengths), config))
    on_cpu = jax.device_get(
        analyze_batch(jax.device_put(batch, cpu), jax.device_put(lengths, cpu), config))
    return compare(on_device, on_cpu, CPU_TOLERANCES, "correctness vs cpu")


def dot_precisions(lowered_text: str) -> list:
    """Precision of every dot_general in a lowered (StableHLO) program."""
    import re

    found = []
    for line in lowered_text.splitlines():
        if "stablehlo.dot_general" in line:
            m = re.search(r"precision = \[(\w+), (\w+)\]", line)
            found.append(m.group(1) if m else "DEFAULT")
    return found


def known_rt60_check(t30: np.ndarray, rt60s: np.ndarray, label: str, rel: float = 0.05) -> bool:
    """Broadband T30 of every (tap, channel) within `rel` of the synthetic RT60."""
    t30 = np.asarray(t30, np.float64)
    err = np.abs(t30 / np.asarray(rt60s)[:, None] - 1.0)
    worst = float(np.nanmax(np.where(np.isnan(err), np.inf, err)))
    ok = worst <= rel
    print(f"{label}: known RT60 recovered by T30, worst relative error {worst:.4f} "
          f"(limit {rel}: decaying noise of known RT60) {'ok' if ok else 'FAIL'}")
    return ok


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------


def _run_cli(argv: list) -> float:
    from audio_analysis_tpu.cli import analyse_cli

    t0 = time.perf_counter()
    analyse_cli.main(argv)
    return time.perf_counter() - t0


def _bundle_outputs(root: Path, names: list, subdir: str) -> dict:
    reports = root / subdir
    missing = [t for t in names if not (reports / t / f"{t}_report.md").exists()]
    if not (reports / "bundle_report.md").exists() or missing:
        raise AssertionError(f"bundle reports missing: index or taps {missing[:5]}")
    return json.loads((reports / "bundle_metrics.json").read_text())


def phase_bundle(root: Path, names: list, n: int) -> None:
    """The iterate loop through the CLI: cold, warm, one tap re-rendered."""
    rt60s = tap_rt60s(len(names))
    runs = {}
    for label in ("cold", "warm", "one_tap_changed"):
        if label == "one_tap_changed":
            rewrite_tap(root, len(names) // 2, n, len(names))
        shutil.rmtree(root / "reports", ignore_errors=True)
        wall = _run_cli(["bundle", "--input", str(root), "--no-plots"])
        metrics = _bundle_outputs(root, names, "reports")
        runs[label] = metrics
        print(f"bundle {label}: taps={len(names)} wall_s={wall:.4f} "
              f"phases={json.dumps(metrics['phases'], sort_keys=True)}")
    chunks = runs["cold"]["phases"]["audio_chunks_uploaded"]
    expect = {"warm": (0, chunks), "one_tap_changed": (1, chunks - 1)}
    for label, (uploaded, reused) in expect.items():
        ph = runs[label]["phases"]
        if (ph["audio_chunks_uploaded"], ph["audio_chunks_reused"]) != (uploaded, reused):
            raise AssertionError(f"{label}: device audio cache uploaded/reused "
                                 f"{ph['audio_chunks_uploaded']}/{ph['audio_chunks_reused']}, "
                                 f"expected {uploaded}/{reused}")
    t30 = np.array(runs["one_tap_changed"]["metrics"]["t30_rt60"], np.float64)
    if not known_rt60_check(t30, rt60s, "bundle"):
        raise AssertionError("bundle: known RT60 not recovered")


def phase_iso(root: Path, names: list, work: Path) -> None:
    """Third-octave bands (the lax.map bands path) over the first taps."""
    from audio_analysis_tpu.engine import EngineConfig
    from audio_analysis_tpu.engine.batch import _band_definitions, band_names
    from audio_analysis_tpu.io.bundle import materialize_bundle_view
    from audio_analysis_tpu.report import EngineBundleSettings, run_bundle_report_engine

    taps = names[:ISO_TAPS]
    view = materialize_bundle_view([root / "taps" / f"{t}.wav" for t in taps], work / "iso")
    config = EngineConfig(band_mode="third")
    t0 = time.perf_counter()
    run_bundle_report_engine(view, EngineBundleSettings(config=config))
    wall = time.perf_counter() - t0
    metrics = _bundle_outputs(view, taps, "reports")
    bands = np.array(metrics["metrics"]["band_t30_rt60"], np.float64)
    ok = np.array(metrics["metrics"]["band_t30_ok"], bool)
    print(f"iso: taps={len(taps)} bands={bands.shape[-1]} wall_s={wall:.4f} "
          f"fits_ok={ok.mean():.3f} phases={json.dumps(metrics['phases'], sort_keys=True)}")
    if bands.shape != (len(taps), 2, len(band_names(config))):
        raise AssertionError(f"iso: band_t30_rt60 shape {bands.shape}")
    if ok.mean() < 0.5:
        # the lowest bands of the shortest decays ring past their T30 window
        raise AssertionError(f"iso: only {ok.mean():.2f} of the band fits succeeded")
    # bands from 500 Hz up: there the band filter's own ringing is far
    # shorter than the decays it measures
    centres = np.array([band.centre_hz for band in _band_definitions(config)])
    upper = ok & (centres >= 500.0)
    medians = np.array([[np.median(bands[b, c][upper[b, c]]) for c in range(2)]
                        for b in range(len(taps))])
    if not known_rt60_check(medians, tap_rt60s(len(names))[: len(taps)],
                            "iso (median over bands >= 500 Hz)", rel=0.1):
        raise AssertionError("iso: band T30s do not recover the known RT60")


def read_taps_i16(root: Path, taps: list) -> tuple:
    """(B, 2, N) int16 batch + lengths, the samples the bundle path decodes."""
    from scipy.io import wavfile

    rows = [wavfile.read(root / "taps" / f"{t}.wav")[1].T for t in taps]
    return np.stack(rows).astype(np.int16), np.array([r.shape[-1] for r in rows], np.int32)


def phase_correctness(root: Path, names: list, tap_indices=CHECK_TAPS) -> None:
    """Full-width results on the card against the references."""
    import jax
    import jax.numpy as jnp

    from audio_analysis_tpu.engine import EngineConfig
    from audio_analysis_tpu.engine.batch import analyze_batch

    config = EngineConfig()
    taps = [names[i] for i in tap_indices]
    batch, lengths = read_taps_i16(root, taps)
    lowered = analyze_batch.lower(jnp.asarray(batch), jnp.asarray(lengths), config).as_text()
    precisions = dot_precisions(lowered)
    print(f"correctness: taps={taps} samples={batch.shape[-1]}; the engine program has "
          f"{len(precisions)} f32 contractions, precisions {sorted(set(precisions))} "
          "(all must be HIGHEST: no TF32)")
    failed = [] if set(precisions) == {"HIGHEST"} else ["contraction precision"]
    failed += engine_vs_oracle(batch, lengths, config)
    failed += engine_vs_cpu(batch, lengths, config)
    out = jax.device_get(analyze_batch(jnp.asarray(batch), jnp.asarray(lengths), config))
    t30 = np.where(out["t30_ok"], out["t30_rt60"], np.nan)
    if not known_rt60_check(t30, tap_rt60s(len(names))[list(tap_indices)], "correctness"):
        failed.append("known rt60")
    if failed:
        raise AssertionError(f"correctness failed: {failed}")


def phase_report(root: Path, names: list, work: Path) -> bool:
    """The per-file plot path; returns False when it could not run."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        print(f"report: not run — matplotlib is not installed ({exc})")
        return False
    out = work / "report" / names[0]
    wall = _run_cli(["report", "--input", str(root / "taps" / f"{names[0]}.wav"),
                     "--output", str(out), "--mono"])
    pngs = sorted(p.name for p in out.parent.glob("*.png"))
    mds = sorted(out.parent.glob("*.md"))
    print(f"report: wall_s={wall:.4f} pngs={len(pngs)} markdown={[p.name for p in mds]}")
    if len(pngs) < 10 or not mds:
        raise AssertionError(f"report: expected >= 10 PNGs and a summary, got {pngs}")
    return True


def fft_impl_times(root: Path, names: list, chunk: int = 8, repeats: int = 3) -> None:
    """Informational: warm time of one chunk with the mx and the xla frame
    FFT (device-resident input, host clock around block_until_ready)."""
    import jax
    import jax.numpy as jnp

    from audio_analysis_tpu.engine import EngineConfig
    from audio_analysis_tpu.engine.batch import analyze_batch_flat

    batch, lengths = read_taps_i16(root, names[:chunk])
    batch, lengths = jnp.asarray(batch), jnp.asarray(lengths)
    times = {}
    for impl in ("mx", "xla"):
        config = EngineConfig(stft_fft_impl=impl)
        jax.block_until_ready(analyze_batch_flat(batch, lengths, config))
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(analyze_batch_flat(batch, lengths, config))
            best = min(best, time.perf_counter() - t0)
        times[impl] = best
    print(f"info: one {chunk}-tap chunk, full engine, warm best of {repeats}: "
          f"stft_fft_impl=mx {times['mx']:.4f} s, xla {times['xla']:.4f} s "
          "(informational; the default is not switched here)")


def phase_four_cards(root: Path, names: list, cards: int = 4) -> None:
    """The automatic mesh over `cards` devices against one device."""
    import jax

    from audio_analysis_tpu.engine import EngineConfig
    from audio_analysis_tpu.engine.mesh import analyze_batch_sharded, make_mesh
    from audio_analysis_tpu.report import EngineBundleSettings, run_bundle_report_engine

    devices = jax.devices()
    if len(devices) != cards:
        raise AssertionError(f"four-cards: {len(devices)} devices visible, expected {cards}")
    mesh_wall = _run_cli(["bundle", "--input", str(root), "--no-plots",
                          "--reports-subdir", "reports_mesh"])
    mesh = _bundle_outputs(root, names, "reports_mesh")
    t0 = time.perf_counter()
    run_bundle_report_engine(root, EngineBundleSettings(reports_subdir="reports_one",
                                                         use_device_mesh="off"))
    one_wall = time.perf_counter() - t0
    one = _bundle_outputs(root, names, "reports_one")
    print(f"four-cards: mesh over {cards} devices wall_s={mesh_wall:.4f} "
          f"phases={json.dumps(mesh['phases'], sort_keys=True)}")
    print(f"four-cards: one device wall_s={one_wall:.4f} "
          f"phases={json.dumps(one['phases'], sort_keys=True)}")
    failed = compare(
        {k: np.array(mesh["metrics"][k], np.float64) for k in MESH_TOLERANCES},
        {k: np.array(one["metrics"][k], np.float64) for k in MESH_TOLERANCES},
        MESH_TOLERANCES, "four-cards mesh vs one card")

    # the engine's output sharding spans every card, not all on the first
    batch, lengths = read_taps_i16(root, names[: 8 * cards])
    out = analyze_batch_sharded(make_mesh(), batch, lengths, EngineConfig(),
                                include_bundle_aggregates=False)
    arr = jax.block_until_ready(out["t30_rt60"])
    shard_devices = {s.device for s in arr.addressable_shards}
    print(f"four-cards: t30_rt60 {arr.shape} sharded over "
          f"{sorted(str(d) for d in shard_devices)}")
    if len(shard_devices) != cards or {d.platform for d in shard_devices} != {devices[0].platform}:
        failed.append("output sharding")
    for d in devices:
        stats = d.memory_stats() or {}
        print(f"four-cards: {d} bytes_in_use={stats.get('bytes_in_use')} "
              f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    if failed:
        raise AssertionError(f"four-cards failed: {failed}")


# ----------------------------------------------------------------------------
# driver
# ----------------------------------------------------------------------------


def _card_lines() -> list:
    try:
        run = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        lines = [ln.strip() for ln in run.stdout.splitlines() if ln.strip()]
        return lines or [f"nvidia-smi printed nothing (exit {run.returncode})"]
    except (OSError, subprocess.SubprocessError) as exc:
        return [f"nvidia-smi unavailable: {exc}"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card mesh path and its 1-card comparison")
    args = parser.parse_args(argv)

    try:
        import audio_analysis_tpu  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository ({exc}); "
              "nothing was run", file=sys.stderr)
        return 2

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (default backend {jax.default_backend()!r}); "
              "nothing was run", file=sys.stderr)
        return 1
    devices = jax.devices()
    for line in _card_lines():
        print(line)
    print(f"jax {jax.__version__}; devices {devices}")

    from audio_analysis_tpu.io import native

    if native.ensure_built():
        print("decoder: native libaudioio (cpp/build), planar int16 chunks")
    else:
        print("decoder: scipy fallback (the native library could not be built)")

    failures, ran = [], []

    def run(name, fn, *fn_args):
        t0 = time.perf_counter()
        try:
            result = fn(*fn_args)
        except Exception:  # noqa: BLE001 — recorded, and the exit code says so
            traceback.print_exc()
            failures.append(name)
            print(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s")
            return
        if result is not False:
            ran.append(name)
            print(f"phase {name}: passed in {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        root = work / "bundle"
        t0 = time.perf_counter()
        names = make_bundle(root)
        print(f"bundle written: {len(names)} stereo PCM16 taps x {N} samples "
              f"in {time.perf_counter() - t0:.1f} s")
        if args.four_cards:
            run("four_cards", phase_four_cards, root, names)
        else:
            run("bundle", phase_bundle, root, names, N)
            run("iso", phase_iso, root, names, work)
            run("correctness", phase_correctness, root, names)
            run("report", phase_report, root, names, work)
            run("fft_impl_times", fft_impl_times, root, names)

    print(f"phases passed: {ran}")
    if failures:
        print(f"chip_smoke: FAILED phases {failures}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
