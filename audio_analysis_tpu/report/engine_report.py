"""
Engine-backed bundle reports: the fast path for whole bundles.

`run_bundle_report_engine` decodes every tap with the native parallel
loader, runs the fused device engine ONCE for the whole bundle, and writes
per-tap markdown summaries (the same deterministic text formats as the
plot-based reports, minus the images) plus a machine-readable
bundle_metrics.json. The plot-based runner (report/bundle.py) remains the
full-fidelity path; this one is for tight DSP iteration loops where the
numbers are what matters.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from audio_analysis_tpu.engine import EngineConfig, analyze_bundle
from audio_analysis_tpu.io.bundle import load_bundle_batch, load_bundle_batch_i16


@dataclass(frozen=True)
class EngineBundleSettings:
    reports_subdir: str = "reports"
    use_mono_downmix_for_stereo: bool = False
    config: EngineConfig = EngineConfig()
    # Taps per engine chunk: the modal 8192-FFT intermediates are the
    # device-memory high-water mark, and smaller chunks overlap uploads with
    # compute at finer grain. Untuned on the current card (ROADMAP).
    chunk_taps: int = 8
    # Chunks decoded + uploaded ahead of the one the engine consumes, so
    # the changed-audio upload hides under compute (see
    # analyze_bundle_pipelined). Untuned on the current card (ROADMAP).
    prefetch_chunks: int = 2
    # "auto": shard the tap batch over all local devices when more than one
    # is visible (shard_map over the "taps" mesh, one chunk of chunk_taps
    # per device); "off": single-device chunked engine.
    use_device_mesh: str = "auto"
    # Keep the (padded, int16) tap audio resident on device between runs of
    # the SAME unchanged bundle (keyed by tap paths + mtimes + sizes): the
    # iterate-loop workflow re-analyses one bundle repeatedly, and a warm
    # rerun then skips decode AND the whole host->device upload. One bundle
    # slot (~0.25 GB for 64x2^20 stereo taps); on a device mesh the cached
    # chunks are tap-sharded arrays (keyed by the mesh, so entries never
    # cross between mesh and single-device runs).
    cache_device_audio: bool = True
    # Path to a previous run's bundle_metrics.json (or its reports dir /
    # bundle root): appends a deterministic "Changes vs previous" section
    # to the index flagging headline metrics that moved >= the threshold
    # (report/compare.py) — the regression-detection step of the
    # change->analyse->repeat loop.
    compare_to: Optional[str] = None
    compare_threshold_pct: float = 1.0




def _analyze_possibly_sharded(
    batch: np.ndarray,
    lengths: np.ndarray,
    config: EngineConfig,
    settings: "EngineBundleSettings",
) -> Dict[str, np.ndarray]:
    """
    Tap-data-parallel engine when several devices are visible (shard_map
    over the "taps" mesh, chunked so per-device memory stays bounded by
    chunk_taps), single-device chunked engine otherwise.
    """
    import jax

    n_dev = len(jax.devices())
    if str(settings.use_device_mesh).lower() == "off" or n_dev <= 1:
        return analyze_bundle(batch, lengths, config, settings.chunk_taps)

    from audio_analysis_tpu.engine.mesh import analyze_batch_sharded, make_mesh

    mesh = make_mesh()
    chunk = max(1, settings.chunk_taps) * n_dev
    b = batch.shape[0]
    parts: List[Dict[str, np.ndarray]] = []
    from audio_analysis_tpu.ops import transport

    for lo in range(0, b, chunk):
        hi = min(b, lo + chunk)
        out = analyze_batch_sharded(
            mesh, batch[lo:hi], lengths[lo:hi], config,
            include_bundle_aggregates=False,  # recomputed host-side below
        )
        # ONE packed d2h copy per chunk pytree (repo convention — each
        # separate fetch costs its own transfer latency)
        parts.append(transport.fetch_packed_tree(out))
    return {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}


def _channel_names_from_output(out: Dict[str, np.ndarray]) -> List[str]:
    """Channel labels matching the engine output's channel axis."""
    c = int(np.asarray(out["start_index"]).shape[1])
    if c == 1:
        return ["mono"]
    if c == 2:
        return ["left", "right"]
    return [f"ch{i}" for i in range(c)]


def _fit_line(
    out: Dict[str, np.ndarray], name: str, b: int, c: int, ranges: tuple
) -> str:
    """One decay-fit summary line in the decay.py:530-538 format. `ranges`
    is the CONFIGURED dB window (EngineConfig.*_range_db) — the printed
    window must be the one the engine actually fitted with."""
    label = name.upper()
    if not bool(out[f"{name}_ok"][b, c]):
        return f"  {label}: NA"
    return (
        f"  {label}: "
        f"range=[{ranges[0]:.1f},{ranges[1]:.1f}]dB "
        f"time=[{out[f'{name}_t_start'][b, c]:.4f},{out[f'{name}_t_end'][b, c]:.4f}]s "
        f"slope={out[f'{name}_slope'][b, c]:.6f}dB/s "
        f"r2={out[f'{name}_r2'][b, c]:.6f} "
        f"rt60={out[f'{name}_rt60'][b, c]:.4f}s"
    )


def _summary_context(config: EngineConfig, sample_rate_hz: int) -> Dict:
    """Per-bundle constants for format_tap_summary — computed once, not per
    tap (band labels, waterfall slice policy + display bin count)."""
    ctx: Dict = {}
    from audio_analysis_tpu.engine.batch import band_names

    ctx["band_labels"] = band_names(config)
    ctx["fit_ranges"] = {
        "edt": config.edt_range_db,
        "t20": config.t20_range_db,
        "t30": config.t30_range_db,
    }

    from audio_analysis_tpu.analyses.waterfall import (
        WaterfallAnalysisSettings,
        select_slice_frame_indices,
    )
    from audio_analysis_tpu.ops import stft as stft_ops

    wf_settings = WaterfallAnalysisSettings()
    freq_hz = stft_ops.rfft_freqs_hz(config.n_fft, sample_rate_hz)
    ctx["wf_settings"] = wf_settings
    ctx["wf_select"] = select_slice_frame_indices
    ctx["wf_f_bins"] = int(
        ((freq_hz >= wf_settings.f_min_hz) & (freq_hz <= wf_settings.f_max_hz)).sum()
    )
    ctx["frame_times"] = stft_ops.frame_times_seconds
    return ctx


def format_tap_summary(
    out: Dict[str, np.ndarray],
    b: int,
    channel_names: List[str],
    sample_rate_hz: int,
    config: EngineConfig,
    ctx: Dict = None,
) -> str:
    """All per-tap deterministic summaries in the reference text formats."""
    if ctx is None:
        ctx = _summary_context(config, sample_rate_hz)
    md: List[str] = []

    if "peak_abs" in out:
        # IR view (the plot-based report's first block; images are replaced
        # by the deterministic stats the plots visualise)
        md.append("## Impulse response\n\n```text")
        for c, ch in enumerate(channel_names):
            seg = int(out["segment_length"][b, c])
            md.append(
                f"[{ch}] peak_sample={int(out['start_index'][b, c])}  "
                f"peak_abs={out['peak_abs'][b, c]:.6f}  "
                f"dur={seg / sample_rate_hz:.3f}s"
            )
        md.append("```\n")

    md.append("## Decay / EDC\n\n```text")
    for c, ch in enumerate(channel_names):
        md.append(f"[{ch}] analysis_start_sample_index={int(out['start_index'][b, c])}")
        if bool(out["early10_ok"][b, c]):
            md.append(f"  early_0_to_-10_time={out['early10_time'][b, c]:.4f}s")
        else:
            md.append("  early_0_to_-10_time=NA")
        for name in ("edt", "t20", "t30"):
            md.append(_fit_line(out, name, b, c, ctx["fit_ranges"][name]))
        md.append("")
    md.append("```\n")

    if "band_t30_rt60" in out:
        labels = ctx["band_labels"]
        md.append("## RT60 by band\n\n```text")
        for c, ch in enumerate(channel_names):
            md.append(f"[{ch}]")
            md.append("Band  T30_RT60(s)")
            for bi, band in enumerate(labels):
                ok = bool(out["band_t30_ok"][b, c, bi])
                value = f"{out['band_t30_rt60'][b, c, bi]:.3f}" if ok else "NA"
                md.append(f"{band}  {value}")
            md.append("")
        md.append("```\n")

    if "fr_peak_hz" in out:
        md.append("## Frequency response\n\n```text")
        for c, ch in enumerate(channel_names):
            md.append(
                f"[{ch}] start_sample={int(out['start_index'][b, c])}  "
                f"len_samples={int(out['segment_length'][b, c])}  "
                f"peak={out['fr_peak_hz'][b, c]:.1f}Hz  "
                f"centroid={out['fr_centroid_hz'][b, c]:.1f}Hz"
            )
        md.append("```\n")

    if "gd_median" in out:
        md.append("## Group delay\n\n```text\nGroup delay summary:")
        for c, ch in enumerate(channel_names):
            md.append(
                f"- {ch}: gd median={out['gd_median'][b, c]:.3f} samples, "
                f"p10={out['gd_p10'][b, c]:.3f}, p90={out['gd_p90'][b, c]:.3f}"
            )
        md.append("```\n")

    if "stft_num_frames" in out:
        md.append("## Spectrogram\n\n```text")
        for c, ch in enumerate(channel_names):
            seg = int(out["segment_length"][b, c])
            md.append(
                f"[{ch}] start_sample={int(out['start_index'][b, c])}  "
                f"len_samples={seg}  dur={seg / sample_rate_hz:.3f}s  "
                f"stft(n_fft={config.n_fft}, frames={int(out['stft_num_frames'][b, c])})"
            )
        md.append("```\n")

    if "stft_num_frames" in out:
        # waterfall summary derived from the shared STFT (same slice policy
        # as the analyses module: auto mode, 18 slices, 20-20k display band)
        f_bins = ctx["wf_f_bins"]
        md.append("## Waterfall\n\n```text")
        for c, ch in enumerate(channel_names):
            t_frames = int(out["stft_num_frames"][b, c])
            times = ctx["frame_times"](t_frames, config.hop_length, sample_rate_hz)
            slices = ctx["wf_select"](times, ctx["wf_settings"]).size
            seg = int(out["segment_length"][b, c])
            md.append(
                f"[{ch}] start_sample={int(out['start_index'][b, c])}  "
                f"dur={seg / sample_rate_hz:.3f}s  "
                f"slices={slices}  f_bins={f_bins}"
            )
        md.append("```\n")

    if "diff_median_autocorr" in out:
        md.append("## Diffusion / echo density proxy\n\n```text")
        for c, ch in enumerate(channel_names):
            md.append(f"[{ch}]")
            md.append(f"  median_max_abs_autocorr={out['diff_median_autocorr'][b, c]:.3f}")
            md.append(f"  median_echo_density={out['diff_median_echo_density'][b, c]:.3f}")
            # stereo-only metrics exist only when the engine ran on C==2
            if "diff_median_corr0" in out:
                md.append(f"  median_corr0={out['diff_median_corr0'][b]:.3f}")
                md.append(f"  median_iacc_max={out['diff_median_iacc'][b]:.3f}")
        md.append("```\n")

    if "modal_count" in out:
        md.append("## Modal cloud\n\n```text")
        for c, ch in enumerate(channel_names):
            seg = int(out["segment_length"][b, c])
            md.append(
                f"[{ch}] metric=t30 start_sample={int(out['start_index'][b, c])} "
                f"dur={seg / sample_rate_hz:.3f}s points={int(out['modal_count'][b, c])}"
            )
            if int(out["modal_count"][b, c]) > 0:
                md.append(
                    f"  rt60: median={out['modal_median_rt60'][b, c]:.3f}s  "
                    f"p90={out['modal_p90_rt60'][b, c]:.3f}s  "
                    f"max={out['modal_max_rt60'][b, c]:.3f}s"
                )
        md.append("```\n")

    return "\n".join(md)


# single-slot (one bundle) device-resident tap-audio cache, keyed PER
# CHUNK (see EngineBundleSettings.cache_device_audio): re-analysing a
# bundle re-decodes and re-uploads only the chunks whose tap WAVs changed,
# so a 1-of-N-tap iteration moves 1/num_chunks of the audio bytes instead
# of the whole bundle.
_DEVICE_AUDIO_CACHE: Dict = {"shape_key": None, "entries": {}}


class _ChunkCache:
    """Per-chunk get/put view over _DEVICE_AUDIO_CACHE for ONE bundle run.

    Each entry is (chunk_signature, device_array) where the signature is
    the (path, mtime_ns, size) tuple of exactly the taps in that chunk —
    a changed tap invalidates only its own chunk. Entries from the
    previous run are popped as they are consulted, so a replaced chunk's
    device buffer is released before its successor uploads (peak extra
    device memory is one chunk, not a second bundle)."""

    def __init__(self, sig_for: list, chunk_taps: int, old: Dict, new: Dict):
        self._sig_for = sig_for
        self._chunk = int(chunk_taps)
        self._old = old
        self._new = new
        self.reused = 0
        self.uploaded = 0

    def _sig(self, idx: int):
        lo = idx * self._chunk
        return tuple(self._sig_for[lo : lo + self._chunk])

    def get(self, idx: int):
        ent = self._old.pop(idx, None)
        if ent is not None and ent[0] == self._sig(idx):
            self._new[idx] = ent
            self.reused += 1
            return ent[1]
        return None

    def put(self, idx: int, arr) -> None:
        self._new[idx] = (self._sig(idx), arr)
        self.uploaded += 1


def _device_audio_chunks(
    bundle_root: Path, names: List[str], chunk_taps: int, n_max: int, mesh=None
) -> _ChunkCache:
    """A per-chunk cache view for this bundle state. Chunks whose taps'
    path/mtime/size are unchanged (at the same chunking AND padded batch
    length) are served from device memory; everything else decodes+uploads
    and replaces its slot.

    `n_max` is part of the invalidation key: a re-record that grows the
    bundle's longest tap changes every chunk's padded shape (and the
    full-signal FFT grid downstream), so an unchanged-looking chunk cached
    at the old n_max must NOT be reused. So is the mesh (by device ids):
    mesh entries are tap-SHARDED arrays, single-device entries are plain —
    one must never serve the other, and the per-chunk tap count itself is
    chunk_taps x mesh size (mirroring analyze_bundle_pipelined's chunking,
    including its clamp for small bundles)."""
    import os

    sig_for = []
    for tap in names:
        p = bundle_root / "taps" / f"{tap}.wav"
        st = os.stat(p)
        sig_for.append((str(p), st.st_mtime_ns, st.st_size))

    n_shards = int(mesh.shape["taps"]) if mesh is not None else 1
    b = len(names)
    eff_chunk = max(1, min(int(chunk_taps), -(-b // n_shards))) * n_shards
    mesh_key = (
        None if mesh is None else tuple(int(d.id) for d in mesh.devices.flat)
    )

    cache = _DEVICE_AUDIO_CACHE
    shape_key = (eff_chunk, int(n_max), mesh_key)
    if cache["shape_key"] != shape_key:
        cache["shape_key"] = shape_key
        cache["entries"] = {}
    old = cache["entries"]
    new: Dict = {}
    cache["entries"] = new
    return _ChunkCache(sig_for, eff_chunk, old, new)


def run_bundle_report_engine(
    bundle_root: str | Path,
    settings: Optional[EngineBundleSettings] = None,
) -> Path:
    """Fused-engine bundle analysis: per-tap summary md + bundle_metrics.json."""
    if settings is None:
        settings = EngineBundleSettings()

    bundle_root = Path(bundle_root)
    if not (bundle_root / "meta.json").exists():
        raise ValueError(
            f"Not a capture bundle: {bundle_root} has no meta.json "
            "(expected the recorder layout: meta.json + taps/*.wav)"
        )
    start_total = time.perf_counter()

    import jax

    from audio_analysis_tpu.engine.batch import analyze_bundle_pipelined
    from audio_analysis_tpu.io.bundle import open_bundle_chunks_i16

    use_mesh = str(settings.use_device_mesh).lower() != "off" and len(jax.devices()) > 1

    # PCM16 fast path: planar int16 straight from the native decoder, float
    # conversion — and the 0.5*(L+R) mono downmix when requested — happen
    # on device, so host decode and the host->device link both move half
    # the bytes of the f32 path. The decode is additionally PIPELINED:
    # chunk k+1 decodes on a worker thread while chunk k uploads/dispatches
    # (single-device and mesh-sharded dispatch alike).
    chunked = open_bundle_chunks_i16(bundle_root)
    if chunked is not None:
        meta, lengths, names, n_max, loader = chunked
        batch = None
        downmix_on_device = settings.use_mono_downmix_for_stereo
    else:
        fast = load_bundle_batch_i16(bundle_root)
        if fast is not None:
            meta, batch, lengths, names = fast
            downmix_on_device = settings.use_mono_downmix_for_stereo
        else:
            meta, batch, lengths, names = load_bundle_batch(bundle_root)
            downmix_on_device = False
            if settings.use_mono_downmix_for_stereo:
                batch = np.mean(batch, axis=1, keepdims=True).astype(np.float32)
    load_seconds = time.perf_counter() - start_total
    if len(names) == 0:
        raise ValueError(f"Bundle {bundle_root} has no taps.")

    from dataclasses import replace

    config = settings.config
    if config.sample_rate_hz != meta.sample_rate_hz:
        config = replace(config, sample_rate_hz=meta.sample_rate_hz)
    if downmix_on_device and not config.downmix_to_mono:
        config = replace(config, downmix_to_mono=True)

    reports_root = bundle_root / settings.reports_subdir
    reports_root.mkdir(parents=True, exist_ok=True)

    ctx = _summary_context(config, meta.sample_rate_hz)
    tap_lines: List[str] = []

    def _write_tap(tap: str, b_global: int, out_like: Dict, b_local: int,
                   channel_names: List[str]) -> None:
        out_dir = reports_root / tap
        out_dir.mkdir(parents=True, exist_ok=True)
        body = format_tap_summary(
            out_like, b_local, channel_names, meta.sample_rate_hz, config, ctx
        )
        header = (
            "# Offline Reverb Analysis Report (engine)\n\n"
            f"**Tap:** `{tap}`  \n"
            f"**Sample rate:** {meta.sample_rate_hz} Hz  \n"
            f"**Samples:** {int(lengths[b_global])}\n\n---\n\n"
        )
        (out_dir / f"{tap}_report.md").write_text(header + body)
        # relative to the index file, which itself lives in reports_subdir
        # (the reference prefixes the subdir again — broken links that
        # report/bundle.py mirrors for parity; this engine-format index is
        # new code, so its links actually resolve)
        tap_lines.append(f"- [{tap}]({tap}/{tap}_report.md)")

    def _on_chunk(lo: int, hi: int, res: Dict) -> None:
        # per-tap markdown rides inside the device timeline: chunk k's
        # summaries are written while chunks k+1..n still compute
        ch_names = _channel_names_from_output(res)
        for b in range(lo, hi):
            _write_tap(names[b], b, res, b - lo, ch_names)

    phases: Dict[str, float] = {"probe_s": round(load_seconds, 4)}
    start_compute = time.perf_counter()
    if batch is None:
        mesh = None
        if use_mesh:
            from audio_analysis_tpu.engine.mesh import make_mesh

            mesh = make_mesh()
        chunk_cache = None
        if settings.cache_device_audio:
            chunk_cache = _device_audio_chunks(
                bundle_root, names, settings.chunk_taps, n_max, mesh
            )
        out = analyze_bundle_pipelined(
            loader, lengths, n_max, config, settings.chunk_taps, mesh=mesh,
            timings=phases, device_chunk_cache=chunk_cache,
            prefetch_chunks=settings.prefetch_chunks,
            on_chunk_result=_on_chunk,
        )
        if chunk_cache is not None:
            phases["audio_chunks_reused"] = chunk_cache.reused
            phases["audio_chunks_uploaded"] = chunk_cache.uploaded
        phases["markdown_s"] = phases.pop("chunk_callback_s", 0.0)
    else:
        out = _analyze_possibly_sharded(batch, lengths, config, settings)
    compute_seconds = time.perf_counter() - start_compute
    phases["compute_total_s"] = round(compute_seconds, 4)

    # channel names follow the engine's ACTUAL channel count, so a
    # config-level downmix_to_mono can't desync the summary writer
    channel_names = _channel_names_from_output(out)

    if batch is not None:
        # the non-pipelined path has no per-chunk callback: write the
        # summaries from the assembled output, as before
        start_markdown = time.perf_counter()
        for b, tap in enumerate(names):
            _write_tap(tap, b, out, b, channel_names)
        phases["markdown_s"] = round(time.perf_counter() - start_markdown, 4)

    index_lines = [
        "# IR Bundle Report (engine)\n",
        f"**Bundle:** `{bundle_root}`\n",
        f"**Sample rate:** {meta.sample_rate_hz}\n",
        f"**Length (samples):** {meta.length_samples}\n",
        f"**Taps:** {len(names)}  |  load {load_seconds:.3f}s  |  "
        f"analysis {compute_seconds:.3f}s\n",
        "\n## Taps\n",
    ] + tap_lines

    # machine-readable dump of every metric
    start_json = time.perf_counter()
    t30 = np.asarray(out["t30_rt60"])
    t30_valid = t30[np.asarray(out["t30_ok"]) & np.isfinite(t30)]
    metrics_json = {
        "taps": names,
        "channels": channel_names,
        "load_seconds": load_seconds,
        "compute_seconds": compute_seconds,
        # the service-level headline (watch_log.jsonl picks it up)
        "bundle_median_t30": float(np.median(t30_valid)) if t30_valid.size else None,
        "phases": phases,  # json_s lands in the file too (dict aliased)
        # NaN/Infinity are emitted as-is (Python json extension) for
        # unavailable metrics; consumers should parse with the same.
        "metrics": {k: np.asarray(v).tolist() for k, v in out.items()},
    }
    # comparison reads the PREVIOUS run's file before this run's dump
    # overwrites it, so comparing against the same reports dir in place
    # ("what changed since my last run here?") works too
    compare_section = None
    if settings.compare_to:
        from audio_analysis_tpu.report.compare import compare_section_for_index

        compare_section = compare_section_for_index(
            metrics_json, settings.compare_to, settings.compare_threshold_pct
        )
    # NO indent: any indent forces CPython's pure-Python json encoder, which
    # costs ~0.1 s of host time over the ~80k metric floats here; compact
    # uses the C encoder. json_s is stamped before the phases dict (aliased
    # into the file) is serialized, so it covers the tolist conversion.
    phases["json_s"] = round(time.perf_counter() - start_json, 4)
    (reports_root / "bundle_metrics.json").write_text(
        json.dumps(metrics_json, separators=(",", ":"))
    )
    if compare_section:
        index_lines.append(compare_section)

    index_path = reports_root / "bundle_report.md"
    index_path.write_text("\n".join(index_lines) + "\n")
    return index_path
