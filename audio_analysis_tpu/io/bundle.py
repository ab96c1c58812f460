"""
The filesystem bundle contract shared with the C++ capture harness.

Layout (recorder.hpp:102-126, bundle.py:9-16 in the reference):
    <bundle_root>/
      meta.json          {"sample_rate_hz": int, "length_samples": int,
                          "taps": ["name", ...]}
      taps/<name>.wav    stereo PCM16 interleaved

This module reads/writes that contract and provides the batched loader that
feeds the device engine: all taps padded into one (B, N_max, C) float32 array.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

import numpy as np

from audio_analysis_tpu.io import native
from audio_analysis_tpu.io.wav import (
    duplicate_mono_to_stereo,
    ensure_2d_channel_array,
    load_wav_file,
    wav_is_plain_pcm16,
    write_wav_pcm16,
)


@dataclass(frozen=True)
class BundleMeta:
    sample_rate_hz: int
    length_samples: int
    taps: List[str]


def read_bundle_meta(bundle_root: str | Path) -> BundleMeta:
    meta_path = Path(bundle_root) / "meta.json"
    meta = json.loads(meta_path.read_text())
    return BundleMeta(
        sample_rate_hz=int(meta.get("sample_rate_hz", 48000)),
        length_samples=int(meta.get("length_samples", 0)),
        taps=list(meta.get("taps", [])),
    )


def write_bundle(
    bundle_root: str | Path,
    taps: dict[str, np.ndarray],
    sample_rate_hz: int,
) -> Path:
    """
    Write a bundle in the recorder's format (taps are (N,) or (N,2) float32).
    Useful for tests and synthetic workloads; the production producer is the
    C++ AnalysisRecorder equivalent in cpp/recorder.hpp.
    """
    bundle_root = Path(bundle_root)
    (bundle_root / "taps").mkdir(parents=True, exist_ok=True)

    length = 0
    for name, data in taps.items():
        stereo = duplicate_mono_to_stereo(ensure_2d_channel_array(np.asarray(data)))
        write_wav_pcm16(bundle_root / "taps" / f"{name}.wav", stereo, sample_rate_hz)
        length = max(length, stereo.shape[0])

    meta = {
        "sample_rate_hz": int(sample_rate_hz),
        "length_samples": int(length),
        "taps": sorted(taps.keys()),
    }
    (bundle_root / "meta.json").write_text(json.dumps(meta, indent=2) + "\n")
    return bundle_root


def materialize_bundle_view(
    wav_paths: List[str | Path],
    bundle_root: str | Path,
    expected_sample_rate_hz: int | None = None,
) -> Path:
    """
    Turn LOOSE WAV files into a bundle view: `bundle_root/meta.json` +
    `bundle_root/taps/<stem>.wav` symlinks to the originals (copies where
    the filesystem refuses symlinks). Every bundle tool then works on
    arbitrary IR collections — the fused engine (`bundle --no-plots`),
    plot reports, `--compare`, `--resume`, `watch` (symlinks stat through
    to the originals, so re-rendering an input re-triggers analysis).

    Tap order preserves the input order; duplicate stems get `_2`, `_3`…
    suffixes. All inputs must share one sample rate (the engine analyses
    the batch under a single rate; pass `expected_sample_rate_hz` to
    enforce a specific one).
    """
    import shutil

    paths = [Path(p) for p in wav_paths]
    if not paths:
        raise ValueError("materialize_bundle_view: no input WAV files given")
    for p in paths:
        if not p.is_file():
            raise ValueError(f"Input WAV not found: {p}")

    def probe(path: Path) -> Tuple[int, int]:
        """(frames, sample_rate) without decoding PCM where possible."""
        if native.available():
            frames, _ch, rate = native.read_wav_info(path)
            return int(frames), int(rate)
        from audio_analysis_tpu.io.wav import _read_wav_raw, wav_header_info

        info = wav_header_info(path)
        if info is not None:
            frames, _ch, rate = info
            return int(frames), int(rate)
        # unparseable header: let the real decoder produce its error (or
        # succeed on an exotic-but-valid file the header walk rejected)
        rate, raw = _read_wav_raw(path)
        return int(np.asarray(raw).shape[0]), int(rate)

    frames_rates = [probe(p) for p in paths]
    rates = {rate for _f, rate in frames_rates}
    if len(rates) > 1:
        raise ValueError(
            f"Inputs mix sample rates {sorted(rates)} — the engine analyses "
            "one batch at one rate; split the files by rate"
        )
    rate = rates.pop()
    if expected_sample_rate_hz is not None and rate != int(expected_sample_rate_hz):
        raise ValueError(
            f"Inputs are {rate} Hz, expected {int(expected_sample_rate_hz)} Hz"
        )

    names: List[str] = []
    used = set()
    for p in paths:
        name = p.stem
        k = 2
        while name in used:
            name = f"{p.stem}_{k}"
            k += 1
        used.add(name)
        names.append(name)

    bundle_root = Path(bundle_root)
    # never overwrite a REAL bundle: a recorder output dir mistakenly given
    # as --output would otherwise have its meta.json replaced and (below)
    # its recordings pruned. Views mark themselves in meta.json.
    meta_path = bundle_root / "meta.json"
    if meta_path.is_file():
        try:
            existing = json.loads(meta_path.read_text())
        except (OSError, ValueError):
            existing = None
        if not (isinstance(existing, dict) and existing.get("view")):
            raise ValueError(
                f"{bundle_root} already holds a bundle that is not a batch "
                "view - refusing to overwrite it; choose an empty --output"
            )
    taps_dir = bundle_root / "taps"
    taps_dir.mkdir(parents=True, exist_ok=True)
    for name, src in zip(names, paths):
        dst = taps_dir / f"{name}.wav"
        target = src.resolve()
        if dst.is_symlink() or dst.exists():
            if dst.is_symlink() and dst.resolve() == target:
                continue  # already points at this input
            dst.unlink()
        try:
            dst.symlink_to(target)
        except OSError:
            shutil.copyfile(target, dst)

    # prune taps from a previous materialisation with a different input
    # set — a stale taps/<x>.wav that meta.json no longer lists would read
    # as a phantom tap to anything globbing the directory (and copy-mode
    # views would pile up full-size orphans)
    keep = {f"{name}.wav" for name in names}
    for leftover in taps_dir.glob("*.wav"):
        if leftover.name not in keep:
            leftover.unlink()

    meta = {
        "sample_rate_hz": int(rate),
        "length_samples": int(max(f for f, _r in frames_rates)),
        "taps": names,
        # marks this bundle as a materialised VIEW over external WAVs —
        # the overwrite guard above only ever replaces marked views
        "view": True,
    }
    (bundle_root / "meta.json").write_text(json.dumps(meta, indent=2) + "\n")
    return bundle_root


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def load_bundle_batch(
    bundle_root: str | Path,
    pad_multiple: int = 4096,
    num_threads: int = 8,
) -> Tuple[BundleMeta, np.ndarray, np.ndarray, List[str]]:
    """
    Load every tap of a bundle into one padded batch for the device engine.

    Returns:
      meta:     BundleMeta
      batch:    (B, C=2, N_max) float32, zero-padded past each tap's length
      lengths:  (B,) int32 valid sample counts
      names:    tap names in batch order

    N_max is rounded up to `pad_multiple` so repeated runs with slightly
    different tap lengths reuse the same compiled program.
    """
    bundle_root = Path(bundle_root)
    meta = read_bundle_meta(bundle_root)
    paths = [bundle_root / "taps" / f"{t}.wav" for t in meta.taps]

    if native.available():
        lengths = []
        for p in paths:
            frames, _, rate = native.read_wav_info(p)
            if rate != meta.sample_rate_hz:
                raise ValueError(f"Tap {p} sample rate {rate} != bundle {meta.sample_rate_hz}")
            lengths.append(frames)
        n_max = _round_up(max(lengths) if lengths else pad_multiple, pad_multiple)
        interleaved, length_arr = native.read_bundle(paths, n_max, 2, num_threads)
        batch = np.ascontiguousarray(np.transpose(interleaved, (0, 2, 1)))
        return meta, batch, length_arr.astype(np.int32), meta.taps

    # scipy fallback: sequential decode
    loaded = [
        load_wav_file(p, meta.sample_rate_hz, "stereo", allow_mono_and_upmix_to_stereo=True)
        for p in paths
    ]
    lengths = np.array([l.samples.shape[0] for l in loaded], dtype=np.int32)
    n_max = _round_up(int(lengths.max()) if len(loaded) else pad_multiple, pad_multiple)
    batch = np.zeros((len(loaded), 2, n_max), dtype=np.float32)
    for i, l in enumerate(loaded):
        batch[i, :, : l.samples.shape[0]] = l.samples.T
    return meta, batch, lengths, meta.taps


def load_bundle_batch_i16(
    bundle_root: str | Path,
    pad_multiple: int = 4096,
    num_threads: int = 8,
):
    """
    PCM16 fast path: (meta, (B, C=2, N_max) int16 batch, (B,) int32 lengths,
    names) with NO host float conversion — the engine scales by 1/32768 on
    the device, so host decode and the host->device transfer both move half
    the bytes of `load_bundle_batch`. Returns None when the native library
    is missing or any tap is not plain PCM16 (use the f32 loader then).
    """
    if not native.available():
        return None
    bundle_root = Path(bundle_root)
    meta = read_bundle_meta(bundle_root)
    paths = [bundle_root / "taps" / f"{t}.wav" for t in meta.taps]

    lengths = []
    for p in paths:
        frames, _, rate = native.read_wav_info(p)
        if rate != meta.sample_rate_hz:
            raise ValueError(f"Tap {p} sample rate {rate} != bundle {meta.sample_rate_hz}")
        lengths.append(frames)
    n_max = _round_up(max(lengths) if lengths else pad_multiple, pad_multiple)

    result = native.read_bundle_planar_i16(paths, n_max, 2, num_threads)
    if result is None:
        return None
    batch_i16, length_arr = result
    return meta, batch_i16, length_arr.astype(np.int32), meta.taps


def open_bundle_chunks_i16(
    bundle_root: str | Path,
    pad_multiple: int = 4096,
    num_threads: int = 8,
):
    """
    Chunked PCM16 fast path for pipelined decode: returns
    (meta, lengths (B,) int32, names, n_max, loader) where loader(lo, hi)
    decodes taps [lo, hi) into a planar (hi-lo, 2, n_max) int16 chunk with
    the native threaded decoder. Header-probes every tap up front (cheap) so
    the padded shape is fixed — and every tap's format is vetted as plain
    PCM16 — before any PCM is read; callers can then decode chunk k+1 on a
    worker thread while chunk k is uploading/dispatching. Returns None when
    the native library is missing or ANY tap is not plain PCM16 (use the
    batch loaders then), so a mixed-format bundle can never raise
    mid-pipeline from loader().
    """
    if not native.available():
        return None
    bundle_root = Path(bundle_root)
    meta = read_bundle_meta(bundle_root)
    paths = [bundle_root / "taps" / f"{t}.wav" for t in meta.taps]

    lengths = []
    for p in paths:
        frames, _, rate = native.read_wav_info(p)
        if rate != meta.sample_rate_hz:
            raise ValueError(f"Tap {p} sample rate {rate} != bundle {meta.sample_rate_hz}")
        lengths.append(frames)
    n_max = _round_up(max(lengths) if lengths else pad_multiple, pad_multiple)

    def loader(lo: int, hi: int):
        result = native.read_bundle_planar_i16(paths[lo:hi], n_max, 2, num_threads)
        if result is None:
            raise IOError(
                f"Bundle taps [{lo}:{hi}) are not plain PCM16; "
                "use load_bundle_batch instead"
            )
        chunk_i16, _chunk_lengths = result
        return chunk_i16

    # header-only format vet of EVERY tap, so a mixed-format bundle (first
    # tap PCM16, later tap float) falls back to the f32 batch loader up
    # front instead of raising from loader() mid-pipeline
    if not all(wav_is_plain_pcm16(p) for p in paths):
        return None

    return meta, np.asarray(lengths, np.int32), meta.taps, n_max, loader
