"""
Shared glue for the single-file analysis path.

Signals are padded to a power-of-two "bucket" so repeated CLI runs over
different file lengths reuse the same compiled kernels (static shapes), and
per-sample validity travels as a length scalar (see ops.common).

`FileDsp` is the per-file device context: all channels of a file ride the
batch dim of one kernel dispatch, and alignment / STFT results (device and
host copies) are memoised so the report suite uploads the signal once and
computes each STFT exactly once per file — the reference re-reads the WAV
~10x and recomputes the STFT 3x per report (SURVEY §3.2; reference
spectrogram.py:146-155, waterfall.py:220-227, modalcloud.py:149-155).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from audio_analysis_tpu.io import get_analysis_channels, load_wav_file
from audio_analysis_tpu.ops import stft as stft_ops
from audio_analysis_tpu.ops import trim as trim_ops
from audio_analysis_tpu.ops.common import next_pow2

MIN_BUCKET = 4096


def pad_to_bucket(samples: np.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    (N,) float -> ((1, N_pad) device array, (1,) int32 length) with
    N_pad = next_pow2(N) (>= MIN_BUCKET).
    """
    x = np.asarray(samples, dtype=np.float32)
    n = x.shape[-1]
    n_pad = max(MIN_BUCKET, next_pow2(n))
    if n_pad != n:
        x = np.concatenate([x, np.zeros(n_pad - n, dtype=np.float32)])
    return jnp.asarray(x[None, :]), jnp.asarray(np.array([n], dtype=np.int32))


def load_channels(
    input_wav_file_path: str | Path,
    use_mono_downmix_for_stereo: bool,
) -> Tuple[List[Tuple[str, np.ndarray]], int]:
    """The shared load policy of every analysis module: mono_or_stereo, no upmix."""
    loaded = load_wav_file(
        wav_file_path=input_wav_file_path,
        expected_channel_mode="mono_or_stereo",
        allow_mono_and_upmix_to_stereo=False,
    )
    channels = get_analysis_channels(loaded, use_mono_downmix_for_stereo)
    return channels, loaded.sample_rate_hz


def suffixed_png(output_basename: str | Path, suffix: str) -> Path:
    """<basename><suffix>.png next to the basename (the PNG suffix contract)."""
    base = Path(output_basename)
    return base.with_name(f"{base.stem}{suffix}.png")


TrimKey = Tuple[bool, float, Optional[float]]


class FileDsp:
    """
    Device-side DSP context for one file's channels.

    - The padded (C, N_pad) signal is uploaded to the device ONCE.
    - `aligned(...)` memoises the trim/ignore/duration alignment per knob set.
    - `stft_db(...)` memoises the STFT per (alignment, n_fft, hop, window,
      floor) — so spectrogram + waterfall share one 4096-STFT and the modal
      cloud adds exactly one 8192-STFT per report.
    - `*_host(...)` memoise the device→host fetches (one packed transfer,
      both channels) — fetches dominate on a high-latency link.
    """

    def __init__(self, channels: List[Tuple[str, np.ndarray]], sample_rate_hz: int):
        if not channels:
            raise ValueError("FileDsp needs at least one channel.")
        self.channel_names: List[str] = [name for name, _ in channels]
        self.host_channels: List[np.ndarray] = [
            np.asarray(x, dtype=np.float32) for _, x in channels
        ]
        self.sample_rate_hz = int(sample_rate_hz)

        n_max = max(x.shape[-1] for x in self.host_channels)
        n_pad = max(MIN_BUCKET, next_pow2(n_max))
        stacked = np.zeros((len(self.host_channels), n_pad), np.float32)
        for i, x in enumerate(self.host_channels):
            stacked[i, : x.shape[-1]] = x
        self.x = jnp.asarray(stacked)  # (C, N_pad)
        self.lengths = jnp.asarray(
            np.array([x.shape[-1] for x in self.host_channels], np.int32)
        )

        self._aligned: Dict[TrimKey, trim_ops.AlignedSignal] = {}
        self._aligned_host: Dict[TrimKey, Tuple[np.ndarray, np.ndarray]] = {}
        self._stft: Dict[tuple, stft_ops.StftResult] = {}
        self._stft_host: Dict[tuple, Tuple[np.ndarray, np.ndarray]] = {}

    @classmethod
    def from_wav_file(
        cls, input_wav_file_path: str | Path, use_mono_downmix_for_stereo: bool
    ) -> "FileDsp":
        channels, sr = load_channels(input_wav_file_path, use_mono_downmix_for_stereo)
        return cls(channels, sr)

    @property
    def num_channels(self) -> int:
        return len(self.channel_names)

    @property
    def bucket_samples(self) -> int:
        return int(self.x.shape[-1])

    @staticmethod
    def _trim_key(
        trim_to_peak: bool,
        ignore_leading_seconds: float,
        analysis_duration_seconds: Optional[float],
    ) -> TrimKey:
        return (
            bool(trim_to_peak),
            float(ignore_leading_seconds),
            None if analysis_duration_seconds is None else float(analysis_duration_seconds),
        )

    def aligned(
        self,
        trim_to_peak: bool,
        ignore_leading_seconds: float,
        analysis_duration_seconds: Optional[float] = None,
    ) -> trim_ops.AlignedSignal:
        key = self._trim_key(trim_to_peak, ignore_leading_seconds, analysis_duration_seconds)
        if key not in self._aligned:
            self._aligned[key] = trim_ops.align_for_analysis(
                self.x, self.lengths, self.sample_rate_hz, key[0], key[1], key[2]
            )
        return self._aligned[key]

    def aligned_host_meta(
        self,
        trim_to_peak: bool,
        ignore_leading_seconds: float,
        analysis_duration_seconds: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(start_indices (C,), segment_lengths (C,)) as host int arrays."""
        key = self._trim_key(trim_to_peak, ignore_leading_seconds, analysis_duration_seconds)
        if key not in self._aligned_host:
            a = self.aligned(*key)
            self._aligned_host[key] = (
                np.asarray(a.start_index, np.int64),
                np.asarray(a.length, np.int64),
            )
        return self._aligned_host[key]

    def stft_db(
        self,
        trim_to_peak: bool,
        ignore_leading_seconds: float,
        analysis_duration_seconds: Optional[float],
        n_fft: int,
        hop_length: int,
        use_hann_window: bool,
        floor_db: float,
    ) -> stft_ops.StftResult:
        tkey = self._trim_key(trim_to_peak, ignore_leading_seconds, analysis_duration_seconds)
        key = (tkey, int(n_fft), int(hop_length), bool(use_hann_window), float(floor_db))
        if key not in self._stft:
            a = self.aligned(*tkey)
            # matmul-factored frame FFT (ops/mxfft), as in the engine's
            # STFT blocks; summaries stay within golden-test tolerance
            self._stft[key] = stft_ops.stft_mag_db(
                a.samples, a.length, key[1], key[2], key[3], key[4], fft_impl="mx"
            )
        return self._stft[key]

    def stft_db_host(
        self,
        trim_to_peak: bool,
        ignore_leading_seconds: float,
        analysis_duration_seconds: Optional[float],
        n_fft: int,
        hop_length: int,
        use_hann_window: bool,
        floor_db: float,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(mag_db (C, T, F), num_frames (C,)) fetched to host once."""
        tkey = self._trim_key(trim_to_peak, ignore_leading_seconds, analysis_duration_seconds)
        key = (tkey, int(n_fft), int(hop_length), bool(use_hann_window), float(floor_db))
        if key not in self._stft_host:
            r = self.stft_db(*tkey, key[1], key[2], key[3], key[4])
            # dB planes cross the device->host link as int16 fixed-point
            # (1/128 dB steps, exact to +-0.004 dB over a +-256 dB range):
            # the (C, T, F) plane is ~33 MB in f32 and the dev link runs
            # ~35 MB/s on fetch, so halving the bytes halves the per-tap
            # spectrogram/waterfall wall time. Quantisation is far below
            # every summary/plot precision (values print at 0.1 dB).
            q = fetch_db_plane_i16(r.mag_db)
            self._stft_host[key] = (q, np.asarray(r.num_frames, np.int64))
        return self._stft_host[key]


def fetch_db_plane_i16(mag_db) -> np.ndarray:
    """Fetch a device dB plane as 1/128-dB int16 fixed point, dequantised to
    float32 on host — half the link bytes, exact to ±1/256 dB. The format is
    ops.display's shared quantise/dequantise pair so every dB-plane path
    crosses the link with an identical contract."""
    from audio_analysis_tpu.ops.display import dequantize_db_i16, quantize_db_i16

    return dequantize_db_i16(quantize_db_i16(mag_db))


def host_aligned_segments(
    dsp: FileDsp,
    trim_to_peak: bool,
    ignore_leading_seconds: float,
    analysis_duration_seconds: Optional[float] = None,
) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """
    Per-channel EXACT-length trimmed segments as float64 host arrays (plus
    starts, lengths). The `exact_grid` fallbacks (fr/filter/gd) use these to
    run the reference's exact segment-length FFT grid on the host, for
    byte-level cross-tool diffing (frequency_response.py:216-218,
    group_delay.py:103-105).
    """
    starts, seg_lens = dsp.aligned_host_meta(
        trim_to_peak, ignore_leading_seconds, analysis_duration_seconds
    )
    segments = [
        np.asarray(ch[int(s) : int(s) + int(l)], np.float64)
        for ch, s, l in zip(dsp.host_channels, starts, seg_lens)
    ]
    return segments, starts, seg_lens


def single_channel_dsp(samples: np.ndarray, sample_rate_hz: int, channel_name: str) -> FileDsp:
    """1-channel FileDsp for the per-channel parity APIs."""
    samples = np.asarray(samples)
    if samples.ndim != 1:
        raise ValueError(f"expected a 1D mono array for channel '{channel_name}'.")
    return FileDsp([(str(channel_name), samples)], sample_rate_hz)
