"""
Batched STFT magnitude — the single shared time-frequency kernel.

The reference re-implements a frame-by-frame Python-loop STFT in three
modules and recomputes it three times per report (spectrogram.py:107-160,
waterfall.py:188-230, modalcloud.py:121-158). Here framing is one gather,
the FFT is one batched rfft over every (tap, channel, frame) at once, and
spectrogram / waterfall / modal cloud all consume the same array.

Conventions match the reference: "valid" framing T = 1 + (N - n_fft)//hop,
symmetric Hann window, magnitude floored before dB, frame times at the
window start.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from audio_analysis_tpu.ops.common import db_from_magnitude


class StftResult(NamedTuple):
    mag_db: jnp.ndarray  # (..., T, F) float32, dB
    num_frames: jnp.ndarray  # (...,) int32 frames fully inside the valid length
    # Static helpers (host-known): frame count T and bin count F are shapes.


class StftLinearResult(NamedTuple):
    mag: jnp.ndarray  # (..., T, F) float32, LINEAR magnitude (not dB)
    num_frames: jnp.ndarray  # (...,) int32 frames fully inside the valid length


def num_frames_static(n: int, n_fft: int, hop: int) -> int:
    if n < n_fft:
        return 0
    return 1 + (n - n_fft) // hop


def frame_signal(x: jnp.ndarray, n_fft: int, hop: int) -> jnp.ndarray:
    """
    (..., N) -> (..., T, n_fft) "valid" framing.

    When hop divides n_fft (all the framework defaults: 4096/512,
    8192/512, diffusion 2400/480...) the frame matrix is assembled from
    n_fft//hop shifted reshapes — static slices + reshapes that XLA turns
    into contiguous copies. frame[k] = concat_j x[(k+j)*hop : (k+j+1)*hop].
    Other hops fall back to a generic (T, n_fft) index gather.
    """
    n = x.shape[-1]
    t = num_frames_static(n, n_fft, hop)
    if t <= 0:
        return jnp.zeros(x.shape[:-1] + (0, n_fft), x.dtype)

    if n_fft % hop == 0:
        factor = n_fft // hop
        parts = []
        for j in range(factor):
            seg = jax.lax.slice_in_dim(x, j * hop, j * hop + t * hop, axis=-1)
            parts.append(seg.reshape(x.shape[:-1] + (t, hop)))
        return jnp.concatenate(parts, axis=-1)

    starts = jnp.arange(t, dtype=jnp.int32) * hop
    idx = starts[:, None] + jnp.arange(n_fft, dtype=jnp.int32)[None, :]
    return jnp.take(x, idx, axis=-1)


def hann_window(n_fft: int) -> np.ndarray:
    """Symmetric Hann, identical to np.hanning(n_fft)."""
    return np.hanning(n_fft).astype(np.float32)


def _frame_rfft(
    frames: jnp.ndarray,
    fft_impl: str,
    k_out: int | None = None,
    fft_n1: int | None = None,
    fft_precision: "str | None" = None,
) -> jnp.ndarray:
    """rfft over the last axis; "mx" = matmul-factored FFT (ops/mxfft.py),
    "xla" = jnp.fft.
    `k_out` keeps only the first k_out bins (the mx path skips computing the
    rest; the XLA path slices, which XLA fuses into the consumer); `fft_n1`
    overrides the mx stage split (ignored by the XLA path). The mx
    factorisation needs a power-of-two length; any other n_fft (legal at the
    CLI, e.g. --n_fft 3000 — the reference accepts arbitrary sizes) falls
    back to the XLA FFT instead of raising."""
    n = int(frames.shape[-1])
    if fft_impl == "mx" and n >= 2 and (n & (n - 1)) == 0:
        from audio_analysis_tpu.ops.mxfft import rfft_mx

        return rfft_mx(frames, k_out=k_out, n1=fft_n1, precision=fft_precision)
    spec = jnp.fft.rfft(frames, axis=-1)
    return spec if k_out is None else spec[..., :k_out]


def _linear_magnitude(
    x: jnp.ndarray,
    n_fft: int,
    hop: int,
    use_hann_window: bool,
    fft_impl: str,
    k_out: int | None = None,
    fft_n1: int | None = None,
    fft_precision: "str | None" = None,
) -> jnp.ndarray:
    """Un-floored |STFT| via the selected implementation."""
    window = jnp.asarray(hann_window(n_fft)) if use_hann_window else jnp.ones(
        (n_fft,), dtype=jnp.float32
    )
    frames = frame_signal(x, n_fft, hop) * window
    return jnp.abs(
        _frame_rfft(frames, fft_impl, k_out, fft_n1, fft_precision)
    ).astype(jnp.float32)


@partial(
    jax.jit,
    static_argnames=(
        "n_fft", "hop", "use_hann_window", "floor_lin", "fft_impl", "k_out",
        "fft_n1", "fft_precision",
    ),
)
def stft_magnitude(
    x: jnp.ndarray,
    length: jnp.ndarray,
    n_fft: int,
    hop: int,
    use_hann_window: bool = True,
    floor_lin: float = 0.0,
    fft_impl: str = "xla",
    k_out: int | None = None,
    fft_n1: int | None = None,
    fft_precision: "str | None" = None,
) -> StftLinearResult:
    """
    Linear-magnitude STFT: |rfft(window * frame)| floored at `floor_lin`,
    invalid frames zeroed. Consumers that aggregate in linear magnitude
    (modal cloud bin means, modalcloud.py:193-205) use this directly and
    convert to dB once after aggregation — skipping two transcendental
    passes over the full (T, F) plane. `k_out` returns only the first k_out
    bins (consumers with an f_max cut skip the work above it).
    """
    mag = jnp.maximum(
        _linear_magnitude(
            x, n_fft, hop, use_hann_window, fft_impl, k_out, fft_n1, fft_precision
        ),
        floor_lin,
    )

    t = mag.shape[-2]
    frame_valid = jnp.arange(t, dtype=jnp.int32) * hop + n_fft <= length[..., None]
    mag = jnp.where(frame_valid[..., None], mag, 0.0)
    num_frames = jnp.sum(frame_valid, axis=-1).astype(jnp.int32)
    return StftLinearResult(mag, num_frames)


@partial(
    jax.jit,
    static_argnames=("n_fft", "hop", "use_hann_window", "floor_db", "fft_impl"),
)
def stft_mag_db(
    x: jnp.ndarray,
    length: jnp.ndarray,
    n_fft: int,
    hop: int,
    use_hann_window: bool = True,
    floor_db: float = -120.0,
    fft_impl: str = "xla",
) -> StftResult:
    """
    x: (..., N) analysis segment starting at index 0, zeros past `length`.
    Returns mag_db (..., T, F) where frames beyond the valid region are set
    to floor_db, plus the per-element valid frame count
    (= 1 + (length - n_fft)//hop, clipped at 0).
    """
    mag_db = db_from_magnitude(
        _linear_magnitude(x, n_fft, hop, use_hann_window, fft_impl), floor_db
    )

    t = mag_db.shape[-2]
    frame_valid = (
        jnp.arange(t, dtype=jnp.int32) * hop + n_fft <= length[..., None]
    )
    mag_db = jnp.where(frame_valid[..., None], mag_db, floor_db)

    num_frames = jnp.sum(frame_valid, axis=-1).astype(jnp.int32)
    return StftResult(mag_db, num_frames)


def frame_times_seconds(t: int, hop: int, sample_rate_hz: int) -> np.ndarray:
    """Host-side frame-start times (spectrogram.py:158)."""
    return (np.arange(t, dtype=np.float32) * hop / float(sample_rate_hz)).astype(np.float32)


def rfft_freqs_hz(n_fft: int, sample_rate_hz: int) -> np.ndarray:
    return np.fft.rfftfreq(n_fft, d=1.0 / float(sample_rate_hz)).astype(np.float32)
