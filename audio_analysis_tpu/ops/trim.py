"""
Analysis-time alignment: the jit-safe replacement for the reference's
`x = x[peak:]` / `x = x[ignore:]` / `x = x[:duration]` slicing policy that
every module re-implements (decay.py:135-147, frequency_response.py:185-199,
spectrogram.py:180-194, waterfall.py:358-372, modalcloud.py:298-312, ...).

Instead of slicing (data-dependent shapes), we gather the signal shifted so
the analysis start lands at index 0 of the same static buffer, and return
the new valid length. Samples past the valid length are zeroed.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from audio_analysis_tpu.ops.common import bool_valid_mask


class AlignedSignal(NamedTuple):
    samples: jnp.ndarray  # (..., N) analysis segment at index 0, zero past length
    length: jnp.ndarray  # (...,) int32 valid samples of the segment
    start_index: jnp.ndarray  # (...,) int32 offset into the original signal


@jax.jit
def peak_index(x: jnp.ndarray, length: jnp.ndarray) -> jnp.ndarray:
    """Index of the absolute peak within the valid prefix (int32, per batch el)."""
    mask = bool_valid_mask(x.shape[-1], length)
    mag = jnp.where(mask, jnp.abs(x), -1.0)
    return jnp.argmax(mag, axis=-1).astype(jnp.int32)


@jax.jit
def shift_bands_to(
    x: jnp.ndarray, start: jnp.ndarray, length: jnp.ndarray
) -> AlignedSignal:
    """`shift_to` over a (..., bands, N) plane with per-(...) start/length
    shared across the bands axis. The broadcast happens INSIDE the program
    (bare `jnp.broadcast_to` glue at call sites dispatched tiny eager
    programs — each a separate compile)."""
    start_b = jnp.broadcast_to(start[..., None], x.shape[:-1])
    length_b = jnp.broadcast_to(length[..., None], x.shape[:-1])
    return shift_to(x, start_b, length_b)


@jax.jit
def shift_to(x: jnp.ndarray, start: jnp.ndarray, length: jnp.ndarray) -> AlignedSignal:
    """
    Shift x so original index `start` lands at 0. `start` and `length`
    broadcast over batch dims; out-of-range positions read zero.

    Implemented as one contiguous `lax.dynamic_slice` per batch row from a
    zero-extended buffer — a plain copy rather than a generic element
    gather over ~10^6 indices (which is faster on the current card is
    ROADMAP queue 1 item 7). The rows ride a `lax.scan` so the trace holds exactly
    ONE slice op regardless of batch size (an unrolled per-row Python loop
    made compile time grow linearly with taps x channels x bands).
    """
    n = x.shape[-1]
    batch_shape = x.shape[:-1]
    start_b = jnp.broadcast_to(jnp.asarray(start, jnp.int32), batch_shape)
    length_b = jnp.broadcast_to(jnp.asarray(length, jnp.int32), batch_shape)

    flat = x.reshape((-1, n))
    starts_flat = jnp.clip(start_b.reshape((-1,)), 0, n)
    padded = jnp.concatenate([flat, jnp.zeros_like(flat)], axis=-1)  # (R, 2N)

    def _slice_row(_, row_and_start):
        row, row_start = row_and_start
        return None, jax.lax.dynamic_slice(row, (row_start,), (n,))

    _, shifted = jax.lax.scan(_slice_row, None, (padded, starts_flat))
    shifted = shifted.reshape(x.shape)

    new_length = jnp.maximum(length_b - start_b, 0).astype(jnp.int32)
    mask = bool_valid_mask(n, new_length)
    return AlignedSignal(jnp.where(mask, shifted, 0.0), new_length, start_b)


@partial(jax.jit, static_argnames=("sample_rate_hz", "trim_to_peak", "ignore_leading_seconds", "analysis_duration_seconds"))
def align_for_analysis(
    x: jnp.ndarray,
    length: jnp.ndarray,
    sample_rate_hz: int,
    trim_to_peak: bool,
    ignore_leading_seconds: float,
    analysis_duration_seconds: Optional[float] = None,
) -> AlignedSignal:
    """
    Apply the reference's shared time-selection policy:
      1. optionally start at the absolute peak sample,
      2. skip `ignore_leading_seconds`,
      3. optionally keep only `analysis_duration_seconds`.

    `trim_to_peak`, `ignore_leading_seconds` and `analysis_duration_seconds`
    are static (they come from frozen settings dataclasses).
    """
    length = jnp.asarray(length, dtype=jnp.int32)
    n = x.shape[-1]

    if trim_to_peak:
        start = peak_index(x, length)
    else:
        start = jnp.zeros(length.shape, dtype=jnp.int32)

    ignore = int(round(float(ignore_leading_seconds) * float(sample_rate_hz)))
    if ignore > 0:
        start = jnp.minimum(start + ignore, length)

    aligned = shift_to(x, start, length)

    if analysis_duration_seconds is not None:
        keep = int(round(float(analysis_duration_seconds) * float(sample_rate_hz)))
        keep = max(0, min(keep, n))
        new_length = jnp.minimum(aligned.length, keep)
        mask = bool_valid_mask(n, new_length)
        aligned = AlignedSignal(
            jnp.where(mask, aligned.samples, 0.0), new_length, aligned.start_index
        )

    return aligned
