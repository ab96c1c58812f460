"""
Schroeder Energy Decay Curve — the core metric kernel.

Same math as the reference (decay.py:115-170): backwards-integrated energy,
epsilon floor, normalisation to 0 dB at the segment start, optional
dB-domain box smoothing, display floor. Batched over leading dims and
masked so one compiled program handles every (tap, channel, band).

The reversed cumulative sum accumulates tail-first (small -> large), the
numerically favourable order in float32. It is left to XLA on every
backend: on an H100 (700 W) a two-pass Pallas kernel ran the EDC alone
2.3x faster but cut the engine's chunk device time by only 0.3 %, so it
was not kept (PERF.md).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from audio_analysis_tpu.ops.common import bool_valid_mask, box_smooth_same, db_from_power


class EdcResult(NamedTuple):
    edc_db: jnp.ndarray  # (..., N): 0 dB at index 0, floored, 0 past length
    length: jnp.ndarray  # (...,) int32 valid curve samples


@partial(jax.jit, static_argnames=("edc_epsilon", "edc_floor_db", "smoothing_window_samples"))
def schroeder_edc_db(
    samples: jnp.ndarray,
    length: jnp.ndarray,
    edc_epsilon: float = 1e-20,
    edc_floor_db: float = -120.0,
    smoothing_window_samples: int = 0,
) -> EdcResult:
    """
    samples: (..., N) analysis segment starting at index 0 (see ops.trim),
             zero past `length`.
    Returns the EDC in dB with the same conventions as the reference.
    """
    mask = bool_valid_mask(samples.shape[-1], length)
    energy = jnp.where(mask, samples * samples, 0.0)

    # Backwards integration: reverse cumulative sum of energy.
    edc_linear = jnp.flip(jnp.cumsum(jnp.flip(energy, axis=-1), axis=-1), axis=-1)
    edc_linear = jnp.maximum(edc_linear, edc_epsilon)
    edc_linear = edc_linear / edc_linear[..., :1]

    edc_db = db_from_power(edc_linear, 0.0)

    if smoothing_window_samples and smoothing_window_samples > 1:
        edc_db = box_smooth_same(jnp.where(mask, edc_db, 0.0), int(smoothing_window_samples))

    edc_db = jnp.maximum(edc_db, edc_floor_db)
    return EdcResult(jnp.where(mask, edc_db, 0.0), length)
