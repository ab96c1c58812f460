"""
Log-frequency resampling, smoothing and binning.

Covers the reference's duplicated log-frequency helpers:
- dB smoothing on a uniform log2(f) grid (frequency_response.py:117-169,
  waterfall.py:140-185): interp -> box average -> interp back, only inside
  [f_min, f_max];
- geometric log-bin aggregation by linear-magnitude mean
  (modalcloud.py:166-207), expressed as one (bins, F) matrix so the
  aggregation is a single matmul over all frames.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from audio_analysis_tpu.ops.common import box_smooth_same


# ----------------------------------------------------------------------------
# uniform log2(f) smoothing grid (host-side construction)
# ----------------------------------------------------------------------------


def log_grid_for_range(
    freqs_hz: np.ndarray,
    f_min_hz: float,
    f_max_hz: float,
    log_bins_per_octave: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """
    Returns (selection_mask (F,), grid_freqs_hz (G,)) for smoothing over
    [f_min, f_max]. Grid spans the first/last selected rfft bins with
    max(16, bins_per_octave) points per octave (+1 endpoint).
    """
    f_min = float(max(1.0, f_min_hz))
    f_max = float(max(f_min, f_max_hz))
    sel = (freqs_hz >= f_min) & (freqs_hz <= f_max)
    if not np.any(sel):
        return sel, np.zeros((0,), dtype=np.float64)
    f_sel = freqs_hz[sel].astype(np.float64)
    log2_min, log2_max = np.log2(f_sel[0]), np.log2(f_sel[-1])
    bins_per_oct = int(max(16, log_bins_per_octave))
    num = int(max(8, np.ceil((log2_max - log2_min) * bins_per_oct))) + 1
    grid = 2.0 ** np.linspace(log2_min, log2_max, num)
    return sel, grid


def smooth_mag_db_log_frequency(
    freqs_hz: np.ndarray,
    mag_db: jnp.ndarray,
    f_min_hz: float,
    f_max_hz: float,
    smoothing_log_bins: int,
    log_bins_per_octave: int,
) -> jnp.ndarray:
    """
    mag_db: (..., F). Smooth in dB on a uniform log2(f) grid inside
    [f_min, f_max]; everything outside the range is passed through.
    """
    if smoothing_log_bins <= 1:
        return mag_db

    sel, grid = log_grid_for_range(freqs_hz, f_min_hz, f_max_hz, log_bins_per_octave)
    if grid.size == 0:
        return mag_db

    f_sel = jnp.asarray(freqs_hz[sel].astype(np.float32))
    grid_j = jnp.asarray(grid.astype(np.float32))
    sel_idx = jnp.asarray(np.nonzero(sel)[0])

    def smooth_one(row: jnp.ndarray) -> jnp.ndarray:
        mag_sel = row[sel_idx]
        on_grid = jnp.interp(grid_j, f_sel, mag_sel)
        smoothed = box_smooth_same(on_grid, int(smoothing_log_bins))
        back = jnp.interp(f_sel, grid_j, smoothed)
        return row.at[sel_idx].set(back.astype(row.dtype))

    flat = mag_db.reshape((-1, mag_db.shape[-1]))
    out = jax.vmap(smooth_one)(flat)
    return out.reshape(mag_db.shape)


# ----------------------------------------------------------------------------
# geometric log bins (modal cloud)
# ----------------------------------------------------------------------------


def build_log_bin_edges(
    f_min_hz: float, f_max_hz: float, bins_per_octave: int, min_bins: int
) -> np.ndarray:
    """(B+1,) geometric edges: max(min_bins, ceil(octaves * bins/oct)) bins."""
    f_min = float(max(1.0, f_min_hz))
    f_max = float(max(f_min * 1.001, f_max_hz))
    octaves = float(np.log2(f_max / f_min))
    n = int(max(min_bins, np.ceil(octaves * float(max(4, bins_per_octave)))))
    return (f_min * 2.0 ** np.linspace(0.0, octaves, n + 1)).astype(np.float64)


def build_log_bin_matrix(
    freqs_hz: np.ndarray, edges_hz: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """
    Returns (centres (B,), A (B, F) row-normalised mean matrix,
    bin_nonempty (B,) bool). A @ mag_lin computes each bin's linear-magnitude
    mean over its rfft rows — one matmul replaces the per-bin Python loop
    (modalcloud.py:197-205).
    """
    centres = np.sqrt(edges_hz[:-1] * edges_hz[1:]).astype(np.float32)
    num_bins = centres.size
    a = np.zeros((num_bins, freqs_hz.size), dtype=np.float32)
    nonempty = np.zeros(num_bins, dtype=bool)
    for b in range(num_bins):
        sel = (freqs_hz >= edges_hz[b]) & (freqs_hz < edges_hz[b + 1])
        count = int(np.sum(sel))
        if count:
            a[b, sel] = 1.0 / count
            nonempty[b] = True
    return centres, a, nonempty


@jax.jit
def aggregate_db_to_log_bins(
    mag_db: jnp.ndarray, bin_matrix: jnp.ndarray
) -> jnp.ndarray:
    """
    mag_db: (..., T, F); bin_matrix: (B, F).
    dB -> linear magnitude -> per-bin mean (matmul) -> dB. Returns (..., B, T).
    """
    mag_lin = 10.0 ** (mag_db / 20.0)
    # (..., T, F) @ (F, B) -> (..., T, B)
    binned = jax.lax.dot_general(
        mag_lin,
        bin_matrix.T,
        dimension_numbers=(((mag_lin.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    binned = jnp.maximum(binned, 1e-30)
    return jnp.swapaxes(20.0 * jnp.log10(binned), -1, -2)
