"""
Shared kernel conventions.

Every op in this package is batched, mask-based and jit-safe:
- arrays carry leading batch dims and a static trailing length N (the padded
  "bucket" size); the true sample count travels alongside as an int32
  `length` array broadcastable over the batch dims;
- the reference's data-dependent slicing (x[peak:], x[:n], fit windows,
  decay.py:135-147/221-228) is replaced by alignment gathers + validity
  masks, so one compiled program serves every tap in a bundle.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnums=(0, 2))
def valid_mask(n: int, length: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """(..., n) mask: 1 where index < length."""
    idx = jnp.arange(n, dtype=jnp.int32)
    return (idx < length[..., None]).astype(dtype)


@partial(jax.jit, static_argnums=(0,))
def bool_valid_mask(n: int, length: jnp.ndarray) -> jnp.ndarray:
    idx = jnp.arange(n, dtype=jnp.int32)
    return idx < length[..., None]


@partial(jax.jit, static_argnums=(0,))
def hann_window_dynamic(n: int, length: jnp.ndarray) -> jnp.ndarray:
    """
    Symmetric Hann window of *runtime* length `length` laid out in a static
    (..., n) buffer: w[i] = 0.5 - 0.5 cos(2 pi i / (length - 1)) for i < length,
    0 beyond. Matches np.hanning(length) placed at the buffer start — this is
    how the reference windows a peak-trimmed segment (frequency_response.py:206-208)
    without the data-dependent shape.
    """
    idx = jnp.arange(n, dtype=jnp.float32)
    denom = jnp.maximum(length.astype(jnp.float32) - 1.0, 1.0)[..., None]
    w = 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * idx / denom)
    return jnp.where(idx < length[..., None], w, 0.0)


def next_pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def db_from_magnitude(mag: jnp.ndarray, floor_db: float) -> jnp.ndarray:
    """20 log10(max(mag, floor))."""
    floor_lin = 10.0 ** (floor_db / 20.0)
    return 20.0 * jnp.log10(jnp.maximum(mag, floor_lin))


def db_from_power(power: jnp.ndarray, eps: float) -> jnp.ndarray:
    """10 log10(max(power, eps))."""
    return 10.0 * jnp.log10(jnp.maximum(power, eps))


@partial(jax.jit, static_argnums=(1,))
def box_smooth_same(x: jnp.ndarray, window: int) -> jnp.ndarray:
    """Moving average matching np.convolve(x, ones(w)/w, mode="same")
    (reference decay.py:161-164): out-of-range samples count as zero, the
    kernel is centred with the extra tap on the left for even w. Shared by
    EDC smoothing, log-frequency smoothing and group-delay smoothing."""
    n = x.shape[-1]
    c = jnp.cumsum(x, axis=-1)
    c = jnp.concatenate([jnp.zeros_like(c[..., :1]), c], axis=-1)  # c[i] = sum x[:i]
    i = jnp.arange(n)
    hi = jnp.clip(i + (window - 1) // 2 + 1, 0, n)  # exclusive
    lo = jnp.clip(i + (window - 1) // 2 + 1 - window, 0, n)
    return (jnp.take(c, hi, axis=-1) - jnp.take(c, lo, axis=-1)) / float(window)
