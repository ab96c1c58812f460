"""
JAX (device-side) signal generation.

- karplus_strong_scan: the reference's per-sample Python feedback loop
  (signals.py:575-596) as a jit-compiled lax.scan carrying the delay-line
  buffer. Same recurrence, compiled once, runs on any JAX backend.
- log_sine_sweep: jit, elementwise exponential phase — batched via vmap.
- synthetic_reverb_ir_batch: device-generated batch of exponentially
  decaying noise IRs with frequency-dependent decay, used by the bench and
  golden tests (analytically known RT60 per band).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("total_samples",))
def _ks_scan(
    initial_delay_line: jax.Array,  # (delay_len,) or (B, delay_len)
    total_samples: int,
    feedback_decay_factor: jax.Array,
    lowpass_blend: jax.Array,
) -> jax.Array:
    delay_len = initial_delay_line.shape[-1]

    def step(carry, _):
        buffer, read_index, prev = carry
        cur = buffer[..., read_index]
        two_point_average = 0.5 * (prev + cur)
        filtered = (1.0 - lowpass_blend) * cur + lowpass_blend * two_point_average
        nxt = feedback_decay_factor * filtered
        buffer = buffer.at[..., read_index].set(nxt)
        read_index = jnp.where(read_index + 1 >= delay_len, 0, read_index + 1)
        return (buffer, read_index, cur), cur

    init = (
        initial_delay_line.astype(jnp.float32),
        jnp.array(0, dtype=jnp.int32),
        initial_delay_line[..., -1].astype(jnp.float32),
    )
    _, out = jax.lax.scan(step, init, None, length=total_samples)
    return out  # (total_samples,) or (total_samples, B)


def karplus_strong_batch(
    initial_delay_lines: np.ndarray,  # (B, delay_len)
    total_samples: int,
    feedback_decay_factor: float,
    lowpass_blend: float,
) -> np.ndarray:
    """
    A whole ensemble of same-pitch Karplus–Strong strings at once: the scan
    carries a (B, delay_len) buffer so every string advances per step on the
    VPU — the batch dimension is free (the reference's per-sample Python
    loop runs one string at a time, signals.py:575-596).
    """
    out = _ks_scan(
        jnp.asarray(initial_delay_lines, dtype=jnp.float32),
        int(total_samples),
        jnp.float32(feedback_decay_factor),
        jnp.float32(lowpass_blend),
    )
    return np.asarray(out, dtype=np.float32).T  # (B, total_samples)


def karplus_strong_scan(
    initial_delay_line: np.ndarray,
    total_samples: int,
    feedback_decay_factor: float,
    lowpass_blend: float,
) -> np.ndarray:
    """Run the Karplus–Strong recurrence for `total_samples` outputs."""
    out = _ks_scan(
        jnp.asarray(initial_delay_line, dtype=jnp.float32),
        int(total_samples),
        jnp.float32(feedback_decay_factor),
        jnp.float32(lowpass_blend),
    )
    return np.asarray(out, dtype=np.float32)


@partial(jax.jit, static_argnames=("num_samples", "sample_rate_hz"))
def log_sine_sweep(
    num_samples: int,
    sample_rate_hz: int,
    start_frequency_hz: jax.Array,
    end_frequency_hz: jax.Array,
    amplitude: jax.Array,
) -> jax.Array:
    """Exponential-phase log sweep (phase math as signals.py:413-425), f32."""
    t = jnp.arange(num_samples, dtype=jnp.float32) / float(sample_rate_hz)
    duration = num_samples / float(sample_rate_hz)
    c = duration / jnp.log(end_frequency_hz / start_frequency_hz)
    phase = 2.0 * jnp.pi * start_frequency_hz * c * (jnp.exp(t / c) - 1.0)
    return amplitude * jnp.sin(phase)


@partial(jax.jit, static_argnames=("batch", "num_samples", "sample_rate_hz"))
def synthetic_reverb_ir_batch(
    key: jax.Array,
    batch: int,
    num_samples: int,
    sample_rate_hz: int,
    rt60_low_s: jax.Array,
    rt60_high_s: jax.Array,
    crossover_hz: jax.Array = 2000.0,
    direct_peak: float = 1.0,
    onset_samples: int = 256,
) -> jax.Array:
    """
    Batch of synthetic stereo "verb" IRs with analytically known band RT60s.

    Each IR = direct impulse at `onset_samples` + noise tail whose low band
    decays with rt60_low_s and high band with rt60_high_s:
        envelope(t) = 10^(-3 t / RT60)   (=-60 dB at t = RT60)
    Returns (batch, 2, num_samples) float32.
    """
    t = jnp.arange(num_samples, dtype=jnp.float32) / float(sample_rate_hz)
    noise = jax.random.normal(key, (batch, 2, num_samples), dtype=jnp.float32)

    freqs = jnp.fft.rfftfreq(num_samples, d=1.0 / float(sample_rate_hz)).astype(jnp.float32)
    lowpass = 1.0 / (1.0 + (freqs / crossover_hz) ** 4)

    spec = jnp.fft.rfft(noise, axis=-1)
    low = jnp.fft.irfft(spec * lowpass, n=num_samples, axis=-1)
    high = noise - low

    env_low = 10.0 ** (-3.0 * t / rt60_low_s)
    env_high = 10.0 ** (-3.0 * t / rt60_high_s)
    tail = 0.05 * (low * env_low + high * env_high)

    onset = jnp.zeros((num_samples,), dtype=jnp.float32).at[onset_samples].set(direct_peak)
    ir = tail + onset[None, None, :]
    # Zero everything before the onset so trim-to-peak starts at the impulse.
    pre_mask = (jnp.arange(num_samples) >= onset_samples).astype(jnp.float32)
    return ir * pre_mask[None, None, :]
