"""
Modal-block kernel experiments (run on the accelerator).

Each variant times ONE candidate change against the current kernel on the
exact modal workload — (16, 2, 2^20) samples, 8192-point STFT at hop 512, log-binned
means, dB once:

  base        current engine kernel (rfft_mx 64x128, full 4097 bins)
  trim        rfft_mx k_out=3415 (bins above the 20 kHz f_max cut are
              zero-weight in the bin matrix; stop computing them)
  split128    rfft_mx n1=128 (unbalanced stage split)
  trim+split  both
  group2/4    lax.map batch grouping for the modal map (device memory vs
              fewer sequential sub-programs)

Timing: host clock around the call and a small scalar fetch, which waits
for the device to finish; best-of-N.
"""

from __future__ import annotations

import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from audio_analysis_tpu.engine import EngineConfig  # noqa: E402
from audio_analysis_tpu.engine.batch import _modal_bin_matrix  # noqa: E402
from audio_analysis_tpu.ops import mxfft, stft  # noqa: E402

CHUNK, C, N = 16, 2, 1 << 20
N_FFT, HOP = 8192, 512
REPEATS = 4

if "--small" in sys.argv:  # CPU smoke: correctness of every variant, not perf
    CHUNK, N, REPEATS = 2, 1 << 15, 1


def _modal_curves(samples, length, bin_matrix, *, k_out=None, n1=None, batch_size=1):
    """The modal_one kernel from engine/batch.py with variant knobs."""
    floor_lin = 10.0 ** (-120.0 / 20.0)
    window = jnp.asarray(stft.hann_window(N_FFT))

    def one(args):
        s1, l1 = args
        frames = stft.frame_signal(s1, N_FFT, HOP) * window
        spec = mxfft.rfft_mx(frames, k_out=k_out, n1=n1)
        mag = jnp.maximum(jnp.abs(spec).astype(jnp.float32), floor_lin)
        t = mag.shape[-2]
        valid = jnp.arange(t, dtype=jnp.int32) * HOP + N_FFT <= l1[..., None]
        mag = jnp.where(valid[..., None], mag, 0.0)
        nf = jnp.sum(valid, axis=-1).astype(jnp.int32)
        binned = jax.lax.dot_general(
            mag,
            bin_matrix.T,
            dimension_numbers=(((mag.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        curves = jnp.swapaxes(20.0 * jnp.log10(jnp.maximum(binned, 1e-30)), -1, -2)
        return curves, nf

    kwargs = {} if batch_size == 1 else {"batch_size": batch_size}
    return jax.lax.map(one, (samples, length), **kwargs)


def main():
    config = EngineConfig()
    centres, bin_matrix, _ = _modal_bin_matrix(config)
    kmax = int(np.max(np.nonzero(bin_matrix.any(axis=0))[0])) + 1
    print(f"bins={centres.size} kmax(nonzero bin col)={kmax} of {N_FFT // 2 + 1}")

    key = jax.random.PRNGKey(0)
    samples = 0.05 * jax.random.normal(key, (CHUNK, C, N), jnp.float32)
    samples = samples * jnp.exp(-jnp.arange(N) / 200_000.0)
    length = jnp.full((CHUNK,), N, jnp.int32)
    _ = float(samples[0, 0, 5])  # materialise before timing

    full_mat = jnp.asarray(bin_matrix)
    trim_mat = jnp.asarray(bin_matrix[:, :kmax])

    variants = {
        "base": dict(bin_matrix=full_mat),
        "trim": dict(bin_matrix=trim_mat, k_out=kmax),
        "split128": dict(bin_matrix=full_mat, n1=128),
        "trim+split": dict(bin_matrix=trim_mat, k_out=kmax, n1=128),
        "group2": dict(bin_matrix=full_mat, batch_size=2),
        "trim+split+g2": dict(bin_matrix=trim_mat, k_out=kmax, n1=128, batch_size=2),
    }

    base_curves = None
    for name, kw in variants.items():
        fn = jax.jit(partial(_modal_curves, **kw))
        curves, nf = fn(samples, length)  # compile + run
        _ = float(curves[0, 0, 0, 0])
        best = float("inf")
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            curves, nf = fn(samples, length)
            _ = float(jnp.sum(curves[..., ::97, ::31]))  # packed scalar-ish fetch
            best = min(best, time.perf_counter() - t0)
        if base_curves is None:
            base_curves = np.asarray(curves)
            err = 0.0
        else:
            err = float(np.nanmax(np.abs(np.asarray(curves) - base_curves)))
        print(f"{name:14s} {best * 1e3:8.1f} ms   max|dB diff vs base| {err:.2e}")


if __name__ == "__main__":
    main()
