"""Sort-free exact percentiles (ops/selectq.py) vs np.nanpercentile.

CPU-pinned pure-numerics checks (speed is benchmarked on the card, not
unit-tested here).
"""

import jax
import jax.numpy as jnp
import numpy as np

from audio_analysis_tpu.ops.selectq import masked_percentiles

QS = (10.0, 50.0, 90.0)


def _run(x, valid):
    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(masked_percentiles(jnp.asarray(x), jnp.asarray(valid), QS))


def _ref(x, valid):
    out = np.full(x.shape[:-1] + (len(QS),), np.nan, np.float64)
    for idx in np.ndindex(x.shape[:-1]):
        vals = x[idx][valid[idx]].astype(np.float64)
        vals = vals[np.isfinite(vals)]
        if vals.size:
            out[idx] = np.percentile(vals, QS)
    return out


def test_matches_numpy_random_rows():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 3, 257)).astype(np.float32) * 100.0
    valid = rng.random((5, 3, 257)) > 0.3
    got = _run(x, valid)
    ref = _ref(x, valid)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)


def test_negative_zero_and_extremes():
    # (note: interpolated results that land in f32-subnormal territory
    # flush to zero on XLA backends — keep magnitudes normal)
    x = np.array(
        [[-np.inf, -1e30, -0.0, 0.0, 1e-30, 1e30, np.inf, 5.0]], np.float32
    )
    valid = np.ones_like(x, bool)
    got = _run(x, valid)
    ref = _ref(x, valid)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_nan_and_empty_rows():
    x = np.array(
        [
            [1.0, np.nan, 3.0, 2.0],
            [np.nan, np.nan, np.nan, np.nan],
            [7.0, 7.0, 7.0, 7.0],
        ],
        np.float32,
    )
    valid = np.array(
        [
            [True, True, True, True],
            [True, True, True, True],
            [True, True, False, True],
        ]
    )
    got = _run(x, valid)
    np.testing.assert_allclose(got[0], np.percentile([1.0, 3.0, 2.0], QS), rtol=1e-6)
    assert np.all(np.isnan(got[1]))
    np.testing.assert_allclose(got[2], [7.0, 7.0, 7.0], rtol=0)


def test_exact_order_statistics_duplicates():
    rng = np.random.default_rng(1)
    x = rng.integers(-5, 5, size=(4, 1000)).astype(np.float32)
    valid = np.ones_like(x, bool)
    got = _run(x, valid)
    ref = _ref(x, valid)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
