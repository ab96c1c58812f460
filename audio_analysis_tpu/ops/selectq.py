"""
Sort-free exact percentiles: order statistics by binary search over
float bit patterns.

Why: `jnp.nanpercentile` sorts, and a sort over the group-delay block's
(rows, 2^19) bins was the block's entire cost on the accelerator this was
first built for (whether it still is on the current card is ROADMAP queue
1 item 7). An exact k-th order statistic needs no sort: map f32 to
its order-isomorphic uint32 image (the IEEE sign-magnitude flip), build
the k-th smallest key bit-by-bit from the MSB with one masked
`count < candidate` pass per bit, and map the two bracketing order
statistics back for numpy-style linear interpolation: 32 streaming passes
over device memory with no data-dependent layout, exact to the bit.

Matches np.nanpercentile(x[valid], q, interpolation="linear") — the
group_delay summary contract (group_delay.py:210-220) — with one documented
deviation: ±inf is excluded like NaN (np.nanpercentile keeps infinities as
extreme values). Group-delay values are always finite, so this never bites
the contract; excluding inf keeps the lo/hi interpolation free of inf-inf.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Plain Python ints, cast inside the jitted bodies: module-level jnp
# constants would initialise the default backend at import time and
# break device-free imports (tests/test_graft_entry.py).
_SIGN = 0x80000000
_INVALID = 0xFFFFFFFF  # sorts past every finite key (= NaN bits, excluded)


def _f32_to_ordered_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Monotonic bijection f32 -> uint32: a <= b  <=>  key(a) <= key(b)."""
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    sign = jnp.uint32(_SIGN)
    return jnp.where(bits >= sign, ~bits, bits | sign)


def _ordered_u32_to_f32(key: jnp.ndarray) -> jnp.ndarray:
    sign = jnp.uint32(_SIGN)
    bits = jnp.where(key >= sign, key ^ sign, ~key)
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def _kth_smallest(keys: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """
    Exact k-th smallest (0-based) of the uint32 `keys` along the last axis,
    batched over leading axes; `k` int32 with shape batch + (Q,) targets.
    Invalid elements must hold the _INVALID sentinel (k must stay below the
    per-row valid count).

    Invariant: `lo` is the largest prefix (remaining bits zero) with
    count(keys < lo) <= k. Descending all 32 bits leaves lo = the k-th
    smallest key. One count-pass per bit, no sort.
    """
    # initial carry derived from the inputs (not a fresh constant) so it
    # inherits their varying-manual-axes under shard_map — a plain
    # jnp.zeros carry fails the fori_loop carry-type check there
    lo = (keys[..., :1] & jnp.uint32(0)) + (k * 0).astype(jnp.uint32)

    def body(i, lo):
        bit = jnp.left_shift(jnp.uint32(1), jnp.uint32(31) - i.astype(jnp.uint32))
        mid = lo | bit  # bits are disjoint: no carries, no overflow
        below = (keys[..., None, :] < mid[..., :, None]).sum(axis=-1)
        # count(keys < mid) <= k  =>  the k-th smallest is >= mid: keep the bit
        return jnp.where(below <= k, mid, lo)

    return jax.lax.fori_loop(0, 32, body, lo)


@partial(jax.jit, static_argnames=("qs",))
def masked_percentiles(
    x: jnp.ndarray,
    valid: jnp.ndarray,
    qs: tuple,
) -> jnp.ndarray:
    """
    Exact percentiles of x[valid] along the last axis, batched over leading
    axes: (..., N) f32 + (..., N) bool -> (..., len(qs)) f32, matching
    np.percentile's linear interpolation. NaN elements are excluded like
    `valid`=False; rows with no valid element return NaN.
    """
    ok = valid & jnp.isfinite(x)
    keys = jnp.where(ok, _f32_to_ordered_u32(x), jnp.uint32(_INVALID))
    n_valid = ok.sum(axis=-1)  # (...,)

    qarr = jnp.asarray(qs, jnp.float32) / 100.0
    # fractional rank r = q*(n-1); order stats at floor(r) and ceil(r)
    r = qarr * jnp.maximum(n_valid[..., None] - 1, 0).astype(jnp.float32)
    k_lo = jnp.floor(r).astype(jnp.int32)
    k_hi = jnp.ceil(r).astype(jnp.int32)
    frac = r - k_lo.astype(jnp.float32)

    # one combined binary search over 2*Q targets
    k_all = jnp.concatenate([k_lo, k_hi], axis=-1)
    v_all = _ordered_u32_to_f32(_kth_smallest(keys, k_all))
    nq = len(qs)
    v_lo, v_hi = v_all[..., :nq], v_all[..., nq:]

    out = v_lo + frac * (v_hi - v_lo)
    return jnp.where(n_valid[..., None] > 0, out, jnp.nan)
