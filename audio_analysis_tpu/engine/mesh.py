"""
Multi-chip scaling for the bundle engine.

The tap batch is the natural parallel axis (SURVEY §2: the reference's
sequential tap loop, bundle.py:56-68). The fused engine runs under
`shard_map` with taps sharded over the mesh (data parallel): each device
executes the identical local program on its tap shard, and the bundle-level
aggregate statistics are computed on the sharded outputs afterwards — XLA
inserts the all-reduces.

shard_map (rather than plain jit-with-shardings) is deliberate: the engine
is FFT-heavy, and explicit SPMD keeps every per-shard FFT in its default
layout (the XLA CPU backend rejects non-monotonic FFT layouts that GSPMD
propagation can otherwise introduce), and on an accelerator it guarantees
no accidental resharding inside the hot loop. The cards of one host are
joined all to all (NVLink on an H100 host), so the 1D mesh needs no
topology.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from audio_analysis_tpu.engine.batch import EngineConfig, analyze_batch


def make_mesh(num_devices: Optional[int] = None, platform: Optional[str] = None) -> Mesh:
    """
    1D "taps" mesh over the requested devices.

    `platform` can force e.g. "cpu" to build a virtual host mesh (the
    standard fake-multichip test setup); otherwise the default platform's
    devices are used. Raises when fewer than `num_devices` are available —
    never silently falls back to another platform.
    """
    pool = jax.devices(platform) if platform is not None else jax.devices()
    if num_devices is not None and len(pool) < num_devices:
        raise ValueError(
            f"Requested {num_devices} devices but only {len(pool)} "
            f"{pool[0].platform} device(s) are available"
        )
    devices = np.array(pool[: num_devices or len(pool)])
    return Mesh(devices, axis_names=("taps",))


def tap_sharding(mesh: Mesh) -> NamedSharding:
    """The (taps, channels, samples) data sharding for a 1D taps mesh."""
    return NamedSharding(mesh, P("taps", None, None))


def _pad_to_multiple(batch: np.ndarray, lengths: np.ndarray, multiple: int):
    b = batch.shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return batch, lengths, 0
    batch = np.concatenate([batch, np.tile(batch[:1], (pad, 1, 1))], axis=0)
    lengths = np.concatenate([lengths, np.tile(lengths[:1], pad)])
    return batch, lengths, pad


@lru_cache(maxsize=32)
def sharded_step(mesh: Mesh, config: EngineConfig):
    """
    jit(shard_map(analyze_batch)) memoised per (mesh, config).

    The jit wrapper must be reused across calls — rebuilding it per call
    discards jit's shape-keyed trace cache, retracing/recompiling every
    invocation. Both keys are hashable: Mesh by devices+axis names,
    EngineConfig is a frozen dataclass.
    """
    local_step = shard_map(
        partial(analyze_batch, config=config),
        mesh=mesh,
        in_specs=(P("taps", None, None), P("taps")),
        out_specs=P("taps"),
    )
    return jax.jit(local_step)


def analyze_batch_sharded(
    mesh: Mesh,
    batch: np.ndarray,
    lengths: np.ndarray,
    config: EngineConfig = EngineConfig(),
    include_bundle_aggregates: bool = True,
) -> Dict[str, jax.Array]:
    """
    Run the fused engine with the tap batch sharded over the mesh, plus
    bundle-level aggregates (cross-device reductions):
      bundle_median_t30, bundle_mean_early10, bundle_valid_taps.
    Padded taps (to make B divisible by the mesh) are trimmed from the
    per-tap outputs and excluded from aggregates.
    """
    n_shards = mesh.shape["taps"]
    len_sharding = NamedSharding(mesh, P("taps"))
    if isinstance(batch, jax.Array):
        # pre-sharded fast path: the caller already device_put the (padded)
        # chunk onto the tap sharding — e.g. analyze_bundle_pipelined's
        # worker thread, so uploads overlap compute and the per-chunk
        # device audio cache can hold sharded chunks. Used as-is.
        if batch.shape[0] % n_shards:
            raise ValueError(
                f"pre-sharded batch of {batch.shape[0]} taps not divisible "
                f"by mesh taps={n_shards}"
            )
        samples, pad = batch, 0
        lengths_dev = jax.device_put(np.asarray(lengths, np.int32), len_sharding)
    else:
        batch = np.asarray(batch)
        if batch.dtype != np.int16:  # int16 rides the link raw; engine converts
            batch = batch.astype(np.float32, copy=False)
        batch_p, lengths_p, pad = _pad_to_multiple(
            batch, np.asarray(lengths, np.int32), n_shards
        )

        data_sharding = NamedSharding(mesh, P("taps", None, None))
        # device_put the HOST arrays directly with the target sharding: an
        # intermediate jnp.asarray would first commit them to the default
        # device, making a virtual-CPU-mesh run depend on the default
        # backend.
        samples = jax.device_put(batch_p, data_sharding)
        lengths_dev = jax.device_put(lengths_p, len_sharding)

    out = sharded_step(mesh, config)(samples, lengths_dev)

    b = batch.shape[0]
    if pad:
        out = {k: v[:b] for k, v in out.items()}

    # Bundle-wide aggregates: reductions over the (sharded) tap axis. The
    # per-chunk flat path skips them (a nanmedian sort per chunk whose
    # result the caller recomputes host-side over the full bundle).
    if include_bundle_aggregates:
        t30 = jnp.where(out["t30_ok"], out["t30_rt60"], jnp.nan)
        out["bundle_median_t30"] = jnp.nanmedian(t30)
        out["bundle_mean_early10"] = jnp.nanmean(
            jnp.where(out["early10_ok"], out["early10_time"], jnp.nan)
        )
        out["bundle_valid_taps"] = jnp.sum(jnp.any(out["t30_ok"], axis=-1))
    return out


@jax.jit
def _pack_values(values):
    """Device-side flat pack of per-tap metric arrays (one fetch instead of
    one transfer per key per chunk)."""
    return jnp.concatenate([v.astype(jnp.float32).ravel() for v in values])


def analyze_batch_sharded_flat(
    mesh: Mesh,
    batch: np.ndarray,
    lengths: np.ndarray,
    config: EngineConfig = EngineConfig(),
) -> jax.Array:
    """
    Sharded engine chunk packed into one flat f32 vector, laid out exactly
    like engine.batch.analyze_batch_flat (sorted keys, raveled) so
    fetch_packed/unpack_flat reassemble it. The batch size must be a
    multiple of the mesh's taps axis (callers pad); bundle aggregates are
    not included (computed host-side over the full bundle).
    """
    if batch.shape[0] % mesh.shape["taps"]:
        raise ValueError(
            f"batch of {batch.shape[0]} taps not divisible by mesh "
            f"taps={mesh.shape['taps']} (pad the chunk)"
        )
    out = analyze_batch_sharded(
        mesh, batch, lengths, config, include_bundle_aggregates=False
    )
    keys = sorted(k for k in out if not k.startswith("bundle_"))
    return _pack_values(tuple(out[k] for k in keys))
