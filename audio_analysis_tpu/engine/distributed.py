"""
Multi-host bundle farms — the scale-out path beyond one host's cards.

Single-host multi-card scaling is engine.mesh (taps data-parallel over the
host's cards). For fleets of hosts, this module wires the standard JAX
multi-process setup: ONE process per host, owning all of that host's cards,
joined by `jax.distributed.initialize` over the coordination network; ONE
GLOBAL "taps" mesh spanning every card of the job (built from
`jax.devices()`, which is ordered by process); and per-process decode of
only the tap shard this host's devices own — the filesystem bundle contract
is the data plane, the network carries coordination plus the all-reduced
bundle aggregates.

Per-tap metrics are returned for the LOCAL shard (the caller writes its own
taps' reports); bundle aggregates are computed inside one jitted reduction
over the global sharded outputs, so they are genuinely all-reduced and
identical on every process.

Tested by tests/test_distributed_multihost.py with a real 2-process CPU
job (subprocess harness, local coordinator); reference analogue: none
(SURVEY §5 distributed row).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np


def initialize_multi_host(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """
    Join this process to a multi-host JAX job: one process per host, which
    owns all of that host's cards. Arguments default to the standard
    environment variables (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID). Outside a managed cluster JAX cannot detect the job,
    so give all three (the coordinator as host:port).
    """
    import jax

    kwargs = {}
    coordinator = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator:
        kwargs["coordinator_address"] = coordinator
    # NOT `x or env[...]`: process_id=0 (every job's first process) is falsy
    # and must not fall through to the env var
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    elif os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    elif os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(os.environ["JAX_PROCESS_ID"])

    jax.distributed.initialize(**kwargs)


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _tap_frame_count(path: Path, expected_rate_hz: int) -> int:
    """
    Frames in a tap WAV from the header only (native probe or pure-Python),
    validating the sample rate against the bundle's — every tap is probed on
    every process, so a wrong-rate tap raises identically on the native and
    load_wav_file decode branches (it would otherwise be silently analyzed
    at the bundle rate on the native fast path).
    """
    from audio_analysis_tpu.io import native
    from audio_analysis_tpu.io.wav import read_wav_header_info

    if native.available():
        frames, _, rate = native.read_wav_info(path)
    else:
        frames, _, rate = read_wav_header_info(path)
    if rate != expected_rate_hz:
        raise ValueError(f"Tap {path} sample rate {rate} != bundle {expected_rate_hz}")
    return int(frames)


def _bundle_aggregates(t30_rt60, t30_ok, early10_time, early10_ok, valid_rows):
    """Global nan-masked reductions; padded rows excluded via valid_rows."""
    import jax.numpy as jnp

    row_valid = valid_rows[:, None]
    t30 = jnp.where(t30_ok & row_valid, t30_rt60, jnp.nan)
    early = jnp.where(early10_ok & row_valid, early10_time, jnp.nan)
    return {
        "bundle_median_t30": jnp.nanmedian(t30),
        "bundle_mean_early10": jnp.nanmean(early),
        "bundle_valid_taps": jnp.sum(jnp.any(t30_ok & row_valid, axis=-1)),
    }


def analyze_bundle_multi_host(
    bundle_root: str | Path,
    config=None,
    devices: Optional[Sequence] = None,
    pad_multiple: int = 4096,
    gather_global: bool = False,
) -> Dict[str, object]:
    """
    Analyse a bundle across every process of an initialized multi-host job.

    Taps are assigned in contiguous blocks to the devices of the global
    "taps" mesh (jax.devices() order — sorted by owning process), so each
    host decodes exactly the taps its local devices analyse. The global
    batch is assembled with `jax.make_array_from_process_local_data`, the
    fused engine runs under the cached sharded step, and aggregates are one
    jitted global reduction (replicated → identical on every process).

    Returns per-tap metrics for this process's taps (key "local_tap_names"
    lists them, metric arrays are row-aligned to it) plus the global
    `bundle_*` aggregate scalars.
    """
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from audio_analysis_tpu.engine.batch import EngineConfig
    from audio_analysis_tpu.engine.mesh import sharded_step
    from audio_analysis_tpu.io.bundle import read_bundle_meta
    from audio_analysis_tpu.io.wav import load_wav_file

    if config is None:
        config = EngineConfig()

    bundle_root = Path(bundle_root)
    process_id = jax.process_index()

    device_list = list(devices) if devices is not None else list(jax.devices())
    mesh = Mesh(np.array(device_list), axis_names=("taps",))
    n_dev = len(device_list)

    meta = read_bundle_meta(bundle_root)
    if config.sample_rate_hz != meta.sample_rate_hz:
        config = dataclasses.replace(config, sample_rate_hz=meta.sample_rate_hz)
    names = meta.taps
    b = len(names)
    if b == 0:
        raise ValueError(f"Bundle {bundle_root} has no taps.")
    b_pad = _round_up(b, n_dev)
    per_dev = b_pad // n_dev

    # Globally-consistent padded length from headers only (no decode).
    tap_paths = [bundle_root / "taps" / f"{t}.wav" for t in names]
    n_max = _round_up(
        max(_tap_frame_count(p, meta.sample_rate_hz) for p in tap_paths), pad_multiple
    )

    # Contiguous tap blocks per device; this process owns its devices' rows.
    my_rows = [
        row
        for d_idx, d in enumerate(device_list)
        if d.process_index == process_id
        for row in range(d_idx * per_dev, (d_idx + 1) * per_dev)
    ]
    local_names = [names[row] for row in my_rows if row < b]

    # Padded rows replay an earlier tap so every shard runs real data;
    # they are excluded from outputs and aggregates via local_valid.
    from audio_analysis_tpu.io import native

    my_paths = [tap_paths[row % b] for row in my_rows]
    local_valid = np.array([row < b for row in my_rows], bool)
    if native.available():
        interleaved, length_arr = native.read_bundle(my_paths, n_max, 2)
        local_batch = np.ascontiguousarray(np.transpose(interleaved, (0, 2, 1)))
        local_lengths = length_arr.astype(np.int32)
    else:
        local_batch = np.zeros((len(my_rows), 2, n_max), np.float32)
        local_lengths = np.zeros((len(my_rows),), np.int32)
        for out_row, path in enumerate(my_paths):
            loaded = load_wav_file(
                path,
                meta.sample_rate_hz,
                "stereo",
                allow_mono_and_upmix_to_stereo=True,
            )
            n = loaded.samples.shape[0]
            local_batch[out_row, :, :n] = loaded.samples.T
            local_lengths[out_row] = n

    data_sh = NamedSharding(mesh, P("taps", None, None))
    row_sh = NamedSharding(mesh, P("taps"))
    samples = jax.make_array_from_process_local_data(data_sh, local_batch, (b_pad, 2, n_max))
    lengths = jax.make_array_from_process_local_data(row_sh, local_lengths, (b_pad,))
    valid = jax.make_array_from_process_local_data(row_sh, local_valid, (b_pad,))

    out = sharded_step(mesh, config)(samples, lengths)

    agg = jax.jit(_bundle_aggregates)(
        out["t30_rt60"], out["t30_ok"], out["early10_time"], out["early10_ok"], valid
    )

    n_local_real = len(local_names)

    def _local_rows(v) -> np.ndarray:
        shards = sorted(v.addressable_shards, key=lambda s: s.index[0].start or 0)
        stacked = np.concatenate([np.asarray(s.data) for s in shards], axis=0)
        return stacked[:n_local_real]

    result: Dict[str, object] = {k: _local_rows(v) for k, v in out.items()}
    result.update({k: np.asarray(v) for k, v in agg.items()})
    result["local_tap_names"] = local_names
    if gather_global:
        # replicate the (small) per-tap metric arrays to every process —
        # one compiled all-gather over the coordination network; process 0
        # uses this for the bundle-wide metrics dump + run comparison
        replicated = NamedSharding(mesh, P())
        gather = jax.jit(lambda tree: tree, out_shardings=replicated)
        result["global_metrics"] = {
            k: np.asarray(v)[:b] for k, v in gather(out).items()
        }
    return result


def run_bundle_report_multi_host(
    bundle_root: str | Path,
    config=None,
    reports_subdir: str = "reports",
    compare_to: Optional[str] = None,
    compare_threshold_pct: float = 1.0,
) -> Optional[Path]:
    """
    Multi-host engine bundle reports over a shared filesystem: every
    process analyses and writes `<reports>/<tap>/<tap>_report.md` for the
    taps its devices own; after a cross-host barrier, process 0 writes the
    bundle index with the all-reduced aggregates (plus, with `compare_to`,
    the same 'Changes vs previous' section and bundle_metrics.json dump as
    the single-host engine runner) and returns its path (other processes
    return None).
    """
    import json

    import jax

    from audio_analysis_tpu.report.engine_report import (
        _channel_names_from_output,
        format_tap_summary,
    )

    from audio_analysis_tpu.engine.batch import EngineConfig
    from audio_analysis_tpu.io.bundle import read_bundle_meta

    bundle_root = Path(bundle_root)
    meta = read_bundle_meta(bundle_root)  # one read; reused by the index below
    sr = meta.sample_rate_hz
    run_config = dataclasses.replace(
        config if config is not None else EngineConfig(), sample_rate_hz=sr
    )
    out = analyze_bundle_multi_host(bundle_root, run_config, gather_global=True)
    names = out["local_tap_names"]
    channel_names = _channel_names_from_output(out)

    reports_root = bundle_root / reports_subdir
    reports_root.mkdir(parents=True, exist_ok=True)
    for b, tap in enumerate(names):
        out_dir = reports_root / tap
        out_dir.mkdir(parents=True, exist_ok=True)
        body = format_tap_summary(out, b, channel_names, sr, run_config)
        header = (
            "# Offline Reverb Analysis Report (engine, multi-host)\n\n"
            f"**Tap:** `{tap}`  \n"
            f"**Analysed by process:** {jax.process_index()}  \n"
            f"**Sample rate:** {sr} Hz\n\n---\n\n"
        )
        (out_dir / f"{tap}_report.md").write_text(header + body)

    # Barrier: the index must not list reports other hosts haven't flushed.
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("bundle_reports_written")

    if jax.process_index() != 0:
        return None

    lines = [
        "# IR Bundle Report (engine, multi-host)\n",
        f"**Bundle:** `{bundle_root}`\n",
        f"**Sample rate:** {meta.sample_rate_hz}\n",
        f"**Taps:** {len(meta.taps)} over {jax.process_count()} process(es) / "
        f"{len(jax.devices())} device(s)\n",
        f"**bundle_median_t30:** {float(out['bundle_median_t30']):.4f} s  \n"
        f"**bundle_mean_early10:** {float(out['bundle_mean_early10']):.4f} s  \n"
        f"**bundle_valid_taps:** {int(out['bundle_valid_taps'])}\n",
        "\n## Taps\n",
    ]
    for tap in meta.taps:
        # relative to the index file, which already lives in reports_subdir
        lines.append(f"- [{tap}]({tap}/{tap}_report.md)")

    # same machine-readable dump + run comparison as the single-host
    # engine runner — the comparison reads the PREVIOUS file before this
    # run's dump overwrites it, so in-place comparison works here too
    metrics_json = {
        "taps": list(meta.taps),
        "channels": channel_names,
        "metrics": {k: np.asarray(v).tolist() for k, v in out["global_metrics"].items()},
    }
    if compare_to:
        from audio_analysis_tpu.report.compare import compare_section_for_index

        section = compare_section_for_index(metrics_json, compare_to, compare_threshold_pct)
    else:
        section = None
    (reports_root / "bundle_metrics.json").write_text(json.dumps(metrics_json, indent=1))
    if section:
        lines.append(section)

    index_path = reports_root / "bundle_report.md"
    index_path.write_text("\n".join(lines) + "\n")
    return index_path
