"""
Benchmark: batched IR analysis throughput (STFT + EDC + decay fits) on the
accelerator vs the float64 NumPy CPU reference implementation.

Workload: 64 stereo taps of 2^20 samples (~21.8 s @ 48 kHz) — the BASELINE
64-tap bundle shape. The device path is the fused engine
(one compiled program per tap chunk); the CPU baseline is the oracle
re-implementation of the reference algorithm (frame-loop STFT +
slice-based EDC/fits), measured on one tap and scaled (it is deterministic
per tap).

The workload is generated on-device (jax.random) so the measurement is the
analysis compute + the single packed metric fetch per chunk — matching the
deployment model where tap audio is already resident in device memory;
the upload-inclusive number is reported as an extra field.

Run it as the only process on the card. Prints ONE JSON line:
  {"metric": "irs_per_sec_stft_edc", "value": ..., "unit": "IR/s",
   "vs_baseline": <device_irs_per_sec / cpu_irs_per_sec>, ...extras}
"""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path

import numpy as np

SR = 48_000
BATCH = 64
NUM_SAMPLES = 1 << 20
CHUNK = 16
# timed sections repeat and report the best run
REPEATS = 3

# (chunks, lengths) of the device bench workload, reused by
# bench_sharded_overhead so the shard_map comparison runs on the exact
# same resident data
_BENCH_DEVICE_STATE = None


def _bench_config():
    from audio_analysis_tpu.engine import EngineConfig

    return EngineConfig(
        run_bands=False,
        run_fr=False,
        run_group_delay=False,
        run_modal=False,
        run_diffusion=False,
        run_stft=True,
    )


def bench_full_engine(chunks, lengths) -> float:
    """Wall-clock for the FULL engine (every report metric) over the bundle.

    Runs at half-chunks: the full config's modal 8192-FFT intermediates are
    the device-memory high-water mark.
    """
    from audio_analysis_tpu.engine import EngineConfig
    from audio_analysis_tpu.engine.batch import analyze_batch_flat, _flat_spec, fetch_packed

    config = EngineConfig()
    half = CHUNK // 2
    halves = []
    for ch in chunks:
        halves.append(ch[:half])
        halves.append(ch[half:])
    lengths_half = lengths[:half]
    spec = _flat_spec((half, 2, NUM_SAMPLES), (half,), config)
    _ = np.asarray(analyze_batch_flat(halves[0], lengths_half, config))  # compile

    best = float("inf")
    for _ in range(REPEATS):
        start = time.perf_counter()
        flats = [analyze_batch_flat(h, lengths_half, config) for h in halves]
        # ONE device->host fetch for every chunk
        results = fetch_packed(flats, spec)
        best = min(best, time.perf_counter() - start)
        assert all(np.all(r["t30_ok"]) for r in results)
    return best


def bench_device() -> dict:
    import jax
    import jax.numpy as jnp

    from audio_analysis_tpu.engine.batch import analyze_batch_flat, _flat_spec, fetch_packed
    from audio_analysis_tpu.signals.jaxgen import synthetic_reverb_ir_batch

    config = _bench_config()

    # Pre-generate every chunk on device (deterministic keys).
    lengths = jnp.full((CHUNK,), NUM_SAMPLES, jnp.int32)
    chunks = []
    for i in range(BATCH // CHUNK):
        key = jax.random.PRNGKey(i)
        ir = synthetic_reverb_ir_batch(
            key, CHUNK, NUM_SAMPLES, SR,
            rt60_low_s=jnp.float32(1.6), rt60_high_s=jnp.float32(0.9),
        )
        chunks.append(ir)
    # force materialisation of the generated data before timing
    for ch in chunks:
        _ = float(ch[0, 0, 300])
    global _BENCH_DEVICE_STATE
    _BENCH_DEVICE_STATE = (chunks, lengths)

    spec = _flat_spec((CHUNK, 2, NUM_SAMPLES), (CHUNK,), config)

    # warmup / compile
    _ = np.asarray(analyze_batch_flat(chunks[0], lengths, config))

    elapsed = float("inf")
    for _ in range(REPEATS):
        start = time.perf_counter()
        flats = [analyze_batch_flat(ch, lengths, config) for ch in chunks]
        # single packed fetch for all chunks
        results = fetch_packed(flats, spec)
        elapsed = min(elapsed, time.perf_counter() - start)

        ok = np.concatenate([r["t30_ok"] for r in results], axis=0)
        assert ok.shape[0] == BATCH
        assert np.all(ok), "bench workload must produce valid T30 fits"

    # upload-inclusive variant (one chunk, scaled) for reference
    host_chunk = np.asarray(chunks[0])
    start = time.perf_counter()
    _ = np.asarray(analyze_batch_flat(jnp.asarray(host_chunk), lengths, config))
    upload_elapsed = time.perf_counter() - start

    full_engine_seconds = bench_full_engine(chunks, lengths)

    return {
        "device_seconds": elapsed,
        "upload_inclusive_seconds_per_chunk": upload_elapsed,
        "full_engine_seconds": full_engine_seconds,
    }


def bench_sharded_overhead(chunks, lengths) -> dict:
    """
    shard_map overhead measured on a 1-device accelerator mesh at the
    bundle shape: multi-card scaling rests on jit(shard_map(analyze_batch))
    costing ~= the plain engine per shard (engine/mesh.py). Both sides run
    the FULL metric config, so the delta is the shard_map program structure
    alone. Data starts on device for both (the bundle pipeline keeps audio
    resident); one packed fetch each.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from audio_analysis_tpu.engine import EngineConfig, make_mesh
    from audio_analysis_tpu.engine.batch import (
        analyze_batch_flat,
        _flat_spec,
        fetch_packed,
    )
    from audio_analysis_tpu.engine.mesh import _pack_values, sharded_step

    half = CHUNK // 2
    halves = []
    for ch in chunks:
        halves.append(ch[:half])
        halves.append(ch[half:])
    lengths_half = lengths[:half]

    config = EngineConfig()
    spec = _flat_spec((half, 2, NUM_SAMPLES), (half,), config)

    # plain path, identical kernels
    _ = np.asarray(analyze_batch_flat(halves[0], lengths_half, config))  # compile
    plain = float("inf")
    for _ in range(REPEATS):
        start = time.perf_counter()
        flats = [analyze_batch_flat(h, lengths_half, config) for h in halves]
        results = fetch_packed(flats, spec)
        plain = min(plain, time.perf_counter() - start)
        assert all(np.all(r["t30_ok"]) for r in results)

    # sharded path on a 1-device mesh, data pre-placed on the sharding
    mesh = make_mesh(num_devices=1)
    data_sh = NamedSharding(mesh, P("taps", None, None))
    len_sh = NamedSharding(mesh, P("taps"))
    halves_sharded = [jax.device_put(h, data_sh) for h in halves]
    lengths_sharded = jax.device_put(lengths_half, len_sh)
    step = sharded_step(mesh, config)

    def sharded_flat(samples):
        out = step(samples, lengths_sharded)
        return _pack_values(tuple(out[k] for k in sorted(out)))

    _ = np.asarray(sharded_flat(halves_sharded[0]))  # compile
    sharded = float("inf")
    for _ in range(REPEATS):
        start = time.perf_counter()
        flats = [sharded_flat(h) for h in halves_sharded]
        results = fetch_packed(flats, spec)
        sharded = min(sharded, time.perf_counter() - start)
        assert all(np.all(r["t30_ok"]) for r in results)

    return {
        "plain_seconds": round(plain, 4),
        "sharded_seconds": round(sharded, 4),
        "overhead_pct": round(100.0 * (sharded / plain - 1.0), 2),
        "mesh_devices": 1,
        "backend": jax.devices()[0].platform,
    }


def bench_cpu_reference(taps: int = 5) -> float:
    """
    Per-tap seconds for the reference algorithm: the float64 NumPy oracle
    (single-threaded), averaged over `taps` distinct taps. Workload
    generation happens OUTSIDE the timed region, mirroring the device bench
    whose inputs are pre-generated.
    """
    from audio_analysis_tpu import oracle

    rng = np.random.default_rng(42)
    t = np.arange(NUM_SAMPLES) / SR
    env = (10.0 ** (-3.0 * t / 1.2)).astype(np.float32)
    workload = []
    for _ in range(taps):
        for _ch in range(2):
            x = (0.05 * rng.standard_normal(NUM_SAMPLES) * env).astype(np.float32)
            x[256] = 0.9
            workload.append(x.astype(np.float64))

    start = time.perf_counter()
    for xf in workload:
        tt, edc_db, _ = oracle.schroeder_edc_db(xf, SR)
        for rng_db in ((-5.0, -25.0), (-5.0, -35.0), (0.0, -10.0)):
            oracle.fit_decay_slope(tt, edc_db, rng_db)
        seg = xf[int(np.argmax(np.abs(xf))):]
        oracle.stft_magnitude_db(seg, SR, 4096, 512)
    return (time.perf_counter() - start) / taps


# ----------------------------------------------------------------------------
# end-to-end bundle benchmarks (SURVEY §7 "honest speed accounting": wall
# clock including WAV decode and markdown/plot output, on a real on-disk
# 64-tap bundle)
# ----------------------------------------------------------------------------

BUNDLE_DIR = str(Path(tempfile.gettempdir()) / "aa_bench_bundle_v1")
PLOT_TAPS = 8


def _bench_bundle_on_disk() -> str:
    """Deterministic 64-tap stereo bundle on disk (reused across runs)."""
    import shutil
    from pathlib import Path

    from audio_analysis_tpu.io.bundle import read_bundle_meta, write_bundle

    root = Path(BUNDLE_DIR)
    if (root / "meta.json").exists():
        try:
            meta = read_bundle_meta(root)
            if len(meta.taps) == BATCH and meta.sample_rate_hz == SR:
                return str(root)
        except Exception:
            pass
        shutil.rmtree(root, ignore_errors=True)

    rng = np.random.default_rng(7)
    t = np.arange(NUM_SAMPLES) / SR
    taps = {}
    for i in range(BATCH):
        rt60 = 0.9 + 0.7 * (i / max(1, BATCH - 1))
        env = (10.0 ** (-3.0 * t / rt60)).astype(np.float32)
        x = np.zeros((NUM_SAMPLES, 2), np.float32)
        x[256:, :] = (
            0.05 * rng.standard_normal((NUM_SAMPLES - 256, 2)).astype(np.float32)
            * env[: NUM_SAMPLES - 256, None]
        )
        x[256, :] = 0.9
        taps[f"tap{i:02d}"] = x
    write_bundle(root, taps, SR)
    return str(root)


def bench_bundle_engine_end_to_end(bundle_root: str) -> dict:
    """
    Native decode -> fused engine -> per-tap markdown, full wall-clock.
    `cold` includes jit trace + persistent-cache load; `warm` is the
    steady-state iterate-loop number.
    """
    import shutil
    from pathlib import Path

    from audio_analysis_tpu.report.engine_report import run_bundle_report_engine

    import json as json_mod

    import os

    def _touch_taps(only_first: bool = False) -> None:
        """Invalidate the device-resident audio cache the way the iterate
        loop does: the user re-renders audio and tap mtimes change — every
        tap (full re-render) or just one (A/B-ing a single tap; the
        per-chunk cache re-uploads only that tap's chunk)."""
        for wav in sorted((Path(bundle_root) / "taps").glob("*.wav")):
            os.utime(wav)
            if only_first:
                return

    timings = {}
    # warm_changed = the iterate-loop number: compile warm, but the audio
    # CHANGED since the last run (cache miss -> decode + upload + compute);
    # warm_changed_1tap = a single tap changed (per-chunk cache partial hit)
    for label in ("cold", "warm", "warm_changed", "warm_changed_1tap"):
        runs = 1 if label == "cold" else REPEATS - 1
        best = float("inf")
        for _ in range(max(1, runs)):
            if label.startswith("warm_changed"):
                _touch_taps(only_first=label == "warm_changed_1tap")
            shutil.rmtree(Path(bundle_root) / "reports", ignore_errors=True)
            start = time.perf_counter()
            index = run_bundle_report_engine(bundle_root)
            elapsed = time.perf_counter() - start
            assert index.exists()
            if elapsed < best:
                best = elapsed
                # per-phase split of the best run (engine_report instruments
                # probe/decode-wait/h2d/fetch/markdown/json)
                metrics = json_mod.loads(
                    (Path(bundle_root) / "reports" / "bundle_metrics.json").read_text()
                )
                timings[f"{label}_phases"] = metrics.get("phases", {})
        timings[label] = best
    return timings


def bench_bundle_plots_end_to_end(
    bundle_root: str, plot_processes: int, runs: int = 2
) -> tuple:
    """
    The full plot-based report path (matplotlib rendering overlapped with
    device compute on the plot-worker thread, or fanned over a process pool
    when plot_processes > 0) over PLOT_TAPS taps.
    Returns (elapsed_seconds, plot_timings_by_kind).
    """
    import json as json_mod
    import shutil
    from pathlib import Path

    from audio_analysis_tpu.report.bundle import run_bundle_report

    src = Path(bundle_root)
    sub = Path(f"{bundle_root}_plots{PLOT_TAPS}")
    shutil.rmtree(sub, ignore_errors=True)
    (sub / "taps").mkdir(parents=True)
    meta = json_mod.loads((src / "meta.json").read_text())
    meta["taps"] = meta["taps"][:PLOT_TAPS]
    (sub / "meta.json").write_text(json_mod.dumps(meta))
    for tap in meta["taps"]:
        (sub / "taps" / f"{tap}.wav").symlink_to(src / "taps" / f"{tap}.wav")

    from audio_analysis_tpu.report.bundle import BundleRunSettings
    from audio_analysis_tpu.report.report import ReportSettings

    settings = BundleRunSettings(
        report_settings=ReportSettings(plot_processes=plot_processes)
    )

    # best of `runs`, like the other timed sections
    elapsed = float("inf")
    plot_timings = {}
    for _ in range(max(1, runs)):
        shutil.rmtree(sub / "reports", ignore_errors=True)
        start = time.perf_counter()
        index = run_bundle_report(sub, settings)
        run_elapsed = time.perf_counter() - start
        assert index.exists()
        failed = index.read_text().count("FAILED")
        assert failed == 0, f"{failed} taps failed in the plot-path bench"
        if run_elapsed < elapsed:
            elapsed = run_elapsed
            # per-render-kind attribution of the recorded (best) run
            timings_path = sub / "reports" / "plot_timings.json"
            plot_timings = (
                json_mod.loads(timings_path.read_text()) if timings_path.exists() else {}
            )
    return elapsed, plot_timings


def _xla_cache_entries() -> int:
    """Entry count of the persistent compilation cache (-1 if unavailable):
    recorded before/after so the bench states whether its 'cold' number ran
    against a warm cache (new entries == 0) or paid real compiles."""
    import jax

    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        return sum(1 for p in Path(cache_dir).iterdir() if p.is_file())
    except (OSError, TypeError):
        return -1


_MESH_SCALING_WORKER = r"""
import json, sys, time
import numpy as np
import jax

# CPU executables in the persistent cache are AOT-compiled for the machine
# that stored them; loading one on a different machine type risks SIGILL.
# This CPU worker must not read or write the cache.
jax.config.update("jax_enable_compilation_cache", False)

from audio_analysis_tpu.engine import EngineConfig, analyze_batch_sharded, make_mesh


def measure(n):
    # compile and execute are reported SEPARATELY (a weak-scaling decline
    # is not attributable with one number): `compile_seconds` is the first traced+compiled call,
    # `seconds` the best of 3 identical calls afterwards — execute only.
    mesh = make_mesh(num_devices=n, platform="cpu")
    batch = 2 * n
    sr, ns = 48_000, 65_536
    rng = np.random.default_rng(0)
    t = np.arange(ns) / sr
    env = 10.0 ** (-3.0 * t / 0.4)
    samples = np.zeros((batch, 2, ns), np.float32)
    samples[:, :, 64:] = (0.05 * rng.standard_normal((batch, 2, ns - 64)) * env[: ns - 64]).astype(np.float32)
    samples[:, :, 64] = 0.9
    lengths = np.full(batch, ns, np.int32)
    config = EngineConfig(stft_fft_impl="xla")
    start = time.perf_counter()
    out = analyze_batch_sharded(mesh, samples, lengths, config)  # compile
    jax.block_until_ready(out)
    compile_seconds = time.perf_counter() - start
    best = float("inf")
    for _ in range(3):
        start = time.perf_counter()
        out = analyze_batch_sharded(mesh, samples, lengths, config)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - start)
    return {"seconds": round(best, 4), "taps": batch,
            "taps_per_sec": round(batch / best, 3),
            "compile_seconds": round(compile_seconds, 2)}


rows = {str(n): measure(n) for n in (1, 2, 4, 8)}
# the shared host's speed swings ~1.4x between windows; re-measuring the
# n=1 row AFTER the sweep bounds how much the window drifted across it
# (a "decline" over n is only real if 1_recheck still matches 1)
rows["1_recheck"] = measure(1)
print(json.dumps(rows))
"""


def bench_mesh_scaling() -> dict:
    """
    Weak-scaling rows for the sharded engine on a VIRTUAL CPU mesh
    (n_devices in {1,2,4,8}, 2 taps per device): proves the multi-chip
    program compiles + executes at every mesh size. Each row reports
    compile (first call) and execute (best of 3 identical calls)
    SEPARATELY, and the n=1 row is re-measured after the sweep
    ("1_recheck") to bound host-window drift across the phase. NOTE:
    virtual devices time-share the host's physical cores, so flat
    taps/sec across rows is the weak-scaling expectation once the cores
    are saturated. The worker runs with JAX_PLATFORMS=cpu, so it never
    opens the card this process holds.
    """
    import os
    import subprocess
    import sys as _sys
    import tempfile

    repo_root = str(__import__("pathlib").Path(__file__).resolve().parent)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [env.get("PYTHONPATH", ""), repo_root]))
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(_MESH_SCALING_WORKER)
        path = f.name
    try:
        run = subprocess.run(
            [_sys.executable, path],
            env=env,
            cwd=repo_root,
            capture_output=True,
            timeout=900,
        )
        if run.returncode != 0:
            return {"error": run.stderr.decode()[-400:]}
        return json.loads(run.stdout.decode().strip().splitlines()[-1])
    except subprocess.TimeoutExpired:
        # a slow CPU compile must degrade to an error row, not crash the
        # bench after every real measurement already completed
        return {"error": "mesh-scaling worker exceeded 900 s"}
    finally:
        os.unlink(path)


def main() -> None:
    # a fresh checkout has no cpp/build/libaudioio.so — build it so the
    # bundle benches measure the native parallel decode path, not the
    # scipy fallback
    from audio_analysis_tpu.io import native as _native

    _native.ensure_built()

    cache_entries_before = _xla_cache_entries()
    cache_marks = {}  # phase name -> entry count AFTER that phase

    device = bench_device()
    device_irs_per_sec = BATCH / device["device_seconds"]
    cache_marks["device_engine"] = _xla_cache_entries()

    # shard_map overhead runs NOW, while the device chunks are resident —
    # then the chunks are released so the bundle/plot benches below run
    # with the same device-memory headroom they had before this row existed
    global _BENCH_DEVICE_STATE
    sharded_overhead = bench_sharded_overhead(*_BENCH_DEVICE_STATE)
    _BENCH_DEVICE_STATE = None
    cache_marks["sharded_overhead"] = _xla_cache_entries()

    cpu_seconds_per_ir = bench_cpu_reference(taps=5)
    cpu_irs_per_sec = 1.0 / cpu_seconds_per_ir

    bundle_root = _bench_bundle_on_disk()
    e2e = bench_bundle_engine_end_to_end(bundle_root)
    cache_marks["bundle_engine_e2e"] = _xla_cache_entries()

    import os

    # the plot path, with and without the render process pool. On a 1-core
    # host a pool can only lose (spawn + IPC + result pickling on the same
    # core that renders), so the >0 variant is gated on multi-core and the
    # skip is recorded instead of a misleading row.
    try:
        cores = len(os.sched_getaffinity(0))  # usable (quota/affinity-aware)
    except AttributeError:
        cores = os.cpu_count() or 1
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        matplotlib = None
    if matplotlib is None:
        variant_procs = []
        plots_variants_note = "plot path skipped: matplotlib is not installed"
    elif cores > 1:
        variant_procs = [0, min(4, cores)]
        plots_variants_note = None
    else:
        variant_procs = [0]
        plots_variants_note = (
            "plot_processes>0 skipped: 1-core host (pool overhead can only "
            "lose; tests/test_plot_procpool.py proves the >=2-core win)"
        )
    plots_variants = {}
    for procs in variant_procs:
        seconds, timings = bench_bundle_plots_end_to_end(
            bundle_root, procs, runs=3 if procs == variant_procs[0] else 2
        )
        plots_variants[str(procs)] = {
            "seconds": round(seconds, 4),
            "seconds_per_tap": round(seconds / PLOT_TAPS, 4),
            "timings": timings,
        }
    plot_processes = min(
        (int(k) for k in plots_variants),
        key=lambda k: plots_variants[str(k)]["seconds"],
        default=None,
    )
    best_plots = plots_variants.get(str(plot_processes), {})
    plots_seconds = best_plots.get("seconds", float("nan"))
    plot_timings = best_plots.get("timings", {})
    cache_marks["plots_e2e"] = _xla_cache_entries()

    mesh_scaling = bench_mesh_scaling()
    cache_marks["mesh_scaling"] = _xla_cache_entries()

    # per-phase attribution of this run's new entries (deltas between
    # consecutive marks)
    prev = cache_entries_before
    cache_by_phase = {}
    for name, count in cache_marks.items():
        cache_by_phase[name] = count - prev
        prev = count

    # a second CPU-control sample at the END bounds how much the host's
    # speed drifted across this run's timed sections (compare with
    # cpu_seconds_per_ir)
    cpu_seconds_per_ir_end = bench_cpu_reference(taps=2)

    import jax

    print(
        json.dumps(
            {
                "metric": "irs_per_sec_stft_edc",
                "value": round(device_irs_per_sec, 3),
                "unit": "IR/s",
                "vs_baseline": round(device_irs_per_sec / cpu_irs_per_sec, 2),
                "device_seconds_64taps": round(device["device_seconds"], 4),
                "full_report_metrics_seconds_64taps": round(device["full_engine_seconds"], 4),
                "upload_inclusive_seconds_per_chunk": round(
                    device["upload_inclusive_seconds_per_chunk"], 4
                ),
                # end-to-end on a real on-disk 64-tap bundle: decode ->
                # engine -> markdown (no plots); warm = unchanged-bundle
                # rerun (device-resident audio); warm_changed = the
                # iterate-loop headline: compile warm but every tap's audio
                # re-rendered (decode + upload + compute + markdown)
                "end_to_end_seconds": round(e2e["cold"], 4),
                "end_to_end_warm_seconds": round(e2e["warm"], 4),
                "end_to_end_warm_changed_seconds": round(e2e["warm_changed"], 4),
                # one tap re-rendered (A/B-ing a single tap): the per-chunk
                # audio cache re-decodes + re-uploads only that tap's chunk
                "end_to_end_warm_changed_1tap_seconds": round(
                    e2e["warm_changed_1tap"], 4
                ),
                "end_to_end_warm_changed_1tap_phases": e2e.get(
                    "warm_changed_1tap_phases", {}
                ),
                # best-run splits: probe/decode-wait/h2d/fetch/markdown
                "end_to_end_cold_phases": e2e.get("cold_phases", {}),
                "end_to_end_warm_phases": e2e.get("warm_phases", {}),
                "end_to_end_warm_changed_phases": e2e.get("warm_changed_phases", {}),
                # shard_map-vs-plain on a 1-device mesh at the bundle shape
                "sharded_vs_plain_overhead": sharded_overhead,
                # persistent XLA cache state: cold ran against a warm cache
                # iff new_entries == 0; by_phase attributes this run's new
                # entries
                "xla_cache_entries_before": cache_entries_before,
                "xla_cache_new_entries": _xla_cache_entries() - cache_entries_before,
                "xla_cache_new_entries_by_phase": cache_by_phase,
                # sharded engine wall-clock on a virtual CPU mesh at
                # n_devices 1/2/4/8 (weak scaling, 2 taps/device; see
                # bench_mesh_scaling docstring)
                "mesh_scaling_virtual_cpu": mesh_scaling,
                "host_cpu_cores": os.cpu_count(),
                # full plot-based report path (matplotlib overlapped with
                # device compute) over PLOT_TAPS taps of the same bundle
                "plots_end_to_end_seconds": round(plots_seconds, 4),
                "plots_end_to_end_taps": PLOT_TAPS,
                "plots_seconds_per_tap": round(plots_seconds / PLOT_TAPS, 4),
                "plot_processes": plot_processes,
                # per-render-kind attribution of the recorded plot run
                # (reports/plot_timings.json of the best run)
                "plots_per_kind": plot_timings,
                # every measured plot config (seconds_per_tap per
                # plot_processes value); the procpool variant only runs on
                # multi-core hosts (plots_variants_note says why when not)
                "plots_variants": {
                    k: {kk: vv for kk, vv in v.items() if kk != "timings"}
                    for k, v in plots_variants.items()
                },
                "plots_variants_note": plots_variants_note,
                # single-threaded float64 NumPy oracle, 5-tap average;
                # the _end sample (2-tap) bounds host-speed drift across
                # the run's timed sections
                "cpu_seconds_per_ir": round(cpu_seconds_per_ir, 3),
                "cpu_seconds_per_ir_end": round(cpu_seconds_per_ir_end, 3),
                "cpu_baseline": "numpy_f64_single_thread_5tap_avg",
                "backend": jax.devices()[0].device_kind,
                "platform": jax.devices()[0].platform,
                "device_count": len(jax.devices()),
                "batch": BATCH,
                "samples_per_tap": NUM_SAMPLES,
            }
        )
    )


if __name__ == "__main__":
    main()
