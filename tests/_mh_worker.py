"""
Worker for the 2-process multi-host CPU test (tests/test_distributed_multihost.py).

Run as: python tests/_mh_worker.py <coordinator> <num_procs> <proc_id> <bundle> <out_json>
with a CPU-only environment (JAX_PLATFORMS=cpu,
xla_force_host_platform_device_count set) — the parent test builds that env.
"""

import json
import sys


def main() -> None:
    coordinator, num_procs, proc_id, bundle_root, out_json = sys.argv[1:6]

    import jax

    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass  # older/newer jax: gloo is the default for multi-process CPU

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=int(num_procs),
        process_id=int(proc_id),
    )

    from audio_analysis_tpu.engine.batch import EngineConfig
    from audio_analysis_tpu.engine.distributed import (
        analyze_bundle_multi_host,
        run_bundle_report_multi_host,
    )

    out = analyze_bundle_multi_host(bundle_root, EngineConfig(run_modal=False))

    # also exercise the multi-host report writer (shared filesystem)
    index = run_bundle_report_multi_host(bundle_root, EngineConfig(run_modal=False))
    if int(proc_id) == 0:
        assert index is not None and index.exists()
        # process 0 dumped GLOBAL per-tap metrics (all taps, not its shard)
        metrics = json.loads((index.parent / "bundle_metrics.json").read_text())
        assert len(metrics["taps"]) == len(metrics["metrics"]["t30_rt60"])
        assert len(metrics["taps"]) > len(out["local_tap_names"])
    else:
        assert index is None

    # second run comparing against the first, in place: identical content,
    # so the comparison section reports no changes (and every process
    # participates in the gather collective)
    index2 = run_bundle_report_multi_host(
        bundle_root,
        EngineConfig(run_modal=False),
        compare_to=str(bundle_root) + "/reports",
    )
    if int(proc_id) == 0:
        content = index2.read_text()
        assert "## Changes vs" in content
        assert "No changes above threshold." in content

    payload = {
        "process_id": int(proc_id),
        "num_devices": len(jax.devices()),
        "local_tap_names": out["local_tap_names"],
        "t30_rt60": [[float(x) for x in row] for row in out["t30_rt60"]],
        "t30_ok": [[bool(x) for x in row] for row in out["t30_ok"]],
        "bundle_median_t30": float(out["bundle_median_t30"]),
        "bundle_mean_early10": float(out["bundle_mean_early10"]),
        "bundle_valid_taps": int(out["bundle_valid_taps"]),
    }
    with open(out_json, "w") as f:
        json.dump(payload, f)
    print("worker ok", proc_id)


if __name__ == "__main__":
    main()
