"""
A/B: changed-audio warm end-to-end vs the pipeline's prefetch depth.

The warm-changed bundle number (the iterate-loop cache-miss workload,
bench.py end_to_end_warm_changed_seconds) is bounded by how well the
per-chunk decode + host->device upload hides under device compute;
analyze_bundle_pipelined decodes/uploads `prefetch_chunks` ahead. This
bench measures the number at depths 1 (a serialized pipeline), 2 (the
default) and 4, on the standard 64-tap / 2^20 bench
bundle, compile-warm, audio touched before every run (full cache miss).

Run it as the only process on the card:

    python scripts/bench_prefetch_depth.py

Prints one JSON line per (depth, repeat) plus a summary line.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402  (repo-root bench utilities)
from audio_analysis_tpu.io import native  # noqa: E402

REPEATS = 3
DEPTHS = (1, 2, 4)


def main() -> None:
    native.ensure_built()
    from dataclasses import replace

    from audio_analysis_tpu.report.engine_report import (
        EngineBundleSettings,
        run_bundle_report_engine,
    )

    root = Path(bench._bench_bundle_on_disk())

    def touch_all() -> None:
        for wav in sorted((root / "taps").glob("*.wav")):
            os.utime(wav)

    base = EngineBundleSettings()

    # one compile-warming pass (pays the per-process first-execution toll
    # and seeds/loads the persistent XLA cache)
    t0 = time.perf_counter()
    run_bundle_report_engine(root, base)
    print(json.dumps({"phase": "warmup", "seconds": round(time.perf_counter() - t0, 2)}))

    summary = {}
    for depth in DEPTHS:
        settings = replace(base, prefetch_chunks=depth)
        best, best_phases = float("inf"), {}
        for rep in range(REPEATS):
            touch_all()
            shutil.rmtree(root / "reports", ignore_errors=True)
            t0 = time.perf_counter()
            run_bundle_report_engine(root, settings)
            elapsed = time.perf_counter() - t0
            phases = json.loads(
                (root / "reports" / "bundle_metrics.json").read_text()
            ).get("phases", {})
            print(
                json.dumps(
                    {"depth": depth, "rep": rep, "seconds": round(elapsed, 3), "phases": phases}
                ),
                flush=True,
            )
            if elapsed < best:
                best, best_phases = elapsed, phases
        summary[str(depth)] = {"best_seconds": round(best, 3), "phases": best_phases}

    # the same host-speed control bench.py uses: never compare wall-clocks
    # across windows without it
    cpu_s = bench.bench_cpu_reference(taps=2)
    print(json.dumps({"summary": summary, "cpu_seconds_per_ir": round(cpu_s, 3)}))


if __name__ == "__main__":
    main()
