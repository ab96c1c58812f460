"""
Real 2-process multi-host test for engine.distributed (CPU, local coordinator).

Spawns two CPU-only JAX processes (JAX_PLATFORMS=cpu, two
virtual CPU devices each), runs `analyze_bundle_multi_host` on a shared
6-tap bundle, and asserts:
  - the tap shards partition the bundle (each tap analysed exactly once,
    contiguous blocks in device order),
  - per-tap T30s recover the synthetic RT60s,
  - the bundle aggregates are identical on both processes (all-reduced).

The launch/env/drain plumbing lives in tests/_mh_harness.py, shared with
__graft_entry__.dryrun_multichip's pass-3 multi-host certification.
"""

import json
import sys

import numpy as np
import pytest

import _mh_harness as mh

TAP_RT60S = [0.15, 0.18, 0.21, 0.24, 0.27, 0.30]


def test_two_process_bundle_analysis(tmp_path):
    bundle = tmp_path / "bundle"
    all_names = mh.make_synthetic_bundle(bundle, TAP_RT60S)

    out_files = [tmp_path / f"proc{i}.json" for i in range(2)]
    mh.run_two_process_bundle(bundle, out_files)

    results = [json.loads(f.read_text()) for f in out_files]

    # 4 global devices, 6 taps -> padded to 8, 2 per device; process 0
    # (devices 0,1) owns taps 0-3, process 1 owns taps 4-5 (pads dropped).
    assert results[0]["num_devices"] == 4 and results[1]["num_devices"] == 4
    assert results[0]["local_tap_names"] == all_names[:4]
    assert results[1]["local_tap_names"] == all_names[4:]

    # Per-tap T30 recovers the synthetic RT60s on the owning process.
    t30_by_name = {}
    t30_all_channels = []
    for r in results:
        for name, row, okrow in zip(r["local_tap_names"], r["t30_rt60"], r["t30_ok"]):
            assert all(okrow), f"{name}: t30 fit not ok"
            t30_by_name[name] = float(np.mean(row))
            t30_all_channels.extend(float(x) for x in row)
    for name, rt60 in zip(all_names, TAP_RT60S):
        assert abs(t30_by_name[name] - rt60) < 0.15 * rt60, (name, t30_by_name[name], rt60)

    # Aggregates are all-reduced: identical on both processes, and match
    # the median over the per-tap values the processes computed.
    for key in ("bundle_median_t30", "bundle_mean_early10"):
        assert results[0][key] == pytest.approx(results[1][key], rel=1e-6), key
    assert results[0]["bundle_valid_taps"] == results[1]["bundle_valid_taps"] == len(TAP_RT60S)
    expected_median = float(np.median(t30_all_channels))
    assert results[0]["bundle_median_t30"] == pytest.approx(expected_median, rel=1e-3)

    # the multi-host report writer ran inside the workers: every tap has a
    # per-tap report (written by the owning host) and process 0 wrote the
    # index with the all-reduced aggregates
    index_md = (bundle / "reports" / "bundle_report.md").read_text()
    assert "multi-host" in index_md
    assert f"bundle_median_t30:** {expected_median:.4f}" in index_md
    for name in all_names:
        tap_md = (bundle / "reports" / name / f"{name}_report.md").read_text()
        assert "## Decay / EDC" in tap_md and "## Impulse response" in tap_md


def test_two_process_bundle_cli(tmp_path):
    """`analyse.cli bundle --multi-host` reaches run_bundle_report_multi_host:
    two CPU processes, per-tap reports written by the owning host, index by
    process 0 only."""
    bundle = tmp_path / "bundle"
    all_names = mh.make_synthetic_bundle(bundle, TAP_RT60S)

    coordinator = mh.free_coordinator()
    commands = [
        [
            sys.executable, "-m", "analyse.cli", "bundle",
            "--input", str(bundle),
            "--multi-host",
            "--coordinator", coordinator,
            "--num-processes", "2",
            "--process-id", str(i),
        ]
        for i in range(2)
    ]
    logs = mh.run_processes(commands, mh.cpu_multihost_env(), what="CLI worker")

    # only process 0 printed the index line
    wrote = [log for log in logs if "Wrote bundle report index:" in log]
    assert len(wrote) == 1, logs

    index_md = (bundle / "reports" / "bundle_report.md").read_text()
    assert "multi-host" in index_md
    for name in all_names:
        tap_md = (bundle / "reports" / name / f"{name}_report.md").read_text()
        assert "## Decay / EDC" in tap_md
