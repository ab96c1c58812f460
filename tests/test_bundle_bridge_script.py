"""
scripts/analyse_bundle.sh — the C++-capture-to-analysis bridge (reference:
scripts/analyse_bundle.sh) — must drive the real CLI end to end: bundle
folder in, per-tap reports + bundle metrics out, extra flags forwarded.
"""

import json
import os
import subprocess
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]


def test_bridge_script_runs_bundle_cli(tmp_path):
    from audio_analysis_tpu.io.bundle import write_bundle

    sr, n = 48_000, 16_384
    rng = np.random.default_rng(5)
    t = np.arange(n) / sr
    taps = {}
    for i, rt60 in enumerate([0.25, 0.4]):
        env = 10.0 ** (-3.0 * t / rt60)
        x = np.zeros((n, 2), np.float32)
        x[64:, :] = (0.05 * rng.standard_normal((n - 64, 2)) * env[: n - 64, None]).astype(
            np.float32
        )
        x[64, :] = 0.9
        taps[f"tap{i}"] = x
    bundle = tmp_path / "run_0001"
    write_bundle(bundle, taps, sr)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run(
        ["bash", str(REPO_ROOT / "scripts" / "analyse_bundle.sh"), str(bundle), "--no-plots"],
        env=env,
        cwd=REPO_ROOT,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert run.returncode == 0, run.stderr[-3000:]

    reports = bundle / "reports"
    assert (reports / "bundle_report.md").exists(), list(bundle.iterdir())
    metrics = json.loads((reports / "bundle_metrics.json").read_text())
    t30 = np.asarray(metrics["metrics"]["t30_rt60"], np.float64)
    assert t30.shape[0] == 2 and np.all(np.isfinite(t30))
    for name in taps:
        assert (reports / name / f"{name}_report.md").exists()
