"""
The runnable examples in examples/ (docs/API.md's companion code) must
actually run: each executes in a CPU-pinned subprocess exactly as its
docstring says to invoke it, and its printed output is sanity-checked.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parents[1]


def _run_example(name: str, extra_env: dict | None = None) -> str:
    env = dict(os.environ)
    # CPU-only, virtual devices for the mesh one
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra_env or {})
    run = subprocess.run(
        [sys.executable, str(REPO_ROOT / "examples" / name)],
        env=env,
        cwd=REPO_ROOT,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout


def test_example_batch_metrics():
    out = _run_example("01_batch_metrics.py")
    assert "T30 (L)" in out and "metric families:" in out, out


def test_example_custom_analysis_from_ops():
    out = _run_example("02_custom_analysis_from_ops.py")
    assert "chirp" in out and "Hz" in out, out
    # the chirp's spectral centroid must fall over time (4 kHz -> 1 kHz)
    chirp_line = next(line for line in out.splitlines() if "chirp" in line)
    first, last = (
        float(tok.strip()) for tok in
        chirp_line.split(":", 1)[1].replace("centroid", "").replace("Hz", "").split("->")
    )
    assert first > last > 0, chirp_line


@pytest.mark.skipif(os.name != "posix", reason="virtual-device mesh example")
def test_example_mesh_scaling():
    out = _run_example(
        "03_mesh_scaling.py",
        extra_env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
    )
    assert "mesh" in out and "t30_rt60" in out, out
