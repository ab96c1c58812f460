"""
The engine bundle report auto-shards over all visible devices
(EngineBundleSettings.use_device_mesh="auto"). Exercised in a CPU-only
subprocess with 8 virtual devices (the mesh path engages only when the
default platform has several devices) and compared against the single-device
path for numeric agreement.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]

_WORKER = r"""
import json, sys
import numpy as np
import jax

assert len(jax.devices()) == 8, jax.devices()

from audio_analysis_tpu.report.engine_report import (
    EngineBundleSettings,
    run_bundle_report_engine,
)
from audio_analysis_tpu.engine import EngineConfig

bundle, out_json = sys.argv[1], sys.argv[2]

results = {}
for mode in ("auto", "off"):
    reports = f"reports_{mode}"
    run_bundle_report_engine(
        bundle,
        EngineBundleSettings(
            reports_subdir=reports,
            config=EngineConfig(run_modal=False),
            chunk_taps=2,
            use_device_mesh=mode,
        ),
    )
    metrics = json.loads(open(f"{bundle}/{reports}/bundle_metrics.json").read())
    results[mode] = {
        "taps": metrics["taps"],
        "t30": metrics["metrics"]["t30_rt60"],
        "fr_peak": metrics["metrics"]["fr_peak_hz"],
    }
json.dump(results, open(out_json, "w"))
print("worker ok")
"""


def test_engine_bundle_auto_shards_over_mesh(tmp_path):
    from audio_analysis_tpu.io.bundle import write_bundle

    sr = 48_000
    n = 16_384
    rng = np.random.default_rng(12)
    t = np.arange(n) / sr
    taps = {}
    for i, rt60 in enumerate([0.15, 0.2, 0.25, 0.3, 0.35]):  # 5 taps, 8 devices -> padding
        env = 10.0 ** (-3.0 * t / rt60)
        x = np.zeros((n, 2), np.float32)
        x[64:, :] = (0.05 * rng.standard_normal((n - 64, 2)) * env[: n - 64, None]).astype(
            np.float32
        )
        x[64, :] = 0.9
        taps[f"tap{i}"] = x
    bundle = tmp_path / "bundle"
    write_bundle(bundle, taps, sr)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [env.get("PYTHONPATH", ""), str(REPO_ROOT)]))

    out_json = tmp_path / "out.json"
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    run = subprocess.run(
        [sys.executable, str(worker), str(bundle), str(out_json)],
        env=env,
        cwd=REPO_ROOT,
        capture_output=True,
        timeout=600,
    )
    assert run.returncode == 0, run.stderr.decode()[-3000:]

    results = json.loads(out_json.read_text())
    assert results["auto"]["taps"] == results["off"]["taps"] == sorted(taps)
    np.testing.assert_allclose(
        np.asarray(results["auto"]["t30"]), np.asarray(results["off"]["t30"]), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(results["auto"]["fr_peak"]), np.asarray(results["off"]["fr_peak"]), rtol=1e-6
    )


_PIPELINED_WORKER = r"""
import sys
import numpy as np

from audio_analysis_tpu.engine import EngineConfig
from audio_analysis_tpu.engine.batch import analyze_bundle, analyze_bundle_pipelined
from audio_analysis_tpu.io.bundle import load_bundle_batch_i16, open_bundle_chunks_i16

bundle = sys.argv[1]
cfg = EngineConfig(run_modal=False)

meta, batch, lengths, names = load_bundle_batch_i16(bundle)
ref = analyze_bundle(batch, lengths, cfg, chunk_taps=2)

meta2, lengths2, names2, n_max, loader = open_bundle_chunks_i16(bundle)
assert n_max == batch.shape[-1], (n_max, batch.shape)
assert np.array_equal(lengths, lengths2)
assert list(names) == list(names2)

# every prefetch depth (1 = the serialized pipeline, 2 = default, 4 > the
# 3-chunk count) must consume chunks strictly in order -> bit-identical
for depth in (1, 2, 4):
    pipe = analyze_bundle_pipelined(
        loader, lengths2, n_max, cfg, chunk_taps=2, prefetch_chunks=depth
    )
    assert sorted(pipe) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(pipe[k], ref[k], err_msg=f"{k} depth={depth}")
print("worker ok")
"""


def test_pipelined_bundle_matches_batch(tmp_path):
    """analyze_bundle_pipelined (threaded chunk decode) is bit-identical to
    analyze_bundle on the same PCM16 bundle: same chunking, same compiled
    program, same padding policy."""
    from audio_analysis_tpu.io import native
    from audio_analysis_tpu.io.bundle import write_bundle

    if not native.ensure_built():  # builds cpp/ on a fresh container
        import pytest

        pytest.skip("native audioio library not buildable (make -C cpp)")

    sr = 48_000
    n = 16_384
    rng = np.random.default_rng(7)
    t = np.arange(n) / sr
    taps = {}
    for i, rt60 in enumerate([0.12, 0.2, 0.27, 0.33, 0.4]):  # 5 taps, chunk 2 -> padded tail
        env = 10.0 ** (-3.0 * t / rt60)
        x = np.zeros((n, 2), np.float32)
        x[64:, :] = (0.05 * rng.standard_normal((n - 64, 2)) * env[: n - 64, None]).astype(
            np.float32
        )
        x[64, :] = 0.9
        taps[f"tap{i}"] = x
    bundle = tmp_path / "bundle"
    write_bundle(bundle, taps, sr)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [env.get("PYTHONPATH", ""), str(REPO_ROOT)]))

    worker = tmp_path / "worker_pipelined.py"
    worker.write_text(_PIPELINED_WORKER)
    run = subprocess.run(
        [sys.executable, str(worker), str(bundle)],
        env=env,
        cwd=REPO_ROOT,
        capture_output=True,
        timeout=600,
    )
    assert run.returncode == 0, run.stderr.decode()[-3000:]
    assert b"worker ok" in run.stdout
