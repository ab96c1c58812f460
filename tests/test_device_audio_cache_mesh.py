"""
Per-chunk device audio cache under a device MESH: cached entries are
tap-sharded arrays, reruns of an unchanged bundle decode nothing, a 1-tap
change re-uploads only its own chunk, and mesh entries never serve a
single-device run (mesh identity is part of the cache key).

Runs in a CPU-only subprocess with 8 virtual devices (same setup as
test_engine_mesh_bundle).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]

_WORKER = r"""
import json, sys, time
import numpy as np
import jax

assert len(jax.devices()) == 8, jax.devices()

from audio_analysis_tpu.io import native
from audio_analysis_tpu.io.wav import write_wav_pcm16
from audio_analysis_tpu.report.engine_report import (
    EngineBundleSettings,
    run_bundle_report_engine,
)
from audio_analysis_tpu.engine import EngineConfig

bundle, out_json = sys.argv[1], sys.argv[2]

# Fresh containers have no cpp/build/libaudioio.so; without it the bundle
# loader silently falls back to the scipy reader and the decode counter
# below never fires. Build it — and SKIP (like every other native-dependent
# test) when the toolchain is genuinely unavailable.
if not native.ensure_built():
    print("SKIP_NO_NATIVE_TOOLCHAIN")
    sys.exit(0)

decode_calls = [0]
orig = native.read_bundle_planar_i16


def counting(*a, **k):
    decode_calls[0] += 1
    return orig(*a, **k)


native.read_bundle_planar_i16 = counting

# 16 taps on the 8-device mesh at chunk_taps=1 -> effective chunk = 8 taps,
# 2 chunks: enough granularity to observe partial reuse
settings = EngineBundleSettings(
    config=EngineConfig(run_modal=False), chunk_taps=1, use_device_mesh="auto"
)


def run(s=None):
    run_bundle_report_engine(bundle, s or settings)
    metrics = json.loads(open(f"{bundle}/reports/bundle_metrics.json").read())
    return metrics["metrics"]["t30_rt60"], metrics["phases"]


t30_first, phases_first = run()
decodes_first = decode_calls[0]
assert decodes_first > 0, "first run must decode"
assert phases_first["audio_chunks_uploaded"] == 2, phases_first
assert phases_first["audio_chunks_reused"] == 0, phases_first

# unchanged rerun: zero decode, both (sharded) chunks served from devices
t30_second, phases_second = run()
decodes_second = decode_calls[0] - decodes_first
np.testing.assert_array_equal(np.asarray(t30_first), np.asarray(t30_second))
assert decodes_second == 0, f"mesh cache hit must not decode (got {decodes_second})"
assert phases_second["audio_chunks_reused"] == 2, phases_second
assert phases_second["audio_chunks_uploaded"] == 0, phases_second

# touch ONE tap -> only its chunk re-decodes + re-uploads
sr, n = 48_000, 8_192
t = np.arange(n) / sr
x = np.zeros((n, 2), np.float32)
x[64:, :] = (
    0.05
    * np.random.default_rng(99).standard_normal((n - 64, 2))
    * (10.0 ** (-3.0 * t[: n - 64] / 0.1))[:, None]
).astype(np.float32)
x[64, :] = 0.9
time.sleep(0.05)  # distinct mtime_ns on coarse filesystems
write_wav_pcm16(f"{bundle}/taps/tap00.wav", x, sr)

t30_third, phases_third = run()
decodes_third = decode_calls[0] - decodes_first
assert decodes_third == 1, f"1-tap change must re-decode one chunk (got {decodes_third})"
assert phases_third["audio_chunks_uploaded"] == 1, phases_third
assert phases_third["audio_chunks_reused"] == 1, phases_third
assert not np.allclose(t30_third[0], t30_second[0], rtol=1e-3), (
    t30_third[0], t30_second[0],
)
# untouched taps bit-identical through the partial (sharded) reuse
np.testing.assert_array_equal(np.asarray(t30_third)[8:], np.asarray(t30_second)[8:])

# switching to the single-device path must NOT reuse mesh-sharded entries
# (mesh identity keys the cache), and must still agree numerically
off = EngineBundleSettings(
    config=EngineConfig(run_modal=False), chunk_taps=8, use_device_mesh="off"
)
t30_off, phases_off = run(off)
assert phases_off["audio_chunks_reused"] == 0, phases_off
assert phases_off["audio_chunks_uploaded"] == 2, phases_off
np.testing.assert_allclose(
    np.asarray(t30_off), np.asarray(t30_third), rtol=2e-4, atol=1e-5
)

json.dump({"ok": True}, open(out_json, "w"))
print("worker ok")
"""


def test_device_audio_cache_under_mesh(tmp_path):
    from audio_analysis_tpu.io.bundle import write_bundle

    sr = 48_000
    n = 8_192
    rng = np.random.default_rng(17)
    t = np.arange(n) / sr
    taps = {}
    for i in range(16):
        rt60 = 0.2 + 0.02 * i
        env = 10.0 ** (-3.0 * t / rt60)
        x = np.zeros((n, 2), np.float32)
        x[64:, :] = (
            0.05 * rng.standard_normal((n - 64, 2)) * env[: n - 64, None]
        ).astype(np.float32)
        x[64, :] = 0.9
        taps[f"tap{i:02d}"] = x
    bundle = tmp_path / "bundle"
    write_bundle(bundle, taps, sr)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [env.get("PYTHONPATH", ""), str(REPO_ROOT)])
    )

    out_json = tmp_path / "out.json"
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    run = subprocess.run(
        [sys.executable, str(worker), str(bundle), str(out_json)],
        env=env,
        cwd=REPO_ROOT,
        capture_output=True,
        timeout=900,
    )
    assert run.returncode == 0, run.stderr.decode()[-3000:] + run.stdout.decode()[-500:]
    if "SKIP_NO_NATIVE_TOOLCHAIN" in run.stdout.decode():
        import pytest

        pytest.skip("native audioio library unbuildable (no C++ toolchain)")
    assert json.loads(out_json.read_text())["ok"] is True
