"""
Device-resident bundle-audio cache (EngineBundleSettings.cache_device_audio):
a warm rerun of an UNCHANGED bundle must not decode any PCM (chunks stay in
device memory) and must produce identical metrics; touching a tap must
invalidate the cache and change the results.
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

from audio_analysis_tpu.io import native
from audio_analysis_tpu.io.bundle import write_bundle
from audio_analysis_tpu.report.engine_report import (
    EngineBundleSettings,
    run_bundle_report_engine,
)
from audio_analysis_tpu.engine import EngineConfig

bundle, out_json = sys.argv[1], sys.argv[2]

# Fresh containers have no cpp/build/libaudioio.so; without it the bundle
# loader silently falls back to the scipy reader and the decode counter
# below never fires. Build it — and SKIP (like every other native-dependent
# test: test_engine_mesh_bundle, test_property_based) when the toolchain is
# genuinely unavailable, so one environment limitation behaves the same
# across the suite (round-4 advisor finding).
if not native.ensure_built():
    print("SKIP_NO_NATIVE_TOOLCHAIN")
    sys.exit(0)

decode_calls = [0]
orig = native.read_bundle_planar_i16


def counting(*a, **k):
    decode_calls[0] += 1
    return orig(*a, **k)


native.read_bundle_planar_i16 = counting

# use_device_mesh off: the cache is a single-device feature, and the test
# env inherits the 8-virtual-device XLA flag from conftest
settings = EngineBundleSettings(
    config=EngineConfig(run_modal=False), chunk_taps=2, use_device_mesh="off"
)


def run():
    run_bundle_report_engine(bundle, settings)
    metrics = json.loads(open(f"{bundle}/reports/bundle_metrics.json").read())
    return metrics["metrics"]["t30_rt60"], metrics["phases"]


t30_first, phases_first = run()
decodes_first = decode_calls[0]
assert decodes_first > 0, "first run must decode"
# 3 taps at chunk_taps=2 -> 2 chunks, all uploaded on the cold run
assert phases_first["audio_chunks_uploaded"] == 2, phases_first
assert phases_first["audio_chunks_reused"] == 0, phases_first

t30_second, phases_second = run()
decodes_second = decode_calls[0] - decodes_first
np.testing.assert_array_equal(np.asarray(t30_first), np.asarray(t30_second))
assert decodes_second == 0, f"cache hit must not decode (got {decodes_second})"
assert phases_second["audio_chunks_reused"] == 2, phases_second
assert phases_second["audio_chunks_uploaded"] == 0, phases_second

# mutate one tap: different decay -> cache must invalidate and results move
sr, n = 48_000, 16_384
t = np.arange(n) / sr
env = 10.0 ** (-3.0 * t / 0.5)
x = np.zeros((n, 2), np.float32)
x[64:, :] = (0.05 * np.random.default_rng(99).standard_normal((n - 64, 2)) * env[: n - 64, None]).astype(np.float32)
x[64, :] = 0.9
import time
time.sleep(0.05)  # ensure a distinct mtime_ns on coarse filesystems
from audio_analysis_tpu.io.wav import write_wav_pcm16
write_wav_pcm16(f"{bundle}/taps/tap0.wav", x, sr)

t30_third, phases_third = run()
decodes_third = decode_calls[0] - decodes_first
assert decodes_third == 1, (
    f"a 1-tap change must re-decode ONLY its own chunk (got {decodes_third})"
)
assert phases_third["audio_chunks_uploaded"] == 1, phases_third
assert phases_third["audio_chunks_reused"] == 1, phases_third
assert not np.allclose(t30_third[0], t30_second[0], rtol=1e-3), (
    t30_third[0], t30_second[0]
)
# the untouched taps' metrics must be bit-identical through the partial reuse
np.testing.assert_array_equal(np.asarray(t30_third)[1:], np.asarray(t30_second)[1:])

# a different chunking regroups taps -> the whole cache must invalidate
settings = EngineBundleSettings(
    config=EngineConfig(run_modal=False), chunk_taps=3, use_device_mesh="off"
)
t30_fourth, phases_fourth = run()
assert phases_fourth["audio_chunks_reused"] == 0, phases_fourth
assert phases_fourth["audio_chunks_uploaded"] == 1, phases_fourth  # 3 taps / 3
np.testing.assert_array_equal(np.asarray(t30_fourth), np.asarray(t30_third))

# growing ONE tap changes the padded batch length (n_max) and therefore
# every chunk's shape + the full-signal FFT grid: chunks that look
# unchanged by (path, mtime, size) must NOT be served at the stale shape
settings = EngineBundleSettings(
    config=EngineConfig(run_modal=False), chunk_taps=2, use_device_mesh="off"
)
run()  # repopulate at chunk_taps=2 / current n_max
n_long = n + 8192
x_long = np.zeros((n_long, 2), np.float32)
x_long[64:, :] = (
    0.05
    * np.random.default_rng(7).standard_normal((n_long - 64, 2))
    * 10.0 ** (-3.0 * (np.arange(n_long - 64) / sr)[:, None] / 0.4)
).astype(np.float32)
x_long[64, :] = 0.9
time.sleep(0.05)
write_wav_pcm16(f"{bundle}/taps/tap0.wav", x_long, sr)
_t30_fifth, phases_fifth = run()
assert phases_fifth["audio_chunks_reused"] == 0, phases_fifth
assert phases_fifth["audio_chunks_uploaded"] == 2, phases_fifth

json.dump({"ok": True}, open(out_json, "w"))
print("worker ok")
"""


def test_device_audio_cache_roundtrip(tmp_path):
    from audio_analysis_tpu.io.bundle import write_bundle

    sr = 48_000
    n = 16_384
    rng = np.random.default_rng(31)
    t = np.arange(n) / sr
    taps = {}
    for i, rt60 in enumerate([0.2, 0.3, 0.4]):
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
    assert run.returncode == 0, run.stderr.decode()[-3000:] + run.stdout.decode()[-500:]
    if "SKIP_NO_NATIVE_TOOLCHAIN" in run.stdout.decode():
        import pytest

        pytest.skip("native audioio library unbuildable (no C++ toolchain)")
    assert json.loads(out_json.read_text())["ok"] is True
