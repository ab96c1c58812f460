"""
Entry-point regressions of the multi-device dry run.

The dry run must stay on the CPU whatever accelerator the host has, so
make_mesh takes platform="cpu"; and merely importing the engine must not
initialise the default backend (ops/selectq.py once created module-level
jnp.uint32 constants, which did exactly that before the CPU mesh was ever
built). Both are guarded here:

1. importing EVERY audio_analysis_tpu module (+ __graft_entry__) must leave
   `jax.live_arrays()` empty — no import-time device constants;
2. `__graft_entry__.dryrun_multichip(8)` must run green on an 8-virtual-
   device CPU host, exactly as an outside caller invokes it.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]

_IMPORT_WORKER = r"""
import importlib
import pkgutil

import jax

import audio_analysis_tpu

mods = ["audio_analysis_tpu"]
for m in pkgutil.walk_packages(audio_analysis_tpu.__path__, "audio_analysis_tpu."):
    mods.append(m.name)
for name in mods:
    importlib.import_module(name)
import __graft_entry__  # noqa: F401

leaked = jax.live_arrays()
assert not leaked, f"import-time device arrays ({len(leaked)}): {leaked[:5]}"
print(f"import ok: {len(mods)} modules, no live arrays")
"""

_DRYRUN_WORKER = r"""
import __graft_entry__

__graft_entry__.dryrun_multichip(8)
"""


def _cpu_subprocess_env(n_devices: int = 8, jax_platforms: str | None = "cpu") -> dict:
    env = dict(os.environ)
    if jax_platforms is None:
        # Leave platform selection to jax (and to dryrun_multichip's own
        # jax_platforms="cpu" override) — a caller may not export
        # JAX_PLATFORMS=cpu itself.
        env.pop("JAX_PLATFORMS", None)
    else:
        env["JAX_PLATFORMS"] = jax_platforms
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [env.get("PYTHONPATH", ""), str(REPO_ROOT)]))
    return env


def _run_worker(
    tmp_path, name: str, source: str, jax_platforms: str | None = "cpu"
) -> subprocess.CompletedProcess:
    worker = tmp_path / name
    worker.write_text(source)
    return subprocess.run(
        [sys.executable, str(worker)],
        env=_cpu_subprocess_env(jax_platforms=jax_platforms),
        cwd=REPO_ROOT,
        capture_output=True,
        timeout=600,
    )


def test_import_every_module_is_device_free(tmp_path):
    run = _run_worker(tmp_path, "import_worker.py", _IMPORT_WORKER)
    assert run.returncode == 0, run.stderr.decode()[-3000:]
    assert b"import ok" in run.stdout, run.stdout.decode()[-1000:]


def test_dryrun_multichip_8_virtual_devices(tmp_path):
    run = _run_worker(tmp_path, "dryrun_worker.py", _DRYRUN_WORKER)
    assert run.returncode == 0, run.stderr.decode()[-3000:]
    assert b"dryrun_multichip ok" in run.stdout, run.stdout.decode()[-1000:]


def test_dryrun_multichip_without_jax_platforms_env(tmp_path):
    """dryrun must self-select CPU even when JAX_PLATFORMS isn't exported —
    its own jax.config jax_platforms="cpu" override is what's under test."""
    run = _run_worker(tmp_path, "dryrun_worker2.py", _DRYRUN_WORKER, jax_platforms=None)
    assert run.returncode == 0, run.stderr.decode()[-3000:]
    assert b"dryrun_multichip ok" in run.stdout, run.stdout.decode()[-1000:]
