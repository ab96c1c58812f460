"""
Shared 2-process multi-host harness.

Used by tests/test_distributed_multihost.py AND __graft_entry__.py's
pass-3 multi-host dryrun — one copy of the fragile parts (CPU-only env recipe,
free-port coordinator, concurrent pipe drain) so fixes can't drift
between the test and the dry run. pytest-free on purpose: the
dryrun runs outside pytest.
"""

from __future__ import annotations

import concurrent.futures
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]
WORKER = REPO_ROOT / "tests" / "_mh_worker.py"


def make_synthetic_bundle(root: Path, rt60s: Sequence[float], n: int = 16_384) -> List[str]:
    """Write a recorder-contract bundle of decaying-noise taps with the
    given RT60s; returns the tap names."""
    from audio_analysis_tpu.io.bundle import write_bundle

    sr = 48_000
    t = np.arange(n) / sr
    rng = np.random.default_rng(42)
    taps = {}
    for i, rt60 in enumerate(rt60s):
        env = 10.0 ** (-3.0 * t / rt60)
        x = np.zeros((n, 2), np.float32)
        x[64:, :] = (0.05 * rng.standard_normal((n - 64, 2)) * env[: n - 64, None]).astype(
            np.float32
        )
        x[64, :] = 0.9
        taps[f"tap{i:02d}"] = x
    write_bundle(root, taps, sr)
    return sorted(taps)


def cpu_multihost_env(devices_per_process: int = 2) -> Dict[str, str]:
    """Env for a CPU-only jax.distributed worker: N virtual CPU devices,
    repo root importable."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices_per_process}"
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [env.get("PYTHONPATH", ""), str(REPO_ROOT)])
    )
    return env


def free_coordinator() -> str:
    """A 127.0.0.1:<free-port> coordinator address."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def run_processes(
    commands: Sequence[Sequence[str]],
    env: Dict[str, str],
    timeout: float = 600,
    what: str = "multi-host worker",
) -> List[str]:
    """Launch the worker processes and drain ALL stdout pipes concurrently
    — a sequential communicate() can deadlock if another worker fills its
    64 KiB stdout pipe before the collective barrier (verbose jax logs)
    while this one waits in it. Asserts zero exit codes; returns logs."""
    procs = [
        subprocess.Popen(
            list(cmd),
            env=env,
            cwd=REPO_ROOT,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for cmd in commands
    ]
    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        logs = [
            f.result()[0].decode()
            for f in [pool.submit(p.communicate, timeout=timeout) for p in procs]
        ]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{what} failed:\n{log[-4000:]}"
    return logs


def run_two_process_bundle(bundle: Path, out_files: Sequence[Path]) -> List[str]:
    """The standard 2-process jax.distributed bundle job over
    tests/_mh_worker.py (2 virtual CPU devices each)."""
    coordinator = free_coordinator()
    commands = [
        [sys.executable, str(WORKER), coordinator, "2", str(i), str(bundle), str(out_files[i])]
        for i in range(2)
    ]
    return run_processes(commands, cpu_multihost_env(), what="multi-host bundle worker")
