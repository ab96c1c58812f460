"""
BYTE-level gen-CLI parity against the live reference tool.

The reference's generators are fully deterministic (seeded default_rng,
closed-form phases — gen/signals.py), and this framework re-derives the
same formulas with the same seeds, so the PCM16 artifacts can be compared
byte for byte — the strongest cross-tool statement possible. Both CLIs
run as subprocesses: the reference with PYTHONPATH=/root/reference from a
neutral cwd (so the two `gen` packages never collide), ours from the repo
root.

Measured state this pins: 9 of 10 generators byte-identical; only
karplus_pluck differs, by at most 1 LSB on ~0.1% of samples — the
reference runs its per-sample feedback loop in Python float64 while ours
is a float32 lax.scan on device (signals/jaxgen.py), and PCM16
quantisation rounds a handful of samples across the boundary.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

REFERENCE = "/root/reference"
REPO_ROOT = Path(__file__).resolve().parents[1]

ALL_WAVS = [
    "impulse.wav", "click.wav", "impulse_train.wav", "noise_long.wav",
    "noise_burst.wav", "sine_sustain.wav", "sine_burst.wav", "sweep.wav",
    "pluck.wav", "karplus_pluck.wav",
]

# (subdir, CLI args) — `all` plus parameterized single-signal variants
# (flag spellings are the reference's, gen/cli.py:121-536; ours are
# drop-in identical, tests/test_cli_flag_parity.py)
RUNS = [
    ("all", ["all"]),
    ("all_stereo", ["--channel_mode", "stereo", "sweep", "--duration_seconds", "1"]),
    ("sweep_custom", ["sweep", "--duration_seconds", "2", "--start-freq", "50",
                      "--end-freq", "15000", "--amplitude", "0.7",
                      "--fade_duration_seconds", "0.02",
                      "--pre_silence_seconds", "0.1", "--post_silence_seconds", "0.2"]),
]


def _run_gen(tmp: Path, which: str, out_sub: str, args) -> Path:
    out = tmp / which / out_sub
    if which == "reference":
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = REFERENCE
        cwd = tmp
    else:
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        cwd = REPO_ROOT
    subprocess.run(
        [sys.executable, "-m", "gen.cli", "--output-dir", str(out), *args],
        check=True, env=env, cwd=cwd, timeout=300, capture_output=True,
    )
    return out


@pytest.fixture(scope="module")
def gen_outputs(tmp_path_factory):
    if not Path(REFERENCE, "gen", "cli.py").exists():
        pytest.skip("reference tree not mounted")
    tmp = tmp_path_factory.mktemp("gen_parity")
    dirs = {}
    for sub, args in RUNS:
        dirs[sub] = (
            _run_gen(tmp, "reference", sub, args),
            _run_gen(tmp, "ours", sub, args),
        )
    return dirs


@pytest.mark.parametrize("wav", ALL_WAVS)
def test_default_tone_set_bytes(gen_outputs, wav):
    ref_dir, our_dir = gen_outputs["all"]
    ref_bytes = (ref_dir / wav).read_bytes()
    our_bytes = (our_dir / wav).read_bytes()
    if wav != "karplus_pluck.wav":
        assert our_bytes == ref_bytes, f"{wav}: not byte-identical to the reference tool"
        return
    # KS runs f32-on-device here vs the reference's f64 Python loop:
    # allow 1 LSB on a small fraction of samples, nothing more.
    sr_a, a = wavfile.read(ref_dir / wav)
    sr_b, b = wavfile.read(our_dir / wav)
    assert sr_a == sr_b and a.shape == b.shape
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.005


@pytest.mark.parametrize("sub", ["all_stereo", "sweep_custom"])
def test_parameterized_runs_bytes(gen_outputs, sub):
    ref_dir, our_dir = gen_outputs[sub]
    ref_files = sorted(p.name for p in ref_dir.glob("*.wav"))
    assert ref_files, "reference produced no output"
    assert sorted(p.name for p in our_dir.glob("*.wav")) == ref_files
    for name in ref_files:
        assert (our_dir / name).read_bytes() == (ref_dir / name).read_bytes(), name
