"""
No bare eager dispatches in the analysis path.

Un-jitted single-op dispatches (jax names them `jit(<primitive>)`) each
compile and launch a tiny program of their own, and their keys churn the
persistent compilation cache from run to run. All DSP glue must therefore live inside NAMED jitted programs
(ops/trim.shift_to / shift_bands_to, transport._pack_f32,
fftmask._packed_fft/banded_from_spectrum, modalcloud._bin_curves,
diffusion.stereo_diffusion_metrics_rows, ...). This test runs the four
analyses that historically carried eager glue in a fresh subprocess with
compile logging on and asserts that no known glue PRIMITIVE is compiled
as a bare program.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]

_WORKER = r"""
import logging, sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_log_compiles", True)

COMPILED = []


class Collect(logging.Filter):
    def filter(self, record):
        msg = record.getMessage()
        if "Finished XLA compilation of jit(" in msg:
            COMPILED.append(msg.split("jit(")[-1].split(")")[0])
        return True


logging.basicConfig(level=logging.WARNING)
for name in ("jax._src.dispatch", "jax._src.interpreters.pxla"):
    lg = logging.getLogger(name)
    lg.addFilter(Collect())
    lg.setLevel(logging.DEBUG)

from audio_analysis_tpu.analyses.decay import analyse_decay_from_wav_file
from audio_analysis_tpu.analyses.diffusion import analyse_diffusion_from_wav_file
from audio_analysis_tpu.analyses.modalcloud import analyse_modal_cloud_from_wav_file
from audio_analysis_tpu.analyses.rt60bands import analyse_rt60_bands_from_wav_file

wav = sys.argv[1]
analyse_decay_from_wav_file(wav)
analyse_rt60_bands_from_wav_file(wav)
analyse_modal_cloud_from_wav_file(wav)
analyse_diffusion_from_wav_file(wav)

# Bare single-op dispatch programs jax would name after the primitive.
# Named jitted helpers (shift_to, _pack_f32, ...) never collide with these.
GLUE_PRIMITIVES = {
    "concatenate",
    "iota",
    "argmax",
    "_argmax",
    "broadcast_in_dim",
    "add",
    "sub",
    "subtract",
    "mul",
    "multiply",
    "dynamic_slice",
    "slice",
    "squeeze",
    "transpose",
    "reshape",
    "convert_element_type",
    "reduce_max",
    "max",
    "minimum",
    "zeros_like",
    "scan",
    "gather",
    "where",
    "select_n",
}
bad = sorted(set(COMPILED) & GLUE_PRIMITIVES)
print("COMPILED_PROGRAMS:", sorted(set(COMPILED)))
if bad:
    print("EAGER_GLUE:", bad)
    sys.exit(1)
print("OK")
"""


def test_analysis_path_has_no_bare_eager_dispatches(tmp_path):
    from audio_analysis_tpu.io.wav import write_wav_pcm16

    sr, n = 48_000, 32_768
    t = np.arange(n) / sr
    rng = np.random.default_rng(7)
    env = 10.0 ** (-3.0 * t / 0.4)
    x = np.zeros((n, 2), np.float32)
    x[64:, :] = (0.05 * rng.standard_normal((n - 64, 2)) * env[: n - 64, None]).astype(
        np.float32
    )
    x[64, :] = 0.9
    wav = tmp_path / "ir.wav"
    write_wav_pcm16(wav, x, sr)

    env_vars = dict(os.environ)
    env_vars["JAX_PLATFORMS"] = "cpu"
    env_vars["PYTHONPATH"] = os.pathsep.join(
        filter(None, [env_vars.get("PYTHONPATH", ""), str(REPO_ROOT)])
    )

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    run = subprocess.run(
        [sys.executable, str(worker), str(wav)],
        env=env_vars,
        cwd=REPO_ROOT,
        capture_output=True,
        timeout=600,
    )
    assert run.returncode == 0, (
        run.stdout.decode()[-2000:] + run.stderr.decode()[-1000:]
    )
    assert "OK" in run.stdout.decode()
