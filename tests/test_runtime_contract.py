"""
How the program meets its machine: the compile cache location, meshes
that never fall back to another platform, CPU pinning through the
standard JAX_PLATFORMS, the engine paths without matplotlib, and
chip_smoke.py's refusal to run without a GPU and its comparison helper.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO_ROOT = Path(__file__).resolve().parents[1]


def _python(code: str, env_updates: dict, drop=(), cwd=REPO_ROOT, timeout=300):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO_ROOT), env.get("PYTHONPATH", "")]))
    env.update(env_updates)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


_CACHE_DIR = (
    "import jax, audio_analysis_tpu.ops as ops;"
    "print(jax.config.jax_compilation_cache_dir)"
)


def test_compile_cache_honours_jax_compilation_cache_dir(tmp_path):
    run = _python(_CACHE_DIR, {"JAX_PLATFORMS": "cpu",
                               "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cache")})
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip() == str(tmp_path / "cache")


def test_compile_cache_is_one_fixed_path_in_the_checkout(tmp_path):
    """Without JAX_COMPILATION_CACHE_DIR every process of a checkout uses
    <checkout>/.jax_cache, whatever its working directory."""
    seen = set()
    for cwd in (REPO_ROOT, tmp_path):
        run = _python(_CACHE_DIR, {"JAX_PLATFORMS": "cpu"},
                      drop=("JAX_COMPILATION_CACHE_DIR",), cwd=cwd)
        assert run.returncode == 0, run.stderr[-2000:]
        seen.add(run.stdout.strip())
    assert seen == {str(REPO_ROOT / ".jax_cache")}


def test_make_mesh_raises_when_devices_are_missing():
    import jax

    from audio_analysis_tpu.engine import make_mesh

    available = len(jax.devices("cpu"))
    assert make_mesh(num_devices=available, platform="cpu").shape["taps"] == available
    with pytest.raises(ValueError, match=f"Requested {available + 1} devices"):
        make_mesh(num_devices=available + 1, platform="cpu")
    with pytest.raises(ValueError, match="Requested"):
        make_mesh(num_devices=len(jax.devices()) + 1)


def test_jax_platforms_pins_the_cli(tmp_path):
    """The standard JAX_PLATFORMS=cpu is all a host-only CLI run needs."""
    code = (
        "import sys, jax\n"
        "from audio_analysis_tpu.cli import gen_cli\n"
        f"gen_cli.main(['--output-dir', {str(tmp_path)!r}, 'karplus_pluck'])\n"
        "print('platform', jax.default_backend(), jax.config.jax_platforms)\n"
    )
    run = _python(code, {"JAX_PLATFORMS": "cpu"})
    assert run.returncode == 0, run.stderr[-2000:]
    assert "platform cpu cpu" in run.stdout
    assert list(tmp_path.glob("*.wav"))


def test_bundle_no_plots_runs_without_matplotlib(tmp_path):
    """The engine path imports nothing that plots: with matplotlib (and
    Pillow) unimportable, `analyse.cli bundle --no-plots` completes, and a
    plot path fails with an error that names matplotlib."""
    root = tmp_path / "bundle"
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import chip_smoke\n"
        "chip_smoke.RT60_RANGE = (0.1, 0.2)\n"
        f"names = chip_smoke.make_bundle(__import__('pathlib').Path({str(root)!r}), 3, 1 << 14)\n"
        "from audio_analysis_tpu.cli import analyse_cli\n"
        f"analyse_cli.main(['bundle', '--input', {str(root)!r}, '--no-plots'])\n"
        "assert not any(m.startswith('matplotlib') and sys.modules[m] is not None for m in sys.modules)\n"
        "try:\n"
        f"    analyse_cli.main(['decay', '--input', {str(root / 'taps' / 'tap00.wav')!r}, '--no_show'])\n"
        "except ImportError as exc:\n"
        "    print('plot path:', exc)\n"
    )
    run = _python(code, {"JAX_PLATFORMS": "cpu"})
    assert run.returncode == 0, run.stderr[-3000:]
    metrics = json.loads((root / "reports" / "bundle_metrics.json").read_text())
    assert metrics["taps"] == ["tap00", "tap01", "tap02"]
    assert "plot path: The plot paths need matplotlib" in run.stdout


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    run = subprocess.run(
        [sys.executable, str(REPO_ROOT / "chip_smoke.py")],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
    assert "no GPU" in run.stderr


def _small_batch():
    import chip_smoke

    rng60 = (0.1, 0.2)
    taps = [chip_smoke.synth_tap(rt, 1 << 14, (1, i)) for i, rt in enumerate(rng60)]
    batch = np.stack([np.round(t.T * 32767.0) for t in taps]).astype(np.int16)
    return batch, np.full(2, 1 << 14, np.int32)


def test_chip_smoke_comparison_passes_on_a_small_cpu_batch(capsys):
    import chip_smoke
    from audio_analysis_tpu.engine import EngineConfig

    batch, lengths = _small_batch()
    assert chip_smoke.engine_vs_oracle(batch, lengths, EngineConfig()) == []
    assert chip_smoke.engine_vs_cpu(batch, lengths, EngineConfig()) == []
    out = capsys.readouterr().out
    assert "correctness vs oracle t30_rt60" in out and "FAIL" not in out


def test_chip_smoke_comparison_fails_on_a_perturbed_metric(capsys):
    import chip_smoke
    from audio_analysis_tpu.engine import EngineConfig
    from audio_analysis_tpu.engine.batch import analyze_batch

    batch, lengths = _small_batch()
    ref = {k: np.asarray(v) for k, v in analyze_batch(batch, lengths, EngineConfig()).items()}
    got = dict(ref)
    tol = chip_smoke.CPU_TOLERANCES["gd_median"]
    got["gd_median"] = ref["gd_median"] + 2.0 * (tol.abs + tol.rel * np.abs(ref["gd_median"]))
    failed = chip_smoke.compare(got, ref, chip_smoke.CPU_TOLERANCES, "perturbed")
    assert failed == ["gd_median"]
    # NaN on one side only is a miss, NaN on both sides is agreement
    worst, ratio = chip_smoke.deviation([np.nan, 1.0], [0.0, 1.0], tol)
    assert ratio == np.inf
    assert chip_smoke.deviation([np.nan], [np.nan], tol) == (0.0, 0.0)
    assert "perturbed gd_median" in capsys.readouterr().out
