"""
Reproducible cross-tool parity report.

Runs the SAME settings-variant matrix the test suite pins
(tests/parity_matrix.py) against a reference-tool checkout and prints a
markdown table: per variant, the worst relative numeric deviation between
the reference's summary and this framework's, plus the gen-CLI byte
comparison. Lets anyone regenerate the parity evidence with their own
checkout:

    python scripts/parity_report.py [--reference /root/reference]

The test-suite equivalents (same plumbing, assertive):
tests/test_reference_parity_matrix.py, tests/test_gen_cli_reference_parity.py.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))  # the package itself (script dir != repo root)
sys.path.insert(0, str(REPO / "tests"))

_ANY_NUM = re.compile(r"-?\d+(?:\.\d+)?")


def worst_rel_diff(ref: str, got: str):
    """(worst relative deviation, structural match) over the summary numbers."""
    ref_skel = [_ANY_NUM.sub("#", line) for line in ref.rstrip().splitlines()]
    got_skel = [_ANY_NUM.sub("#", line) for line in got.rstrip().splitlines()]
    if ref_skel != got_skel:
        return float("inf"), False
    worst = 0.0
    for a, b in zip(_ANY_NUM.findall(ref), _ANY_NUM.findall(got)):
        a, b = float(a), float(b)
        scale = max(abs(a), abs(b), 1e-9)
        worst = max(worst, abs(a - b) / scale)
    return worst, True


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reference", default="/root/reference")
    args = parser.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import golden_utils
    import parity_matrix
    from scipy.io import wavfile

    from test_reference_parity import TOLERANCES
    from test_reference_parity_matrix import ANALYSE_FNS

    import importlib

    with tempfile.TemporaryDirectory(prefix="parity_report_") as tmpdir:
        tmp = Path(tmpdir)
        wavs = {}
        for key, ir in (
            ("noise", golden_utils.make_golden_ir()),
            ("modal", parity_matrix.make_modal_ir()),
            ("damped", parity_matrix.make_damped_ir()),
            ("oddmono", parity_matrix.make_oddmono_ir()),
            ("sweep", parity_matrix.make_sweep()[:, None]),
            ("recorded", parity_matrix.make_recorded(golden_utils.make_golden_ir())),
        ):
            path = tmp / f"{key}.wav"
            wavfile.write(str(path), parity_matrix.SR,
                          (np.clip(ir, -1, 1) * 32767.0).astype(np.int16))
            wavs[key] = str(path)

        out_json = tmp / "reference.json"
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["MPLBACKEND"] = "Agg"
        subprocess.run(
            [sys.executable, str(REPO / "tests" / "_reference_matrix_runner.py"),
             "--reference", args.reference,
             "--noise-wav", wavs["noise"], "--modal-wav", wavs["modal"],
             "--damped-wav", wavs["damped"], "--oddmono-wav", wavs["oddmono"],
             "--sweep-wav", wavs["sweep"],
             "--recorded-wav", wavs["recorded"],
             "--deconv-dir", str(tmp / "deconv"), "--out", str(out_json)],
            check=True, env=env, timeout=900,
        )
        reference = json.loads(out_json.read_text())

        print("# Cross-tool parity report\n")
        print(f"Reference: `{args.reference}`  |  "
              f"backend: `{os.environ.get('JAX_PLATFORMS') or 'device default'}`\n")
        print("| variant | module | input | worst rel diff | tol (rel) | status |")
        print("|---|---|---|---|---|---|")
        failures = 0
        for variant in parity_matrix.VARIANTS:
            mod_name, analyse_name, settings_name, summarise_name = (
                ANALYSE_FNS[variant["module"]]
            )
            mod = importlib.import_module(f"audio_analysis_tpu.analyses.{mod_name}")
            kwargs = parity_matrix.settings_kwargs(variant)
            kwargs.update(variant.get("ours_extra", {}))
            results = getattr(mod, analyse_name)(
                wavs[variant["input"]], getattr(mod, settings_name)(**kwargs)
            )
            ours = getattr(mod, summarise_name)(results, **variant.get("summary", {}))
            worst, structural = worst_rel_diff(reference[variant["name"]], ours)
            rel, _ = variant.get("tol") or TOLERANCES[variant["module"]]
            ok = structural and worst <= max(rel, 1e-9) * 10  # abs-tol slack
            status = "PASS" if ok else "CHECK"
            failures += 0 if ok else 1
            print(f"| {variant['name']} | {variant['module']} | {variant['input']} "
                  f"| {worst:.2e} | {rel:g} | {status} |")

        from audio_analysis_tpu.analyses import deconvolve as dc

        for variant in parity_matrix.DECONVOLVE_VARIANTS:
            ours_path = tmp / f"{variant['name']}_ours.wav"
            dc.deconvolve_from_wav_files(
                wavs["recorded"], wavs["sweep"],
                dc.DeconvolveSettings(**variant["settings"]),
                output_ir_wav_file_path=ours_path,
            )
            _, ref = wavfile.read(reference[f"deconvolve:{variant['name']}"])
            _, got = wavfile.read(str(ours_path))
            peak = max(np.abs(ref).max(), 1e-12)
            worst = float(np.abs(got - ref).max() / peak)
            ok = ref.shape == got.shape and worst <= 2e-4
            print(f"| dc:{variant['name']} | deconvolve | sweep+recorded "
                  f"| {worst:.2e} of peak | 0.0002 | {'PASS' if ok else 'CHECK'} |")
            failures += 0 if ok else 1

        print(f"\n{'All rows PASS.' if failures == 0 else f'{failures} rows need a look.'}")
        sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
