"""
Regenerate the committed worked example: examples/gallery/.

Mirrors the reference's committed gallery (/root/reference/plots/example/
verb_report.md + PNGs — its de-facto regression artifact): one synthetic
"plate verb" stereo IR, its full report markdown and figure set, produced
by the ordinary report pipeline. Everything is deterministic (fixed seed,
host-numpy synthesis, CPU backend) so a fresh run reproduces the committed
markdown byte-for-byte — tests/test_example_gallery.py enforces that.

Usage: python scripts/make_example_gallery.py [output_dir]
       (default: examples/gallery/ — i.e. regenerate the committed one)
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

# runnable from anywhere: the repo root (this file's parent's parent) may
# not be on sys.path when invoked as `python scripts/make_example_gallery.py`
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# CPU-pinned (set before jax is imported): the committed markdown must
# regenerate identically on any machine, independent of accelerators
os.environ["JAX_PLATFORMS"] = "cpu"

SR = 48_000
N = 1 << 18  # 5.46 s — the longest band RT60 (2.2 s) fully decays in-buffer
SEED = 20260820
ONSET = 960  # 20 ms of pre-delay silence


def make_example_verb_ir() -> np.ndarray:
    """Deterministic stereo plate-verb-style IR (host numpy only).

    Frequency-dependent decay (low bands ring longer — the classic plate
    signature) + a handful of early reflections, decorrelated between
    channels, so every report block has realistic structure: distinct
    per-band T30s, a visible early/late transition, interaural decorrelation
    for the diffusion block, and a dense mode population for the modal cloud.
    """
    rng = np.random.default_rng(SEED)
    t = np.arange(N - ONSET) / SR

    # band edges (Hz) and their RT60s: lows ring ~3x longer than highs
    bands = [(20.0, 400.0, 2.2), (400.0, 3000.0, 1.4), (3000.0, SR / 2, 0.8)]
    freqs = np.fft.rfftfreq(N - ONSET, d=1.0 / SR)

    tail = np.zeros((N - ONSET, 2), np.float64)
    for lo, hi, rt60 in bands:
        mask = ((freqs >= lo) & (freqs < hi)).astype(np.float64)
        env = 10.0 ** (-3.0 * t / rt60)
        for ch in range(2):
            noise = rng.standard_normal(N - ONSET)
            band = np.fft.irfft(np.fft.rfft(noise) * mask, n=N - ONSET)
            tail[:, ch] += band * env

    # early reflections: sparse taps over the first 25 ms, lightly panned
    ir = np.zeros((N, 2), np.float64)
    for delay_ms, gain, pan in ((0.0, 1.0, 0.0), (7.1, 0.62, -0.3),
                                (11.3, 0.48, 0.35), (17.9, 0.36, -0.2),
                                (24.7, 0.27, 0.25)):
        i = ONSET + int(delay_ms * 1e-3 * SR)
        ir[i, 0] += gain * (1.0 - max(0.0, pan))
        ir[i, 1] += gain * (1.0 + min(0.0, pan))

    ir[ONSET:, :] += 0.11 * tail
    ir *= 0.9 / np.max(np.abs(ir))
    return ir.astype(np.float32)


def main() -> None:
    out_dir = Path(sys.argv[1] if len(sys.argv) > 1 else
                   Path(__file__).resolve().parents[1] / "examples" / "gallery")
    out_dir.mkdir(parents=True, exist_ok=True)

    from audio_analysis_tpu.io.wav import write_wav_pcm16
    from audio_analysis_tpu.report.report import run_report_from_wav_file

    ir = make_example_verb_ir()
    wav_path = out_dir / "verb_ir.wav"
    write_wav_pcm16(wav_path, ir, SR)

    # chdir so the markdown header records the stable relative input path
    # ("verb_ir.wav"), not wherever this checkout lives
    os.chdir(out_dir)
    results = run_report_from_wav_file(Path("verb_ir.wav"), Path("verb"))
    print(f"gallery written: {results.summary_markdown_path.resolve()}")
    pngs = sorted(p.name for p in out_dir.glob("*.png"))
    print(f"figures: {len(pngs)}: {', '.join(pngs)}")


if __name__ == "__main__":
    main()
