"""
Figure-template warmup: build every plot kind's live template (and
matplotlib's global first-draw caches — font manager, Agg raster state,
tight-bbox layout) BEFORE the first real tap renders.

The bundle runner submits this as the first plot-worker job, so the
per-kind template construction — about a second of host time for the
spectrogram alone (plot_timings.json first_job_seconds) — runs on the render
thread while the first tap's device compute is still in flight, instead of
serialising in front of it.

Mechanism: render a full report over a TINY synthetic stereo IR (24,576
samples at the real sample rate) with the same ReportSettings the bundle
will use, figures written to a throwaway directory. Using the real
analyses + render path (on the CPU backend — no accelerator contention,
and the persistent XLA cache makes the tiny-shape programs ~free after
the first container run) guarantees the warmup's template keys match the
real taps' keys structurally, forever: the keys are built from the exact
same settings dataclasses, sample rate and channel-name set
(tests/test_template_warmup.py pins reuse per kind).

Best-effort by contract: any failure is swallowed — the real render path
simply rebuilds its templates lazily like before.
"""

from __future__ import annotations

import shutil
import tempfile
from dataclasses import replace
from pathlib import Path


# set once a warmup report has completed in this process — the skip
# condition for repeat bundle runs (a watch service re-paid ~3 s per
# bundle otherwise). Deliberately NOT inferred from _FIGURE_TEMPLATES
# being non-empty: a prior single-file report leaves only ITS kinds'
# templates live, and skipping then would push the remaining kinds'
# builds back in front of the first real tap.
_WARMUP_DONE = False


def warmup_figure_templates(report_settings) -> None:
    """Render one tiny throwaway report inline on the calling (render)
    thread, populating the figure-template cache for every enabled kind."""
    global _WARMUP_DONE
    try:
        if _WARMUP_DONE:
            # a full warmup already ran in this process (later bundles in
            # the same service re-use its templates). If settings changed,
            # the real renders rebuild lazily exactly as before.
            return

        import jax
        import numpy as np

        from audio_analysis_tpu.io.wav import write_wav_pcm16
        from audio_analysis_tpu.report.report import ReportSettings, run_report_from_wav_file

        if report_settings is None:
            report_settings = ReportSettings()
        sr = int(report_settings.expected_sample_rate_hz)
        # 24,576 samples, rt60 250 ms: >= 18 frames for the waterfall's
        # default slice count, >= 10 modal fit frames inside the -5..-35 dB
        # window (the modal scatter must have points or its figure takes the
        # un-templated empty-panel path), and every decay fit range found —
        # so each kind's warmup figure has the same artist structure (line
        # counts, legend, scatter + median curve) as a real tap's.
        n = 24_576
        t = np.arange(n) / sr
        rng = np.random.default_rng(0)
        x = np.zeros((n, 2), np.float32)
        env = 10.0 ** (-3.0 * t / 0.25)
        x[64:, :] = (
            0.05 * rng.standard_normal((n - 64, 2)) * env[: n - 64, None]
        ).astype(np.float32)
        x[64, :] = 0.9

        inline = replace(
            report_settings,
            overlap_plotting=False,  # render on THIS thread (the template
            plot_processes=0,  # cache is per render thread/process)
            include_timing_footer=False,
            warmup_figure_templates=False,
        )
        tmp = Path(tempfile.mkdtemp(prefix="aa_tpu_template_warmup_"))
        try:
            wav = tmp / "warmup.wav"
            write_wav_pcm16(wav, x, sr)
            with jax.default_device(jax.devices("cpu")[0]):
                run_report_from_wav_file(wav, tmp / "out" / "warmup", settings=inline)
            _WARMUP_DONE = True
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    except Exception:  # noqa: BLE001 — warmup is strictly best-effort
        pass
