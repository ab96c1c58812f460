"""
Bundle runner: analyse a capture-bundle folder (meta.json + taps/*.wav).

Parity with analyse/bundle.py: per-tap report into
<bundle_root>/reports/<tap>/ and a bundle_report.md index (bundle.py:35-74).

Beyond the reference:
- per-tap failure isolation: one bad tap no longer kills the whole run
  (the reference aborts, bundle.py:56-68); failures are listed in the index;
- optional resume: skip taps whose report already exists;
- the batched fast path (engine.bundle) computes all tap metrics in one
  fused device program before plotting;
- tap sharding (`tap_shard="i/n"`): fan the host-bound plot rendering over
  independent processes/machines on a shared filesystem, then merge with
  one `--resume` pass.
"""

from __future__ import annotations

import json
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from audio_analysis_tpu.parallel.overlap import make_plot_worker
from audio_analysis_tpu.report.report import ReportSettings, run_report_from_wav_file


@dataclass(frozen=True)
class BundleRunSettings:
    reports_subdir: str = "reports"
    report_settings: Optional[ReportSettings] = None
    resume: bool = False  # skip taps with an existing report
    continue_on_error: bool = True
    # "i/n" (0-based): render only taps with index % n == i, for fanning a
    # plot bundle over independent processes/machines on a shared
    # filesystem (rendering is host-bound, ~seconds per tap on one core).
    # Shard runs write per-tap reports + a small shard summary but NOT the
    # bundle index; after every shard finishes, one `--resume` run (no
    # shard) finds each tap complete and writes the full index from cache.
    tap_shard: Optional[str] = None
    # When set, only these taps are (re-)rendered; every other tap is
    # treated as cached IF its report is complete (and rendered anyway if
    # not — safety beats skipping). The watch service passes the taps whose
    # WAV content changed since its last successful render, so a
    # re-recorded bundle that touched one tap redraws one tap's figures.
    render_only_taps: Optional[tuple] = None


def _parse_tap_shard(spec: str) -> tuple:
    try:
        index_text, count_text = spec.split("/", 1)
        shard_index, shard_count = int(index_text), int(count_text)
    except ValueError:
        raise ValueError(f"tap_shard must look like 'i/n' (0-based), got {spec!r}") from None
    if shard_count < 1 or not (0 <= shard_index < shard_count):
        raise ValueError(f"tap_shard {spec!r} needs 0 <= i < n")
    return shard_index, shard_count


import re as _re

_MD_IMAGE_RE = _re.compile(r"!\[[^\]]*\]\(([^)]+)\)")


def _report_complete(report_md: Path) -> bool:
    """A tap counts as done for --resume only if its markdown exists AND
    every PNG it embeds exists next to it. The markdown is written before
    the tap's figure jobs drain (they render on the shared worker while the
    next tap computes), so an interrupted or plot-failed run can leave an
    md whose images were never written — resuming must redo those taps,
    not mark them '(cached)' forever."""
    if not report_md.exists():
        return False
    try:
        text = report_md.read_text()
    except OSError:
        return False
    folder = report_md.parent
    return all((folder / name).exists() for name in _MD_IMAGE_RE.findall(text))


def run_bundle_report(
    bundle_root: str | Path, settings: Optional[BundleRunSettings] = None
) -> Path:
    if settings is None:
        settings = BundleRunSettings()

    bundle_root = Path(bundle_root)
    meta_path = bundle_root / "meta.json"
    if not meta_path.exists():
        raise ValueError(
            f"Not a capture bundle: {bundle_root} has no meta.json "
            "(expected the recorder layout: meta.json + taps/*.wav)"
        )
    meta = json.loads(meta_path.read_text())
    tap_names: List[str] = list(meta.get("taps", []))
    taps_dir = bundle_root / "taps"

    shard = _parse_tap_shard(settings.tap_shard) if settings.tap_shard else None
    if shard is not None:
        shard_index, shard_count = shard
        tap_names = [t for j, t in enumerate(tap_names) if j % shard_count == shard_index]

    reports_root = bundle_root / settings.reports_subdir
    reports_root.mkdir(parents=True, exist_ok=True)

    header_lines: List[str] = [
        "# IR Bundle Report\n",
        f"**Bundle:** `{bundle_root}`\n",
        f"**Sample rate:** {meta.get('sample_rate_hz')}\n",
        f"**Length (samples):** {meta.get('length_samples')}\n",
        "\n## Taps\n",
    ]
    # per-tap entries + the failures section — everything a shard summary
    # shares with the full index
    tap_lines: List[str] = []

    failures: List[str] = []

    # One shared plot worker for the whole bundle: tap k's figures render
    # while tap k+1's analyses dispatch to the device. Drained (with
    # per-job failure collection) after the loop.
    report_settings = settings.report_settings or ReportSettings()
    plot_worker = make_plot_worker(
        report_settings.overlap_plotting, report_settings.plot_processes
    )

    # Template warmup rides the worker as the job(s) before the first real
    # render: the per-kind template build (~seconds, see plot_timings.json
    # first_job_seconds) overlaps the first tap's device
    # compute instead of serialising in front of its figures. One job per
    # pool worker warms the whole pool; submitted lazily so a fully-cached
    # --resume run pays nothing. With a SYNCHRONOUS worker (no overlap
    # thread, no pool) there is nothing to overlap with — the warmup would
    # run serially in front of the first tap for zero gain, so it is off.
    warmup_pending = bool(report_settings.warmup_figure_templates) and (
        report_settings.overlap_plotting or int(report_settings.plot_processes) > 0
    )

    def _submit_warmup() -> None:
        from functools import partial as _partial

        from audio_analysis_tpu.report.warmup import warmup_figure_templates

        for _ in range(max(1, int(report_settings.plot_processes))):
            plot_worker.submit(
                _partial(warmup_figure_templates, report_settings), "template_warmup"
            )

    try:
        for tap in tap_names:
            wav_path = taps_dir / f"{tap}.wav"
            out_dir = reports_root / tap
            out_dir.mkdir(parents=True, exist_ok=True)
            report_md = out_dir / f"{tap}_report.md"

            unchanged = (
                settings.render_only_taps is not None
                and tap not in settings.render_only_taps
            )
            if (settings.resume or unchanged) and _report_complete(report_md):
                tap_lines.append(f"- [{tap}]({tap}/{report_md.name}) (cached)")
                continue

            if warmup_pending:
                warmup_pending = False
                _submit_warmup()

            try:
                run_report_from_wav_file(
                    input_wav_file_path=wav_path,
                    output_basename=out_dir / tap,
                    settings=settings.report_settings,
                    plot_worker=plot_worker,
                )
                # links are RELATIVE TO THE INDEX file (which lives inside
                # reports_subdir). The reference prefixes the subdir again
                # (bundle.py:70), so every link in its index resolves to
                # reports/reports/... and is broken in any markdown viewer
                # — a reference bug we fix, like the group-delay images
                # (MIGRATION.md).
                tap_lines.append(f"- [{tap}]({tap}/{report_md.name})")
            except Exception as exc:  # noqa: BLE001 — per-tap isolation by design
                if not settings.continue_on_error:
                    raise
                failures.append(tap)
                tap_lines.append(f"- {tap}: FAILED ({type(exc).__name__}: {exc})")
                (out_dir / "error.txt").write_text(traceback.format_exc())
    finally:
        # drain even when a tap raised, so no figure jobs keep writing PNGs
        # after this function has returned/raised
        plot_failures = plot_worker.drain_collect()
        plot_timings = plot_worker.timings_by_kind()
        plot_worker.close()

        # always written, INCLUDING error exits (an empty {} for a
        # fully-cached resume or a no-figure run), so a stale previous
        # run's costs can't masquerade as this run's; concurrent shards
        # each write their own file instead of clobbering one
        timings_name = (
            "plot_timings.json"
            if shard is None
            else f"plot_timings_shard{shard[0]}of{shard[1]}.json"
        )
        (reports_root / timings_name).write_text(
            json.dumps(
                {
                    kind: {
                        "seconds": round(seconds, 4),
                        "jobs": jobs,
                        # first job per kind pays the template build;
                        # steady-state is (seconds - first) / (jobs - 1)
                        "first_job_seconds": round(first, 4),
                        # CPU seconds spent ON the render thread/process:
                        # the stable per-kind attribution. `seconds` is
                        # wall clock and inflates with GIL/core contention
                        # from the main thread's numpy + decode work
                        # (docs/PERFORMANCE.md, plot path).
                        "cpu_seconds": round(cpu, 4),
                    }
                    for kind, (seconds, jobs, first, cpu) in plot_timings.items()
                },
                indent=1,
            )
            + "\n"
        )

    if plot_failures and not settings.continue_on_error:
        raise plot_failures[0][1]

    if failures or plot_failures:
        tap_lines.append("\n## Failures\n")
        for tap in failures:
            tap_lines.append(f"- {tap} (see {tap}/error.txt)")
        for label, exc in plot_failures:
            tap_lines.append(
                f"- plot rendering{f' ({label})' if label else ''}: "
                f"{type(exc).__name__}: {exc}"
            )

    if shard is not None:
        # a shard's tap list is incomplete by construction — write a small
        # shard summary instead of the bundle index; the merge pass
        # (`bundle --resume`, no shard) writes the real index from the
        # completed per-tap reports
        shard_path = reports_root / f"bundle_shard_{shard[0]}of{shard[1]}.md"
        shard_lines = [f"# IR Bundle Report — shard {shard[0]}/{shard[1]}\n"] + tap_lines
        shard_path.write_text("\n".join(shard_lines) + "\n")
        return shard_path

    index_path = reports_root / "bundle_report.md"
    index_path.write_text("\n".join(header_lines + tap_lines) + "\n")
    return index_path
