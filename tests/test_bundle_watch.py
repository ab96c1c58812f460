"""Continuous bundle watching (report/watch.py + the watch CLI)."""

import numpy as np

from audio_analysis_tpu.io import write_bundle
from audio_analysis_tpu.report.watch import WatchSettings, watch_bundle_runs

SR = 48_000
N = 1 << 14


def _tap(rt60, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / SR
    x = np.zeros((N, 2), np.float32)
    x[10:, :] = 0.05 * rng.standard_normal((N - 10, 2)) * 10 ** (-3 * t[: N - 10, None] / rt60)
    x[10, :] = 0.9
    return x


def _fast_settings(**kw):
    return WatchSettings(poll_seconds=0.05, settle_seconds=0.0, **kw)


def test_watch_analyses_new_bundles_and_diffs_vs_previous(tmp_path):
    logs = []
    root = tmp_path / "runs"
    root.mkdir()
    write_bundle(root / "20260101_000000", {"tap": _tap(0.25)}, SR)

    written = watch_bundle_runs(root, _fast_settings(max_bundles=1), log=logs.append)
    assert len(written) == 1
    assert written[0].exists()
    assert (root / ".aa_watch_state.json").exists()
    assert any("analysed 20260101_000000" in line for line in logs)

    # second recorder run with a changed decay: analysed AND diffed vs run 1
    write_bundle(root / "20260101_000100", {"tap": _tap(0.35)}, SR)
    written2 = watch_bundle_runs(root, _fast_settings(max_bundles=1), log=logs.append)
    assert len(written2) == 1
    content = written2[0].read_text()
    assert "## Changes vs" in content
    assert "t30_rt60" in content
    assert any("changes vs previous" in line for line in logs)

    # one observability row per analysed bundle
    import json

    rows = [json.loads(l) for l in (root / "watch_log.jsonl").read_text().splitlines()]
    assert [r["bundle"] for r in rows] == ["20260101_000000", "20260101_000100"]
    assert rows[0]["flagged_changes"] == 0 and rows[1]["flagged_changes"] > 0
    assert rows[1]["compute_seconds"] > 0
    assert 0.2 < rows[0]["bundle_median_t30"] < 0.3  # the service headline
    assert 0.3 < rows[1]["bundle_median_t30"] < 0.4
    # long-run drift observability (the audio-chunk counters only exist on
    # the single-device cache path; this env runs the virtual mesh)
    assert all(r["rss_mb"] > 0 for r in rows)

    # nothing new: the stop callback bounds the idle loop
    polls = {"n": 0}

    def stop():
        polls["n"] += 1
        return polls["n"] > 2

    assert watch_bundle_runs(root, _fast_settings(), log=logs.append, stop=stop) == []


def test_watch_reanalyses_in_place_rerecordings_and_skips_incomplete(tmp_path):
    root = tmp_path / "runs"
    root.mkdir()
    bundle = root / "20260101_000000"
    write_bundle(bundle, {"tap": _tap(0.25)}, SR)

    # an incomplete sibling (no meta.json yet) is ignored, not crashed on
    half = root / "20260101_000200"
    (half / "taps").mkdir(parents=True)
    (half / "taps" / "tap.wav").write_bytes(b"partial")

    first = watch_bundle_runs(root, _fast_settings(max_bundles=1), log=lambda s: None)
    assert len(first) == 1

    # re-record the SAME bundle dir: new content signature => re-analysed
    write_bundle(bundle, {"tap": _tap(0.4)}, SR)
    second = watch_bundle_runs(root, _fast_settings(max_bundles=1), log=lambda s: None)
    assert len(second) == 1
    assert "## Changes vs" in second[0].read_text()


def test_watch_plots_renders_figures_alongside_metrics(tmp_path):
    """With plots enabled, each analysed bundle also gets the plot report
    in a sibling subdir; the engine index stays the primary output."""
    root = tmp_path / "runs"
    root.mkdir()
    write_bundle(root / "20260101_000000", {"tap": _tap(0.25)}, SR)

    settings = _fast_settings(max_bundles=1, plots=True)
    written = watch_bundle_runs(root, settings, log=lambda s: None)
    assert len(written) == 1
    plots_root = root / "20260101_000000" / "reports_plots"
    assert (plots_root / "bundle_report.md").exists()
    decay_png = plots_root / "tap" / "tap_decay.png"
    assert decay_png.exists()

    # re-record in place: figures must RE-RENDER (resume would keep the old
    # recording's curves next to the new metrics)
    before = decay_png.stat().st_mtime_ns
    write_bundle(root / "20260101_000000", {"tap": _tap(0.4)}, SR)
    watch_bundle_runs(root, settings, log=lambda s: None)
    assert decay_png.stat().st_mtime_ns > before


def test_watch_plots_rerenders_only_changed_taps(tmp_path):
    """Re-recording ONE tap of a bundle re-renders only that tap's figures;
    the others are reused from disk, and watch_log.jsonl records the
    rendered/skipped split (the iterate-loop figure-skip)."""
    import json

    from audio_analysis_tpu.io.wav import write_wav_pcm16

    root = tmp_path / "runs"
    root.mkdir()
    bundle = root / "20260101_000000"
    write_bundle(
        bundle, {"tapA": _tap(0.25), "tapB": _tap(0.3, seed=8), "tapC": _tap(0.35, seed=9)}, SR
    )

    settings = _fast_settings(max_bundles=1, plots=True)
    assert len(watch_bundle_runs(root, settings, log=lambda s: None)) == 1
    plots_root = bundle / "reports_plots"
    pngs = {t: plots_root / t / f"{t}_decay.png" for t in ("tapA", "tapB", "tapC")}
    assert all(p.exists() for p in pngs.values())
    before = {t: p.stat().st_mtime_ns for t, p in pngs.items()}

    # change ONLY tapB's audio (same shape; meta.json untouched)
    write_wav_pcm16(bundle / "taps" / "tapB.wav", _tap(0.5, seed=12), SR)

    assert len(watch_bundle_runs(root, settings, log=lambda s: None)) == 1
    after = {t: p.stat().st_mtime_ns for t, p in pngs.items()}
    assert after["tapB"] > before["tapB"]  # the changed tap re-rendered
    assert after["tapA"] == before["tapA"]  # the others were reused
    assert after["tapC"] == before["tapC"]

    rows = [json.loads(l) for l in (root / "watch_log.jsonl").read_text().splitlines()]
    assert rows[-1]["figures_rendered_taps"] == 1
    assert rows[-1]["figures_skipped_taps"] == 2
    assert rows[-2]["figures_rendered_taps"] == 3
    assert rows[-2]["figures_skipped_taps"] == 0
    # the index still lists every tap (unchanged ones as cached)
    index_text = (plots_root / "bundle_report.md").read_text()
    for t in ("tapA", "tapB", "tapC"):
        assert f"[{t}]" in index_text
    assert index_text.count("(cached)") == 2


def test_watch_retries_transient_failures_then_gives_up(tmp_path):
    """A failing bundle is retried up to max_failures_per_bundle on later
    polls (IO hiccups are transient), then given up on; a CONTENT change
    resets the attempt budget."""
    import json

    root = tmp_path / "runs"
    root.mkdir()
    bundle = root / "20260101_000000"
    write_bundle(bundle, {"tap": _tap(0.25)}, SR)
    # corrupt the tap AFTER meta.json exists: the bundle looks complete,
    # the engine load raises
    (bundle / "taps" / "tap.wav").write_bytes(b"garbage not a wav")

    logs = []
    polls = {"n": 0}

    def three_polls():
        polls["n"] += 1
        return polls["n"] > 3

    settings = _fast_settings(max_failures_per_bundle=2)
    assert watch_bundle_runs(root, settings, log=logs.append, stop=three_polls) == []
    attempts = [l for l in logs if l.startswith("FAILED")]
    assert len(attempts) == 2  # retried once, then gave up (not once per poll)
    assert "giving up" in attempts[-1]
    state = json.loads((root / ".aa_watch_state.json").read_text())
    assert state["failures"][str(bundle)]["count"] == 2

    # fixing the bundle (new content signature) clears the dead-end
    write_bundle(bundle, {"tap": _tap(0.25)}, SR)
    written = watch_bundle_runs(root, _fast_settings(max_bundles=1), log=logs.append)
    assert len(written) == 1
    state = json.loads((root / ".aa_watch_state.json").read_text())
    assert state["failures"] == {}


def test_watch_survives_corrupt_state_file(tmp_path):
    """A truncated/garbage .aa_watch_state.json (crash mid-write) resets
    the state instead of killing the service."""
    root = tmp_path / "runs"
    root.mkdir()
    (root / ".aa_watch_state.json").write_text("{corrupt json!!")
    write_bundle(root / "20260101_000000", {"tap": _tap(0.25)}, SR)
    written = watch_bundle_runs(root, _fast_settings(max_bundles=1), log=lambda s: None)
    assert len(written) == 1


def test_watch_picks_up_bundle_appearing_mid_poll(tmp_path):
    """A bundle written WHILE the watcher is polling is analysed on a later
    poll — the service behavior, not just the pre-existing-bundle case."""
    import threading
    import time

    root = tmp_path / "runs"
    root.mkdir()

    def writer():
        time.sleep(0.3)
        write_bundle(root / "20260101_000500", {"tap": _tap(0.3)}, SR)

    thread = threading.Thread(target=writer)
    thread.start()
    try:
        written = watch_bundle_runs(root, _fast_settings(max_bundles=1), log=lambda s: None)
    finally:
        thread.join()
    assert len(written) == 1
    assert "20260101_000500" in str(written[0])


def test_watch_cli_wiring(tmp_path, monkeypatch, capsys):
    """The watch subcommand builds WatchSettings from flags."""
    import audio_analysis_tpu.report as report_pkg
    from audio_analysis_tpu.cli import analyse_cli

    captured = {}

    def fake_watch(root, settings):
        captured["root"] = root
        captured["settings"] = settings
        return []

    monkeypatch.setattr(report_pkg, "watch_bundle_runs", fake_watch)
    analyse_cli.main(
        [
            "watch",
            "--input", str(tmp_path),
            "--interval", "0.5",
            "--bands", "octave",
            "--no-compare",
            "--max-bundles", "3",
        ]
    )
    assert captured["root"] == str(tmp_path)
    s = captured["settings"]
    assert s.poll_seconds == 0.5
    assert s.engine.config.band_mode == "octave"
    assert s.compare_to_previous is False
    assert s.max_bundles == 3
    capsys.readouterr()
