"""
The committed worked example (examples/gallery/ — the counterpart of the
reference's plots/example/verb_report.md gallery) must stay regenerable:
a fresh run of scripts/make_example_gallery.py reproduces the committed
markdown byte-for-byte and the exact committed figure set. This is the
gallery's regression contract — a drifted analysis or report format shows
up here as a markdown diff.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
GALLERY = REPO_ROOT / "examples" / "gallery"


def test_committed_gallery_matches_fresh_run(tmp_path):
    committed_md = GALLERY / "verb_report.md"
    assert committed_md.exists(), "committed gallery missing"
    committed_pngs = sorted(p.name for p in GALLERY.glob("*.png"))
    assert len(committed_pngs) >= 15, committed_pngs
    for name in committed_pngs:
        assert (GALLERY / name).stat().st_size > 1000, name

    env = dict(os.environ)
    run = subprocess.run(
        [sys.executable, str(REPO_ROOT / "scripts" / "make_example_gallery.py"),
         str(tmp_path)],
        env=env,
        cwd=REPO_ROOT,
        capture_output=True,
        timeout=580,
    )
    assert run.returncode == 0, run.stderr.decode()[-3000:]

    fresh_md = (tmp_path / "verb_report.md").read_text()
    assert fresh_md == committed_md.read_text(), (
        "examples/gallery/verb_report.md no longer matches a fresh run — "
        "if the analysis/report change is intentional, regenerate the "
        "gallery: python scripts/make_example_gallery.py"
    )
    fresh_pngs = sorted(p.name for p in tmp_path.glob("*.png"))
    assert fresh_pngs == committed_pngs
