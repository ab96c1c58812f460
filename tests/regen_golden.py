"""Regenerate the golden report (run after intentional format changes)."""

import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

# the golden is a CPU artifact (set before jax is imported)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from tests.golden_utils import GOLDEN_DIR, SR, make_golden_ir  # noqa: E402


def main() -> None:
    from audio_analysis_tpu.io import write_wav_pcm16
    from audio_analysis_tpu.report import ReportSettings, run_report_from_wav_file

    GOLDEN_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        wav = Path(td) / "golden_ir.wav"
        write_wav_pcm16(wav, make_golden_ir(), SR)
        results = run_report_from_wav_file(wav, Path(td) / "golden", ReportSettings())
        (GOLDEN_DIR / "verb_report_golden.md").write_text(results.summary_markdown)
    print(f"wrote {GOLDEN_DIR / 'verb_report_golden.md'}")


if __name__ == "__main__":
    main()
