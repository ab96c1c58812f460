"""
Cross-tool parity against VENDORED REFERENCE OUTPUT.

tests/golden/reference/*.txt hold the actual text summaries printed by the
reference implementation (generated once by scripts/make_reference_fixtures.py
running /root/reference's NumPy/SciPy code on the frozen golden IR). This
test runs THIS framework on the same input and asserts the summaries agree:
same structure, numbers within per-module tolerances that account for the
documented behavioural differences (f32 device compute; padded-FFT bin grid
for fr/group-delay — see docs/MIGRATION.md).

Measured drift when vendoring (our stack on CPU): decay/rt60bands/
spectrogram/waterfall/modalcloud/diffusion byte-identical or 6th-decimal;
fr peak/centroid within 0.7 Hz; group delay within 4 samples of ~11k.
"""

import re
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

import golden_utils

FIXTURE_DIR = Path(__file__).parent / "golden" / "reference"

_ANY_NUM = re.compile(r"-?\d+(?:\.\d+)?")

# (rel_tol, abs_tol) per module; group delay and fr sit on a different
# (padded) FFT bin grid. Modal cloud measured byte-identical on CPU and
# within 1e-3 on an accelerator backend (one digit of one p90, identical
# point counts), so its tolerance is 1e-2 rel: tight
# enough that a reliability-gate point-count flip of more than ±1 fails,
# loose enough for cross-backend f32 drift with an order-of-magnitude
# margin.
TOLERANCES = {
    "decay": (1e-3, 1e-3),
    "rt60bands": (1e-3, 2e-3),
    "frequency_response": (5e-3, 1.0),
    "spectrogram": (1e-3, 0.5),
    "waterfall": (1e-3, 0.5),
    "modalcloud": (1e-2, 2e-3),
    "diffusion": (2e-2, 0.02),
    "group_delay": (2e-2, 5.0),
    "filterplot": (5e-3, 1.0),
}

# exact_grid=True runs the reference's exact FFT lengths in host float64 —
# the only remaining delta is the f32 WAV decode quantisation, so the
# printed summaries must agree to printed precision.
EXACT_TOLERANCES = {
    "frequency_response": (1e-6, 0.051),  # printed .1f: half an ulp of print
    "group_delay": (1e-6, 0.0051),  # printed .3f
    "filterplot": (1e-6, 0.051),  # printed .1f
}


@pytest.fixture(scope="module")
def golden_wav(tmp_path_factory):
    ir = golden_utils.make_golden_ir()
    path = tmp_path_factory.mktemp("refparity") / "golden_ir.wav"
    wavfile.write(str(path), golden_utils.SR, (np.clip(ir, -1, 1) * 32767.0).astype(np.int16))
    return str(path)


def _compare(name: str, ours: str, tolerances=None) -> None:
    ref = (FIXTURE_DIR / f"{name}.txt").read_text().rstrip()
    got = ours.rstrip()
    rel, abs_ = (tolerances or TOLERANCES)[name]

    ref_skel = [_ANY_NUM.sub("#", line) for line in ref.splitlines()]
    got_skel = [_ANY_NUM.sub("#", line) for line in got.splitlines()]
    assert ref_skel == got_skel, f"{name}: summary structure drifted from the reference tool"

    ref_nums = [float(v) for v in _ANY_NUM.findall(ref)]
    got_nums = [float(v) for v in _ANY_NUM.findall(got)]
    assert len(ref_nums) == len(got_nums)
    for i, (a, b) in enumerate(zip(ref_nums, got_nums)):
        tol = max(abs_, rel * max(abs(a), abs(b)))
        assert abs(a - b) <= tol, f"{name}: value {i} reference={a} ours={b} (tol {tol})"


def test_decay_matches_reference_output(golden_wav):
    from audio_analysis_tpu.analyses import decay

    _compare(
        "decay",
        decay.summarise_decay_results_text(decay.analyse_decay_from_wav_file(golden_wav)),
    )


def test_rt60bands_matches_reference_output(golden_wav):
    from audio_analysis_tpu.analyses import rt60bands

    _compare(
        "rt60bands",
        rt60bands.summarise_rt60_bands_results_text(
            rt60bands.analyse_rt60_bands_from_wav_file(golden_wav),
            include_t20=False,
            include_edt=False,
        ),
    )


def test_frequency_response_matches_reference_output(golden_wav):
    from audio_analysis_tpu.analyses import frequency_response as fr

    _compare(
        "frequency_response",
        fr.summarise_frequency_response_results_text(
            fr.analyse_frequency_response_from_wav_file(golden_wav)
        ),
    )


def test_spectrogram_matches_reference_output(golden_wav):
    from audio_analysis_tpu.analyses import spectrogram as sg

    _compare(
        "spectrogram",
        sg.summarise_spectrogram_results_text(sg.analyse_spectrogram_from_wav_file(golden_wav)),
    )


def test_waterfall_matches_reference_output(golden_wav):
    from audio_analysis_tpu.analyses import waterfall as wf

    _compare(
        "waterfall",
        wf.summarise_waterfall_results_text(wf.analyse_waterfall_from_wav_file(golden_wav)),
    )


def test_modalcloud_matches_reference_output(golden_wav):
    from audio_analysis_tpu.analyses import modalcloud as mc

    _compare(
        "modalcloud",
        mc.summarise_modal_cloud_results_text(mc.analyse_modal_cloud_from_wav_file(golden_wav)),
    )


def test_diffusion_matches_reference_output(golden_wav):
    from audio_analysis_tpu.analyses import diffusion as df

    _compare(
        "diffusion",
        df.summarise_diffusion_results_text(df.analyse_diffusion_from_wav_file(golden_wav)),
    )


def test_group_delay_matches_reference_output(golden_wav):
    from audio_analysis_tpu.analyses import group_delay as gd

    _compare(
        "group_delay",
        gd.summarise_group_delay_results_text(gd.analyse_group_delay_from_wav_file(golden_wav)),
    )


def test_filterplot_matches_reference_output(golden_wav):
    from audio_analysis_tpu.analyses import filterplot as fp

    _compare(
        "filterplot",
        fp.summarise_filter_response_results_text(
            fp.analyse_filter_response_from_wav_file(golden_wav, fp.FilterAnalysisSettings())
        ),
    )


# ---------------------------------------------------------------------------
# --exact-grid: the CPU float64 fallback at the reference's exact FFT
# lengths must agree with the reference tool to printed precision
# ---------------------------------------------------------------------------


def test_frequency_response_exact_grid(golden_wav):
    from audio_analysis_tpu.analyses import frequency_response as fr

    results = fr.analyse_frequency_response_from_wav_file(
        golden_wav, fr.FrequencyResponseAnalysisSettings(exact_grid=True)
    )
    _compare(
        "frequency_response",
        fr.summarise_frequency_response_results_text(results),
        tolerances=EXACT_TOLERANCES,
    )


def test_group_delay_exact_grid(golden_wav):
    from audio_analysis_tpu.analyses import group_delay as gd

    results = gd.analyse_group_delay_from_wav_file(
        golden_wav, gd.GroupDelayAnalysisSettings(exact_grid=True)
    )
    _compare(
        "group_delay",
        gd.summarise_group_delay_results_text(results),
        tolerances=EXACT_TOLERANCES,
    )


def test_filterplot_exact_grid(golden_wav):
    from audio_analysis_tpu.analyses import filterplot as fp

    results = fp.analyse_filter_response_from_wav_file(
        golden_wav, fp.FilterAnalysisSettings(exact_grid=True)
    )
    _compare(
        "filterplot",
        fp.summarise_filter_response_results_text(results),
        tolerances=EXACT_TOLERANCES,
    )
