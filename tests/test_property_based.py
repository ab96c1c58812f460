"""
Property-based tests (hypothesis): randomised inputs for the precision-
critical kernels and fuzzed bytes for the untrusted-input WAV parsers.

Example counts are kept small: kernel cases run on the default backend
(one compile and fetch per case), parser cases are host-only and cheap.
"""

import io
import struct

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings as hsettings
from hypothesis import strategies as st

from audio_analysis_tpu import oracle

SR = 48_000


# ----------------------------------------------------------------------------
# kernels vs oracle on randomised decays
# ----------------------------------------------------------------------------


@hsettings(max_examples=8, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    rt60=st.floats(min_value=0.05, max_value=3.0),
    onset=st.integers(min_value=0, max_value=2000),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
)
def test_edc_t30_matches_oracle_on_random_decays(rt60, onset, seed):
    import jax.numpy as jnp

    from audio_analysis_tpu.ops import dbfit, edc

    n = 1 << 15
    rng = np.random.default_rng(seed)
    t = np.arange(n - onset) / SR
    x = np.zeros(n, np.float32)
    x[onset:] = (0.1 * rng.standard_normal(n - onset) * 10.0 ** (-3.0 * t / rt60)).astype(
        np.float32
    )
    x[onset] = 0.9

    seg = x[onset:].astype(np.float64)
    t_o, edc_o, _ = oracle.schroeder_edc_db(seg, SR)
    fit_o = oracle.fit_decay_slope(t_o, edc_o, (-5.0, -35.0))

    seg32 = np.zeros(n, np.float32)
    seg32[: seg.size] = seg
    curve = edc.schroeder_edc_db(
        jnp.asarray(seg32[None, :]), jnp.asarray(np.array([seg.size], np.int32))
    )
    fit_k = dbfit.fit_decay_slope_over_db_range(
        curve.edc_db, curve.length, (-5.0, -35.0), -80.0, SR
    )

    if fit_o is None:
        # short/fast decays may not reach the range — kernel must agree
        assert not bool(np.asarray(fit_k.ok)[0])
    else:
        assert bool(np.asarray(fit_k.ok)[0])
        rt_k = float(np.asarray(fit_k.rt60_seconds)[0])
        assert rt_k == pytest.approx(float(fit_o[3]), rel=2e-3)


# ----------------------------------------------------------------------------
# WAV header parsers under fuzzed headers (must raise/return, never hang,
# never mis-parse a valid layout)
# ----------------------------------------------------------------------------


def _wav_bytes(chunks: list) -> bytes:
    body = b"WAVE" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _chunk(cid: bytes, payload: bytes) -> bytes:
    return cid + struct.pack("<I", len(payload)) + payload + (b"\x00" if len(payload) & 1 else b"")


@hsettings(max_examples=60, deadline=None)
@given(data=st.binary(min_size=0, max_size=256))
def test_header_probe_never_crashes_on_fuzz(tmp_path_factory, data):
    from audio_analysis_tpu.io.wav import read_wav_header_info

    path = tmp_path_factory.mktemp("fuzz") / "f.wav"
    path.write_bytes(b"RIFF" + data)
    try:
        frames, channels, rate = read_wav_header_info(path)
        assert frames >= 0 and channels > 0 and rate >= 0
    except (ValueError, struct.error):
        pass  # rejection is the expected outcome for malformed input


@hsettings(max_examples=20, deadline=None)
@given(
    n_junk=st.integers(min_value=0, max_value=3),
    junk_len=st.integers(min_value=0, max_value=33),
    frames=st.integers(min_value=1, max_value=64),
    channels=st.integers(min_value=1, max_value=2),
)
def test_header_probe_parses_valid_layouts_with_junk_chunks(
    tmp_path_factory, n_junk, junk_len, frames, channels
):
    from audio_analysis_tpu.io.wav import read_wav_header_info

    fmt = struct.pack("<HHIIHH", 1, channels, SR, SR * channels * 2, channels * 2, 16)
    data = b"\x01\x00" * (frames * channels)
    chunks = [_chunk(b"JUNK", b"j" * junk_len) for _ in range(n_junk)]
    chunks += [_chunk(b"fmt ", fmt), _chunk(b"data", data)]
    path = tmp_path_factory.mktemp("valid") / "v.wav"
    path.write_bytes(_wav_bytes(chunks))

    got = read_wav_header_info(path)
    assert got == (frames, channels, SR)

    from audio_analysis_tpu.io import native

    if native.ensure_built():  # builds cpp/ on a fresh container
        assert native.read_wav_info(path) == (frames, channels, SR)


def test_loader_normalises_scipy_internal_errors(tmp_path):
    """Malformed WAVs must raise IOError/ValueError from load_wav_file, not
    scipy internals (fuzzed: UnboundLocalError on a RIFF file with no fmt
    chunk; ZeroDivisionError on zero channels/bits)."""
    from audio_analysis_tpu.io.wav import load_wav_file

    cases = {
        # RIFF/WAVE container with garbage where the chunks should be
        "no_fmt.wav": b"RIFF" + struct.pack("<I", 40) + b"WAVE" + b"\x01" * 36,
        # fmt chunk declaring zero channels and zero bits
        "zero_ch.wav": (
            b"RIFF" + struct.pack("<I", 36 + 4) + b"WAVE"
            + b"fmt " + struct.pack("<I", 16)
            + struct.pack("<HHIIHH", 1, 0, 48000, 0, 0, 0)
            + b"data" + struct.pack("<I", 4) + b"\x00" * 4
        ),
    }
    for name, data in cases.items():
        p = tmp_path / name
        p.write_bytes(data)
        with pytest.raises((IOError, ValueError)):
            load_wav_file(p, expected_channel_mode="mono_or_stereo")


@hsettings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_bundle_comparison_never_crashes_and_is_deterministic(data):
    """format_bundle_comparison over randomised metrics dicts: arbitrary
    tap sets, NaN/inf values, flag flips, shape changes — always returns a
    string, deterministically, and flags a change iff one was injected
    above both thresholds."""
    import math

    from audio_analysis_tpu.report.compare import (
        count_flagged_in_text,
        format_bundle_comparison,
    )

    n_taps = data.draw(st.integers(1, 4))
    taps = [f"tap{i}" for i in range(n_taps)]
    channels = data.draw(st.sampled_from([["mono"], ["left", "right"]]))
    c = len(channels)

    def values(lo=0.01, hi=100.0):
        return data.draw(
            st.lists(
                st.lists(
                    st.one_of(
                        st.floats(lo, hi),
                        st.just(float("nan")),
                        st.just(float("inf")),
                    ),
                    min_size=c,
                    max_size=c,
                ),
                min_size=n_taps,
                max_size=n_taps,
            )
        )

    prev = {
        "taps": taps,
        "channels": channels,
        "metrics": {"t30_rt60": values(), "fr_peak_hz": values(20.0, 20000.0)},
    }
    import copy

    cur = copy.deepcopy(prev)
    inject = data.draw(st.booleans())
    if inject:
        row = data.draw(st.integers(0, n_taps - 1))
        col = data.draw(st.integers(0, c - 1))
        old = cur["metrics"]["t30_rt60"][row][col]
        if math.isfinite(old):
            cur["metrics"]["t30_rt60"][row][col] = old * 2.0 + 1.0  # >> thresholds

    text1 = format_bundle_comparison(cur, prev, threshold_pct=1.0)
    text2 = format_bundle_comparison(cur, prev, threshold_pct=1.0)
    assert text1 == text2  # deterministic
    flagged = count_flagged_in_text(text1)
    old = prev["metrics"]["t30_rt60"]
    if inject and math.isfinite(old[row][col]):
        assert flagged >= 1, text1
    elif not inject:
        assert flagged == 0, text1
