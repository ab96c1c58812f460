"""Native loader dtype coverage, JSON emission, timing utils, filter study."""

import json

import numpy as np
import pytest

from audio_analysis_tpu.io import load_wav_file, native

SR = 48_000


def test_ensure_built_yields_native_library():
    """A fresh checkout has no cpp/build/libaudioio.so; perf entry points
    call ensure_built() so they never silently measure the scipy fallback.
    The toolchain (g++, make) is part of the supported environment, so this
    must end with the library loadable."""
    assert native.ensure_built() is True
    assert native.available() is True


def test_ensure_built_caches_a_failed_build(monkeypatch):
    """A failed `make -C cpp` must be latched for the process: callers in a
    loop (hypothesis examples, per-test fixtures) would otherwise re-run a
    doomed, up-to-180 s build attempt every call (round-4 advisor)."""
    import subprocess

    calls = [0]

    def failing_run(*a, **k):
        calls[0] += 1
        raise subprocess.CalledProcessError(2, a[0])

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", True)  # available() False
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.delenv("AA_AUDIOIO_LIB", raising=False)
    monkeypatch.setattr(subprocess, "run", failing_run)

    assert native.ensure_built() is False
    assert native.ensure_built() is False
    assert native.ensure_built() is False
    assert calls[0] == 1, "make must run once, then the failure is latched"


def test_ensure_built_honors_explicit_override(monkeypatch):
    """AA_AUDIOIO_LIB means 'use exactly this library or fail loudly'
    (sanitizer campaigns); ensure_built must not rebuild/swap under it."""
    monkeypatch.setenv("AA_AUDIOIO_LIB", "/nonexistent/libaudioio.so")
    # no make invocation: just reports the current (already-loaded) state —
    # this file's import triggered the load, so the result is cached True
    assert native.ensure_built() is True


@pytest.mark.skipif(not native.available(), reason="native library not built")
class TestNativeLoader:
    def test_float32_wav(self, tmp_path):
        from scipy.io import wavfile

        x = (0.25 * np.sin(2 * np.pi * 500 * np.arange(4096) / SR)).astype(np.float32)
        p = tmp_path / "f32.wav"
        wavfile.write(str(p), SR, np.stack([x, -x], axis=1))
        rate, data = native.read_wav(p)
        assert rate == SR
        np.testing.assert_allclose(data[:, 0], x, atol=1e-7)
        np.testing.assert_allclose(data[:, 1], -x, atol=1e-7)

    def test_int32_wav(self, tmp_path):
        from scipy.io import wavfile

        x = (np.linspace(-0.9, 0.9, 1000) * 2147483647).astype(np.int32)
        p = tmp_path / "i32.wav"
        wavfile.write(str(p), SR, x)
        rate, data = native.read_wav(p)
        np.testing.assert_allclose(data, x.astype(np.float64) / 2147483648.0, atol=1e-6)

    def test_float64_wav(self, tmp_path):
        from scipy.io import wavfile

        x = np.linspace(-0.5, 0.5, 777)
        p = tmp_path / "f64.wav"
        wavfile.write(str(p), SR, x)
        rate, data = native.read_wav(p)
        np.testing.assert_allclose(data, x, atol=1e-6)

    def test_native_matches_scipy_via_loader(self, tmp_path):
        """load_wav_file must give identical results whichever path decodes."""
        from scipy.io import wavfile

        x = (np.random.default_rng(0).standard_normal((2048, 2)) * 0.2).astype(np.float32)
        p = tmp_path / "x.wav"
        wavfile.write(str(p), SR, (x * 32767).astype(np.int16))

        via_loader = load_wav_file(p, expected_channel_mode="stereo").samples
        sr2, raw = wavfile.read(str(p))
        expected = np.clip(raw.astype(np.float32) / 32768.0, -1, 1)
        np.testing.assert_allclose(via_loader, expected, atol=1e-7)

    def test_probe_error_on_garbage(self, tmp_path):
        p = tmp_path / "bad.wav"
        p.write_bytes(b"definitely not a wav")
        with pytest.raises(IOError):
            native.read_wav_info(p)

    def test_probe_rejects_huge_fmt_chunk(self, tmp_path):
        # A corrupt header claiming a ~4 GB fmt chunk must be rejected before
        # any allocation (cpp/audioio.cpp fmt cap), not crash or hang.
        import struct

        p = tmp_path / "hugefmt.wav"
        body = b"WAVE" + b"fmt " + struct.pack("<I", 0xFFFF0000) + b"\x00" * 32
        p.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
        with pytest.raises(IOError):
            native.read_wav_info(p)

    def test_probe_skips_odd_fmt_chunk_pad_byte(self, tmp_path):
        # Odd-sized fmt chunk: the RIFF pad byte must be skipped so the
        # following data chunk still parses.
        import struct

        frames, channels = 7, 1
        fmt_payload = struct.pack("<HHIIHH", 1, channels, 48000, 96000, 2, 16) + b"\x00"
        data = b"\x01\x00" * frames
        body = (
            b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt_payload)) + fmt_payload + b"\x00"
            + b"data" + struct.pack("<I", len(data)) + data
        )
        p = tmp_path / "oddfmt.wav"
        p.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
        got_frames, got_channels, got_rate = native.read_wav_info(p)
        assert (got_frames, got_channels, got_rate) == (frames, channels, 48000)

    def test_planar_i16_bundle_loader_matches_f32(self, tmp_path):
        # The PCM16 fast path must be a bit-exact /32768 away from the f32
        # loader (same padded layout, mono duplicated, lengths equal).
        from audio_analysis_tpu.io.bundle import (
            load_bundle_batch,
            load_bundle_batch_i16,
            write_bundle,
        )

        rng = np.random.default_rng(5)
        taps = {
            "stereo_tap": rng.standard_normal((5000, 2)).astype(np.float32) * 0.5,
            "mono_tap": rng.standard_normal(3000).astype(np.float32) * 0.5,
        }
        write_bundle(tmp_path, taps, SR)

        fast = load_bundle_batch_i16(tmp_path)
        assert fast is not None
        _, b16, l16, names16 = fast
        _, bf, lf, namesf = load_bundle_batch(tmp_path)
        assert names16 == namesf
        np.testing.assert_array_equal(l16, lf)
        assert b16.dtype == np.int16 and b16.shape == bf.shape
        np.testing.assert_allclose(b16.astype(np.float32) / 32768.0, bf, atol=0)

    def test_pure_python_header_probe(self, tmp_path):
        from scipy.io import wavfile

        from audio_analysis_tpu.io.wav import read_wav_header_info

        x = np.random.default_rng(3).standard_normal((1234, 2)).astype(np.float32)
        p = tmp_path / "probe.wav"
        wavfile.write(str(p), SR, (x * 32767).astype(np.int16))
        assert read_wav_header_info(p) == (1234, 2, SR)

    def test_mixed_format_bundle_falls_back_from_i16_pipeline(self, tmp_path):
        # A bundle whose FIRST tap is PCM16 but a later tap is IEEE-float
        # must be rejected by the pipelined i16 opener up front (None ->
        # caller uses the f32 loader) instead of raising mid-pipeline.
        from audio_analysis_tpu.io.bundle import open_bundle_chunks_i16, write_bundle
        from audio_analysis_tpu.io.wav import wav_is_plain_pcm16, write_wav_float32

        rng = np.random.default_rng(9)
        taps = {
            "a_pcm16": rng.standard_normal((2000, 2)).astype(np.float32) * 0.5,
            "b_float": rng.standard_normal((2000, 2)).astype(np.float32) * 0.5,
        }
        write_bundle(tmp_path, taps, SR)
        assert wav_is_plain_pcm16(tmp_path / "taps" / "a_pcm16.wav")

        # overwrite the SECOND tap (sorted order) as float32
        write_wav_float32(tmp_path / "taps" / "b_float.wav", taps["b_float"], SR)
        assert not wav_is_plain_pcm16(tmp_path / "taps" / "b_float.wav")

        assert open_bundle_chunks_i16(tmp_path) is None


def test_json_emission_roundtrip(tmp_path):
    from audio_analysis_tpu.analyses import decay
    from audio_analysis_tpu.utils import write_results_json

    n = 1 << 14
    t = np.arange(n) / SR
    x = (0.3 * np.exp(-3 * t / 0.3) * np.random.default_rng(1).standard_normal(n)).astype(
        np.float32
    )
    x[0] = 0.9
    result = decay.analyse_decay_for_channel(x, SR, "mono", decay.DecayAnalysisSettings())

    path = write_results_json(tmp_path / "r.json", [result])
    data = json.loads(path.read_text())
    assert data[0]["channel_name"] == "mono"
    assert abs(data[0]["fits"]["T30"]["rt60_seconds"] - result.fits["T30"].rt60_seconds) < 1e-9
    # big arrays are summarised, not inlined
    assert isinstance(data[0]["edc_db"], (dict, list))
    if isinstance(data[0]["edc_db"], dict):
        assert data[0]["edc_db"]["shape"] == [int(result.edc_db.size)]


def test_block_timer_markdown():
    import time as _time

    from audio_analysis_tpu.utils import BlockTimer

    timer = BlockTimer()
    with timer.block("a"):
        _time.sleep(0.01)
    with timer.block("b"):
        pass
    md = timer.as_markdown()
    assert "## Timing" in md and "| a |" in md and "| b |" in md
    assert timer.total_seconds() >= 0.01


def test_one_pole_filter_study():
    from audio_analysis_tpu.analyses.filter_response_study import attenuation_error_curves

    fc, err_exp, err_tan = attenuation_error_curves()
    # both mappings are near-exact at low fc and diverge measurably toward
    # Nyquist (the point of the study)
    low = fc < 1000
    assert np.all(np.abs(err_tan[low]) < 0.1)
    assert np.all(np.abs(err_exp[low]) < 0.1)
    assert np.abs(err_exp).max() > 0.5
    assert np.abs(err_tan).max() > 0.5


def test_wav_decode_cache(tmp_path):
    """Re-loading the same file hits the cache; rewriting invalidates it."""
    from audio_analysis_tpu.io import write_wav_pcm16
    from audio_analysis_tpu.io.wav import _RAW_CACHE

    p = tmp_path / "c.wav"
    write_wav_pcm16(p, np.ones(1000, np.float32) * 0.5, SR)
    a = load_wav_file(p, expected_channel_mode="mono_or_stereo")
    assert any(str(p) == k[0] for k in _RAW_CACHE)

    import os
    import time as _time

    _time.sleep(0.01)
    write_wav_pcm16(p, np.ones(1000, np.float32) * -0.5, SR)
    os.utime(p)
    b = load_wav_file(p, expected_channel_mode="mono_or_stereo")
    assert b.samples[0, 0] < 0 < a.samples[0, 0]


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_native_pcm24_decode(tmp_path):
    """Hand-crafted 24-bit PCM WAV decodes through the native path."""
    import struct

    frames = 64
    values = np.linspace(-0.8, 0.8, frames)
    ints = (values * 8388607).astype(np.int32)  # 24-bit full scale

    data = bytearray()
    for v in ints:
        data += int(v & 0xFFFFFF).to_bytes(3, "little", signed=False)

    fmt = struct.pack("<HHIIHH", 1, 1, SR, SR * 3, 3, 24)
    riff = (
        b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
        + b"fmt " + struct.pack("<I", 16) + fmt
        + b"data" + struct.pack("<I", len(data)) + bytes(data)
    )
    p = tmp_path / "p24.wav"
    p.write_bytes(riff)

    nframes, ch, rate = native.read_wav_info(p)
    assert (nframes, ch, rate) == (frames, 1, SR)
    rate2, decoded = native.read_wav(p)
    np.testing.assert_allclose(decoded, values, atol=2e-7)


def test_audioio_lib_override_fails_loudly():
    """An explicit AA_AUDIOIO_LIB that cannot be loaded must raise, not
    silently fall back to the repo-default library (a sanitizer campaign
    pointed at a stale path would otherwise test the wrong .so)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, AA_AUDIOIO_LIB="/nonexistent/libaudioio.so")
    src = (
        "from audio_analysis_tpu.io import native\n"
        "for attempt in range(2):\n"  # EVERY call fails loudly, not just the first
        "    try:\n"
        "        native.available()\n"
        "    except OSError as e:\n"
        "        print('raised ok:', attempt, e)\n"
        "    else:\n"
        "        raise SystemExit(f'override silently ignored on call {attempt}')"
    )
    run = subprocess.run(
        [sys.executable, "-c", src],
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert run.returncode == 0, run.stderr[-500:]
    assert "raised ok: 0" in run.stdout and "raised ok: 1" in run.stdout
