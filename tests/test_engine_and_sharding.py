"""Fused engine correctness + multi-device sharding (virtual CPU mesh)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from audio_analysis_tpu.engine import EngineConfig, analyze_bundle, analyze_batch_sharded, make_mesh
from audio_analysis_tpu.engine.batch import analyze_batch, analyze_batch_flat, _flat_spec, unpack_flat


SR = 48_000


@pytest.fixture(scope="module")
def tap_batch():
    """8 synthetic taps with RT60 = 0.25 + 0.05*i."""
    n = 1 << 15
    rng = np.random.default_rng(0)
    t = np.arange(n) / SR
    batch = np.zeros((8, 2, n), np.float32)
    for i in range(8):
        rt60 = 0.25 + 0.05 * i
        env = 10.0 ** (-3.0 * t / rt60)
        batch[i, :, 100:] = 0.05 * rng.standard_normal((2, n - 100)) * env[: n - 100]
        batch[i, :, 100] = 0.9
    lengths = np.full(8, n, np.int32)
    return batch, lengths


def test_engine_recovers_per_tap_rt60(tap_batch):
    batch, lengths = tap_batch
    out = analyze_bundle(batch, lengths, EngineConfig(), chunk_taps=4)
    expected = 0.25 + 0.05 * np.arange(8)
    assert np.all(out["t30_ok"])
    np.testing.assert_allclose(out["t30_rt60"][:, 0], expected, rtol=0.05)
    np.testing.assert_allclose(out["t30_rt60"][:, 1], expected, rtol=0.05)
    assert np.all(out["start_index"] == 100)


def test_engine_matches_single_file_analyses(tap_batch):
    """The fused engine must agree with the per-file analysis modules."""
    from audio_analysis_tpu.analyses import decay

    batch, lengths = tap_batch
    out = analyze_bundle(batch, lengths, EngineConfig(), chunk_taps=8)

    results = decay.analyse_decay_for_channel(
        batch[3, 0], SR, "left", decay.DecayAnalysisSettings(compute_edt=True)
    )
    assert abs(out["t30_rt60"][3, 0] - results.fits["T30"].rt60_seconds) < 1e-3
    assert abs(out["t20_rt60"][3, 0] - results.fits["T20"].rt60_seconds) < 1e-3
    assert (
        abs(out["early10_time"][3, 0] - results.early_decay_10db_time_seconds) < 1e-4
    )

    from audio_analysis_tpu.analyses import frequency_response, group_delay, rt60bands

    fr = frequency_response.analyse_frequency_response_for_channel(
        batch[3, 0], SR, "left", frequency_response.FrequencyResponseAnalysisSettings()
    )
    assert abs(out["fr_peak_hz"][3, 0] - fr.peak_frequency_hz) < 1.0
    assert abs(out["fr_centroid_hz"][3, 0] - fr.spectral_centroid_hz) / fr.spectral_centroid_hz < 0.01

    bands = rt60bands.analyse_rt60_bands_for_channel(
        batch[3, 0], SR, "left", rt60bands.Rt60BandsAnalysisSettings()
    )
    for bi, name in enumerate(("Low", "Mid", "High")):
        module_rt = bands.band_metrics_by_name[name].rt60_t30_seconds
        engine_ok = bool(out["band_t30_ok"][3, 0, bi])
        assert engine_ok == (module_rt is not None)
        if module_rt is not None:
            assert abs(out["band_t30_rt60"][3, 0, bi] - module_rt) / module_rt < 0.01

    gd = group_delay.analyse_group_delay_for_channel(
        batch[3, 0], SR, "left", group_delay.GroupDelayAnalysisSettings()
    )
    module_median = float(np.median(gd.group_delay_samples))
    assert abs(out["gd_median"][3, 0] - module_median) < max(2.0, 0.02 * abs(module_median))


def test_flat_packing_roundtrip(tap_batch):
    batch, lengths = tap_batch
    config = EngineConfig(run_modal=False)
    ref = analyze_batch(jnp.asarray(batch[:2]), jnp.asarray(lengths[:2]), config)
    flat = analyze_batch_flat(jnp.asarray(batch[:2]), jnp.asarray(lengths[:2]), config)
    spec = _flat_spec(batch[:2].shape, (2,), config)
    unpacked = unpack_flat(np.asarray(flat), spec)
    assert set(unpacked) == set(ref)
    for k in ref:
        np.testing.assert_allclose(
            unpacked[k].astype(np.float32),
            np.asarray(ref[k]).astype(np.float32),
            atol=1e-5,
            err_msg=k,
        )


def test_ragged_lengths(tap_batch):
    """Shorter taps (padding) must produce the same metrics as exact-size runs."""
    batch, lengths = tap_batch
    n = batch.shape[-1]
    short = n // 2
    padded = batch.copy()
    padded[0, :, short:] = 0.0
    lengths2 = lengths.copy()
    lengths2[0] = short

    config = EngineConfig(run_modal=False, run_stft=False, run_diffusion=False)
    out = analyze_bundle(padded, lengths2, config, chunk_taps=8)

    exact = analyze_bundle(
        np.ascontiguousarray(batch[:1, :, :short]),
        np.array([short], np.int32),
        config,
        chunk_taps=1,
    )
    assert abs(out["t30_rt60"][0, 0] - exact["t30_rt60"][0, 0]) < 2e-3


def test_sharded_engine_matches_unsharded(tap_batch):
    batch, lengths = tap_batch
    mesh = make_mesh(num_devices=min(8, len(jax.devices("cpu"))), platform="cpu")
    config = EngineConfig(run_modal=False)

    sharded = analyze_batch_sharded(mesh, batch, lengths, config)
    local = analyze_bundle(batch, lengths, config, chunk_taps=8)

    # sharded runs on the CPU mesh, local on the default backend:
    # cross-backend f32 tolerance
    np.testing.assert_allclose(
        np.asarray(sharded["t30_rt60"]), local["t30_rt60"], rtol=1e-3
    )
    assert np.isfinite(float(sharded["bundle_median_t30"]))
    assert int(sharded["bundle_valid_taps"]) == 8


def test_sharded_engine_bands_decimate_matches_unsharded(tap_batch):
    """The spectrum-crop decimated bands path must survive shard_map: the
    per-band decimation groups are static per config, so each shard traces
    the same grouped program."""
    batch, lengths = tap_batch
    mesh = make_mesh(num_devices=min(8, len(jax.devices("cpu"))), platform="cpu")
    config = EngineConfig(
        run_modal=False, run_stft=False, run_diffusion=False, bands_decimate=True
    )

    from audio_analysis_tpu.engine.batch import _band_masks
    from audio_analysis_tpu.ops import fftmask

    n = batch.shape[-1]
    factors = fftmask.band_decimation_factors(_band_masks(config, n), n)
    assert factors != (1,) * len(factors), "fixture too short to exercise decimation"

    sharded = analyze_batch_sharded(mesh, batch, lengths, config)
    # reference on the SAME backend as the mesh: this test pins shard_map
    # STRUCTURE (per-shard tracing of the static decimation groups), and
    # decimated narrowband fits amplify cross-backend f32 accumulation
    # differences beyond any fixed tolerance (the fit-sensitivity finding,
    # docs/PERFORMANCE.md) — a cross-backend comparison here flaked at
    # 0.125% vs rtol 1e-3 with both sides individually correct
    with jax.default_device(jax.devices("cpu")[0]):
        local = analyze_bundle(batch, lengths, config, chunk_taps=8)
    np.testing.assert_allclose(
        np.asarray(sharded["band_t30_rt60"]), local["band_t30_rt60"], rtol=1e-3
    )
    assert np.asarray(sharded["band_t30_ok"]).any()


def test_sharded_engine_pads_odd_batches(tap_batch):
    batch, lengths = tap_batch
    mesh = make_mesh(num_devices=4, platform="cpu")
    out = analyze_batch_sharded(mesh, batch[:6], lengths[:6], EngineConfig(run_modal=False))
    assert np.asarray(out["t30_rt60"]).shape[0] == 6
    assert int(out["bundle_valid_taps"]) == 6


def test_engine_bundle_report(tmp_path):
    """--no-plots fast path: one fused pass -> per-tap md + metrics json."""
    from audio_analysis_tpu.io import write_bundle
    from audio_analysis_tpu.report import EngineBundleSettings, run_bundle_report_engine

    n = 1 << 15
    rng = np.random.default_rng(9)
    t = np.arange(n) / SR
    taps = {}
    for i, rt in enumerate([0.3, 0.45, 0.6]):
        env = 10.0 ** (-3.0 * t / rt)
        x = np.zeros((n, 2), np.float32)
        x[50:, 0] = 0.05 * rng.standard_normal(n - 50) * env[: n - 50]
        x[50:, 1] = 0.05 * rng.standard_normal(n - 50) * env[: n - 50]
        x[50, :] = 0.9
        taps[f"tap_{i}"] = x
    root = write_bundle(tmp_path / "run", taps, SR)

    index = run_bundle_report_engine(root, EngineBundleSettings())
    content = index.read_text()
    assert "# IR Bundle Report (engine)" in content
    for name in taps:
        assert f"- [{name}]({name}/{name}_report.md)" in content  # relative to the index file
        tap_md = (root / "reports" / name / f"{name}_report.md").read_text()
        assert "## Decay / EDC" in tap_md
        assert "T30: range=[-5.0,-35.0]dB" in tap_md
        assert "## Modal cloud" in tap_md

    import json as _json

    metrics = _json.loads((root / "reports" / "bundle_metrics.json").read_text())
    assert metrics["taps"] == ["tap_0", "tap_1", "tap_2"]
    t30 = np.array(metrics["metrics"]["t30_rt60"])
    np.testing.assert_allclose(t30[:, 0], [0.3, 0.45, 0.6], rtol=0.06)

def test_engine_octave_band_mode_matches_module(tap_batch):
    """Engine octave/third band modes agree with the rt60bands module path."""
    from audio_analysis_tpu.analyses import rt60bands
    from audio_analysis_tpu.engine.batch import band_names

    batch, lengths = tap_batch
    for mode in ("octave", "third"):
        config = EngineConfig(
            band_mode=mode,
            run_fr=False,
            run_group_delay=False,
            run_stft=False,
            run_modal=False,
            run_diffusion=False,
        )
        labels = band_names(config)
        out = analyze_bundle(batch[:2], lengths[:2], config, chunk_taps=2)
        assert out["band_t30_rt60"].shape == (2, 2, len(labels))

        module = rt60bands.analyse_rt60_bands_for_channel(
            batch[1, 0],
            SR,
            "left",
            rt60bands.Rt60BandsAnalysisSettings(
                band_mode="octave" if mode == "octave" else "third"
            ),
        )
        assert labels == tuple(module.band_metrics_by_name)
        for bi, name in enumerate(labels):
            module_rt = module.band_metrics_by_name[name].rt60_t30_seconds
            engine_ok = bool(out["band_t30_ok"][1, 0, bi])
            assert engine_ok == (module_rt is not None), name
            if module_rt is not None:
                assert abs(out["band_t30_rt60"][1, 0, bi] - module_rt) / module_rt < 0.01


def test_engine_matches_diffusion_and_modal_modules(tap_batch):
    """Cross-validate the two engine blocks without direct module checks
    elsewhere: diffusion medians (engine default = mx FFT + lag-cropped
    inverse) and the modal-cloud median RT60."""
    from audio_analysis_tpu.analyses import diffusion, modalcloud

    batch, lengths = tap_batch
    out = analyze_bundle(batch, lengths, EngineConfig(), chunk_taps=8)

    # engine diffusion uses the report defaults (hop = window = 50 ms,
    # max lag 5 ms, report.py:360-361)
    ds = diffusion.DiffusionAnalysisSettings(
        window_seconds=0.05, hop_seconds=0.05, max_lag_milliseconds=5.0
    )
    d = diffusion.analyse_diffusion_for_channel(batch[3, 0], SR, "left", ds)
    mod_ac = float(np.nanmedian(d.series.max_abs_autocorr))
    mod_ed = float(np.nanmedian(d.series.echo_density))
    assert abs(out["diff_median_autocorr"][3, 0] - mod_ac) < max(0.02 * mod_ac, 5e-3)
    assert abs(out["diff_median_echo_density"][3, 0] - mod_ed) < max(0.02 * mod_ed, 5e-3)

    m = modalcloud.analyse_modal_cloud_for_channel(
        batch[3, 0], SR, "left", modalcloud.ModalCloudAnalysisSettings()
    )
    mod_rt = [p.rt60_seconds for p in m.points]
    assert len(mod_rt) > 0
    module_median = float(np.median(mod_rt))
    eng_count = int(out["modal_count"][3, 0])
    eng_median = float(out["modal_median_rt60"][3, 0])
    assert abs(eng_count - len(mod_rt)) <= max(2, 0.05 * len(mod_rt))
    assert abs(eng_median - module_median) < max(0.05 * module_median, 0.02)
