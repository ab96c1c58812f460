"""
CLI for generating offline test signals — drop-in compatible with the
reference's `python -m gen.cli` surface (gen/cli.py:92-536): same
subcommands (impulse, click, impulse_train, noise_long, noise_burst,
sine_sustain, sine_burst, sweep, pluck, karplus_pluck, all), same flags,
same defaults, same PCM16 48 kHz output and "Wrote ..." confirmation line
(gen/cli.py:732).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Tuple

from audio_analysis_tpu.io.wav import write_wav_pcm16
from audio_analysis_tpu import signals as sig

DEFAULT_SAMPLE_RATE_HZ = 48_000

_WINDOW_CHOICES = ["rect", "hann", "hamming", "blackman"]
_NOISE_CHOICES = ["white", "pink"]


def ensure_wav_suffix(path: Path) -> Path:
    return path if path.suffix.lower() == ".wav" else path.with_suffix(".wav")


def default_output_filename(signal_name: str) -> str:
    return f"{signal_name}.wav"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gen",
        description=(
            "Generate offline stereo WAV test signals for reverb analysis (48 kHz by default)."
        ),
    )
    p.add_argument(
        "--output-dir",
        dest="output_directory",
        type=str,
        default="test_tones",
        help="Directory to write generated WAV files (default: ./test_tones).",
    )
    p.add_argument(
        "--channel_mode",
        type=str,
        default="mono",
        choices=["mono", "stereo"],
        help="Output channel mode (default: mono).",
    )
    p.add_argument(
        "--sample_rate_hz",
        type=int,
        default=DEFAULT_SAMPLE_RATE_HZ,
        help="Sample rate in Hz (default: 48000).",
    )

    sub = p.add_subparsers(dest="command_name", required=True, help="Signal type to generate.")

    sp = sub.add_parser("impulse", help="Single-sample Dirac impulse inside a fixed-length buffer.")
    sp.add_argument("--duration", dest="total_duration_seconds", type=float, default=1.0)
    sp.add_argument("--impulse_sample_index", type=int, default=0)
    sp.add_argument("--output", type=str, default=default_output_filename("impulse"))

    sp = sub.add_parser("click", help="Short windowed pulse.")
    sp.add_argument("--duration", dest="click_duration_seconds", type=float, default=0.001)
    sp.add_argument("--window_type", type=str, default="hann", choices=_WINDOW_CHOICES)
    sp.add_argument("--output", type=str, default=default_output_filename("click"))

    sp = sub.add_parser("impulse_train", help="Periodic train of short clicks.")
    sp.add_argument("--duration", dest="total_duration_seconds", type=float, default=2.0)
    sp.add_argument("--period", dest="impulse_period_seconds", type=float, default=0.25)
    sp.add_argument("--click-duration", dest="click_duration_seconds", type=float, default=0.001)
    sp.add_argument("--window_type", type=str, default="hann", choices=_WINDOW_CHOICES)
    sp.add_argument("--output", type=str, default=default_output_filename("impulse_train"))

    sp = sub.add_parser("noise_long", help="Long noise signal for steady-state behaviour.")
    sp.add_argument("--duration_seconds", type=float, default=3.0)
    sp.add_argument("--noise_type", type=str, default="white", choices=_NOISE_CHOICES)
    sp.add_argument("--random_seed", type=int, default=0)
    sp.add_argument("--output", type=str, default=default_output_filename("noise_long"))

    sp = sub.add_parser("noise_burst", help="Short windowed noise burst.")
    sp.add_argument("--duration", dest="burst_duration_seconds", type=float, default=0.02)
    sp.add_argument("--noise_type", type=str, default="white", choices=_NOISE_CHOICES)
    sp.add_argument("--random_seed", type=int, default=0)
    sp.add_argument("--window_type", type=str, default="hann", choices=_WINDOW_CHOICES)
    sp.add_argument("--output", type=str, default=default_output_filename("noise_burst"))

    sp = sub.add_parser("sine_sustain", help="Sustained sine wave.")
    sp.add_argument("--freq", dest="frequency_hz", type=float, default=440.0)
    sp.add_argument("--duration_seconds", type=float, default=5.0)
    sp.add_argument("--amplitude", type=float, default=0.5)
    sp.add_argument("--initial_phase_radians", type=float, default=0.0)
    sp.add_argument("--output", type=str, default=default_output_filename("sine_sustain"))

    sp = sub.add_parser("sine_burst", help="Windowed sine burst.")
    sp.add_argument("--freq", dest="frequency_hz", type=float, default=220.0)
    sp.add_argument("--duration", dest="burst_duration_seconds", type=float, default=0.1)
    sp.add_argument("--amplitude", type=float, default=0.7)
    sp.add_argument("--window_type", type=str, default="hann", choices=_WINDOW_CHOICES)
    sp.add_argument("--output", type=str, default=default_output_filename("sine_burst"))

    sp = sub.add_parser("sweep", help="Logarithmic sine sweep for IR extraction via deconvolution.")
    sp.add_argument("--duration_seconds", type=float, default=10.0)
    sp.add_argument("--start-freq", dest="start_frequency_hz", type=float, default=20.0)
    sp.add_argument("--end-freq", dest="end_frequency_hz", type=float, default=20_000.0)
    sp.add_argument("--amplitude", type=float, default=0.5)
    sp.add_argument("--fade_duration_seconds", type=float, default=0.01)
    sp.add_argument("--pre_silence_seconds", type=float, default=1.0)
    sp.add_argument("--post_silence_seconds", type=float, default=2.0)
    sp.add_argument("--output", type=str, default=default_output_filename("sweep"))

    sp = sub.add_parser("pluck", help="Synthetic muted-pluck proxy (band-limited noise + decay).")
    sp.add_argument("--duration_seconds", type=float, default=0.15)
    sp.add_argument("--bandlimit", dest="bandlimit_frequency_hz", type=float, default=8000.0)
    sp.add_argument("--decay", dest="decay_time_constant_seconds", type=float, default=0.03)
    sp.add_argument("--random_seed", type=int, default=0)
    sp.add_argument("--output", type=str, default=default_output_filename("pluck"))

    sp = sub.add_parser("karplus_pluck", help="Karplus–Strong pluck (string-like physical model).")
    sp.add_argument("--freq", dest="fundamental_frequency_hz", type=float, default=110.0)
    sp.add_argument("--duration_seconds", type=float, default=2.0)
    sp.add_argument("--bandlimit", dest="excitation_noise_bandlimit_hz", type=float, default=8000.0)
    sp.add_argument("--feedback_decay_factor", type=float, default=0.996)
    sp.add_argument("--lowpass_blend", type=float, default=0.5)
    sp.add_argument("--random_seed", type=int, default=0)
    sp.add_argument("--output", type=str, default=default_output_filename("karplus_pluck"))

    sub.add_parser("all", help="Generate all test tones with default settings.")
    return p


def generate_signal_from_arguments(args: argparse.Namespace) -> Tuple[str, sig.GeneratedSignal, Path]:
    sr = int(args.sample_rate_hz)
    cmd = str(args.command_name)

    if cmd == "impulse":
        out = sig.generate_impulse(sr, int(args.impulse_sample_index), float(args.total_duration_seconds))
    elif cmd == "click":
        out = sig.generate_click(sr, float(args.click_duration_seconds), str(args.window_type))
    elif cmd == "impulse_train":
        out = sig.generate_impulse_train(
            sr,
            float(args.total_duration_seconds),
            float(args.impulse_period_seconds),
            float(args.click_duration_seconds),
            str(args.window_type),
        )
    elif cmd == "noise_long":
        out = sig.generate_noise(sr, float(args.duration_seconds), str(args.noise_type), int(args.random_seed))
    elif cmd == "noise_burst":
        out = sig.generate_noise_burst(
            sr,
            float(args.burst_duration_seconds),
            str(args.noise_type),
            int(args.random_seed),
            str(args.window_type),
        )
    elif cmd == "sine_sustain":
        out = sig.generate_sine(
            sr,
            float(args.frequency_hz),
            float(args.duration_seconds),
            float(args.amplitude),
            float(args.initial_phase_radians),
        )
    elif cmd == "sine_burst":
        out = sig.generate_sine_burst(
            sr,
            float(args.frequency_hz),
            float(args.burst_duration_seconds),
            float(args.amplitude),
            str(args.window_type),
        )
    elif cmd == "sweep":
        out = sig.generate_log_sine_sweep(
            sr,
            float(args.duration_seconds),
            float(args.start_frequency_hz),
            float(args.end_frequency_hz),
            float(args.amplitude),
            float(args.fade_duration_seconds),
            float(args.pre_silence_seconds),
            float(args.post_silence_seconds),
        )
    elif cmd == "pluck":
        out = sig.generate_pluck_like(
            sr,
            float(args.duration_seconds),
            float(args.bandlimit_frequency_hz),
            float(args.decay_time_constant_seconds),
            int(args.random_seed),
        )
    elif cmd == "karplus_pluck":
        out = sig.generate_karplus_strong_pluck(
            sr,
            float(args.fundamental_frequency_hz),
            float(args.duration_seconds),
            float(args.excitation_noise_bandlimit_hz),
            float(args.feedback_decay_factor),
            float(args.lowpass_blend),
            int(args.random_seed),
        )
    else:
        raise ValueError(f"Unknown command: {cmd}")

    return cmd, out, Path(args.output)


def _write_and_report(output_path: Path, generated: sig.GeneratedSignal, channel_mode: str) -> None:
    if channel_mode == "mono":
        samples = generated.samples
    elif channel_mode == "stereo":
        samples = sig.duplicate_mono_to_stereo(generated.samples)
    else:
        raise ValueError(f"Unknown channel_mode: {channel_mode}")

    write_wav_pcm16(output_path, samples, generated.sample_rate_hz)

    channel_count = 1 if samples.ndim == 1 else int(samples.shape[1])
    print(
        f"Wrote {output_path} ({samples.shape[0]} samples, "
        f"{generated.sample_rate_hz} Hz, {channel_count} channel(s))"
    )


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    output_dir = Path(args.output_directory)
    channel_mode = str(args.channel_mode)

    if str(args.command_name) == "all":
        sr = int(args.sample_rate_hz)
        # Same default tone set as the reference `all` command (gen/cli.py:667-678).
        all_signals = [
            ("impulse", sig.generate_impulse(sample_rate_hz=sr)),
            ("click", sig.generate_click(sample_rate_hz=sr)),
            ("impulse_train", sig.generate_impulse_train(sample_rate_hz=sr)),
            ("noise_long", sig.generate_noise(sample_rate_hz=sr, duration_seconds=10.0)),
            ("noise_burst", sig.generate_noise_burst(sample_rate_hz=sr)),
            ("sine_sustain", sig.generate_sine(sample_rate_hz=sr, frequency_hz=1000.0, duration_seconds=1.0)),
            ("sine_burst", sig.generate_sine_burst(sample_rate_hz=sr, frequency_hz=1000.0)),
            ("sweep", sig.generate_log_sine_sweep(sample_rate_hz=sr)),
            ("pluck", sig.generate_pluck_like(sample_rate_hz=sr)),
            (
                "karplus_pluck",
                sig.generate_karplus_strong_pluck(sample_rate_hz=sr, fundamental_frequency_hz=110.0),
            ),
        ]
        for name, generated in all_signals:
            _write_and_report(
                ensure_wav_suffix(output_dir / default_output_filename(name)), generated, channel_mode
            )
        return

    _, generated, output_path = generate_signal_from_arguments(args)
    _write_and_report(ensure_wav_suffix(output_dir / output_path), generated, channel_mode)


if __name__ == "__main__":
    main()
