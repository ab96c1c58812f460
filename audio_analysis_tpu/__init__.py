"""
audio_analysis_tpu — an accelerator-native (JAX/XLA) audio-analysis framework.

A from-scratch rebuild of the capabilities of kianmcevoy/audio_analysis
(an offline, deterministic, IR-centric audio analysis + test-signal toolkit;
see the reference README.md:1-8) designed accelerator-first:

- every DSP primitive lives once in `ops/` as a batched, mask-based, jit-safe
  kernel (the reference copy-pasted its STFT/smoothing/fit helpers per module,
  e.g. spectrogram.py:107-160 vs waterfall.py:188-230 vs modalcloud.py:121-158);
- analyses fan out from shared device-resident intermediates (one WAV load,
  one STFT per (tap, channel)) instead of recomputing them per module
  (the reference re-reads the input ~10x per report, report.py:222-398);
- batches of taps/channels/bands are first-class: the bundle runner pads taps
  to a static (B, C, N) batch and runs ONE jitted mega-analysis, optionally
  sharded over a `jax.sharding.Mesh` (the reference loops taps sequentially,
  bundle.py:56-68).

Layout:
  io/        host-side WAV + bundle-contract I/O (NumPy only)
  ops/       the batched kernel library (plain JAX, compiled by XLA)
  analyses/  reference-parity analysis modules (settings dataclasses,
             per-channel entrypoints, plotting, deterministic text summaries)
  engine/    fused batched analysis engine + mesh sharding
  report/    report suite + bundle runner
  signals/   deterministic test-signal generators (NumPy host API + JAX batch API)
  cli/       argparse CLIs, drop-in compatible with analyse.cli / gen.cli
  oracle/    float64 NumPy re-implementations of the reference formulas,
             used as the ground truth in tests and as the CPU bench baseline
"""

__version__ = "0.1.0"

DEFAULT_SAMPLE_RATE_HZ = 48_000
