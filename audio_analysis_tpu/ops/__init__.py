"""
The batched kernel library — every DSP primitive of the framework, once.

trim      peak alignment + validity masks (replaces data-dependent slicing)
edc       Schroeder energy decay curve
dbfit     interpolated dB crossings + masked least-squares decay fits
stft      the single shared STFT magnitude kernel
fftmask   raised-cosine FFT filterbank (all bands in one batched irfft)
logfreq   log-frequency smoothing / binning (modal cloud aggregation matmul)
spectral  magnitude/phase spectra, group delay, deconvolution, AR fit
diffusion sliding-window autocorr / echo density / corr0 / IACC via FFT
"""

import os as _os
from pathlib import Path as _Path

import jax as _jax

# <checkout>/.jax_cache: one fixed directory per checkout (listed in
# .gitignore), so every process of the checkout finds what earlier ones
# compiled.
DEFAULT_COMPILATION_CACHE_DIR = _Path(__file__).resolve().parents[2] / ".jax_cache"


def _enable_persistent_compilation_cache() -> None:
    """Reuse compiled programs across processes. JAX reads
    JAX_COMPILATION_CACHE_DIR itself; only without it is the checkout's
    own cache directory set here."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    _jax.config.update("jax_compilation_cache_dir", str(DEFAULT_COMPILATION_CACHE_DIR))


_enable_persistent_compilation_cache()

from audio_analysis_tpu.ops import common, dbfit, diffusion, edc, fftmask, logfreq, spectral, stft, trim  # noqa: F401,E402
