"""
Matmul-factored FFT: rfft/irfft as two small-DFT matmul stages (the classic
four-step / Cooley-Tukey N = N1*N2 factorisation).

Why: a batched frame FFT can be expressed as two dense (N1,N1) / (N2,N2)
DFT matmuls + a twiddle Hadamard, which runs on the accelerator's matmul
units instead of its FFT library. FLOP count is ~13x the ideal split-radix
FFT. Whether that pays on the current card against XLA's FFT (cuFFT on the
GPU) is an open measurement: the engine selects it per config
(EngineConfig.stft_fft_impl, default "mx"). Full-signal 2^20 transforms
always use jnp.fft. The reference does frame-loop `np.fft.rfft` on CPU
(spectrogram.py:146-155 etc.); this module has no reference counterpart.

Derivation (forward DFT, W_N = exp(-2*pi*i/N), n = N2*a + b, k = N1*d + c):
    X[N1*d + c] = sum_b W_N^{b*c} * (sum_a x[N2*a+b] W_{N1}^{a*c}) * W_{N2}^{b*d}
so with Z = x.reshape(N1, N2):
    stage 1:  Y[c, b]  = (F_{N1} @ Z)[c, b]          (matmul over a)
    twiddle:  Y'[c, b] = Y[c, b] * W_N^{b*c}          (elementwise)
    stage 2:  X2[c, d] = (Y' @ F_{N2})[c, d]          (matmul over b)
    output:   X[k] = X2[k % N1, k // N1]

For real input only bins k <= N/2 are needed (rfft), which restricts
stage 2 to d <= N2/2: F_{N2} is sliced to (N2, N2//2+1), halving stage-2
work. Stage 1 is real @ complex -> two real matmuls.

Numerics: all matmuls run at `jax.lax.Precision.HIGHEST` (full f32
products and accumulation); max observed error vs np.fft.rfft is ~1e-3
absolute on unit-scale 2^20-sample signals (relative ~1e-7 at the spectrum
scale, which grows as sqrt(N)).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

_PRECISION = jax.lax.Precision.HIGHEST

# f32 matmul precision, exposed as EngineConfig.stft_fft_precision. On an
# H100, HIGHEST computes in full f32; HIGH and DEFAULT allow TF32 tensor
# core products (~10 mantissa bits), which move the modal fits.
_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


def _resolve_precision(precision: "str | None") -> jax.lax.Precision:
    if precision is None:
        return _PRECISION
    return _PRECISIONS[precision]


def _split(n: int) -> tuple[int, int]:
    """Pick N1*N2 = n with both factors as close as possible (powers of 2)."""
    if n & (n - 1):
        raise ValueError(f"mxfft supports power-of-two sizes, got {n}")
    log = n.bit_length() - 1
    n1 = 1 << (log // 2)
    return n1, n // n1


def _dft_matrices(n: int, n1: int | None = None):
    """Host-side (numpy) DFT + twiddle factor tables for size n = n1*n2.
    The cache key is normalised to the concrete split so (n,), (n, None)
    and (n, default_n1) share one table set."""
    if n1 is None:
        n1 = _split(n)[0]
    if n % n1:
        raise ValueError(f"n1={n1} must divide n={n}")
    return _dft_matrices_cached(n, n1)


@lru_cache(maxsize=16)
def _dft_matrices_cached(n: int, n1: int):
    n2 = n // n1
    a = np.arange(n1)
    f1 = np.exp(-2j * np.pi * np.outer(a, a) / n1)  # (c, a)
    b = np.arange(n2)
    f2_full = np.exp(-2j * np.pi * np.outer(b, b) / n2)  # (b, d)
    tw = np.exp(-2j * np.pi * np.outer(a, b) / n)  # (c, b) twiddle W_N^{bc}
    return (
        f1.real.astype(np.float32),
        f1.imag.astype(np.float32),
        f2_full.astype(np.complex64),
        tw.real.astype(np.float32),
        tw.imag.astype(np.float32),
        n1,
        n2,
    )


def rfft_mx(
    x: jnp.ndarray,
    n: int | None = None,
    *,
    k_out: int | None = None,
    n1: int | None = None,
    precision: "str | None" = None,
) -> jnp.ndarray:
    """
    Matmul rfft over the last axis: (..., N) float32 -> (..., K) complex64,
    K = k_out or N//2+1. N must be a power of two >= 4. Matches
    jnp.fft.rfft(x, n)[..., :k_out] bin order/scaling (same construction,
    fewer stage-2 columns; the different matmul shape reorders accumulation,
    so values differ from the full transform's at the level of the method's
    own ~1e-5 relative error) — consumers that only need bins below some
    f_max (the modal cloud stops at 20 kHz of a 24 kHz Nyquist) skip the
    proportional share of stage-2 work and of every downstream plane.
    `n1` overrides the stage split (must divide N); default is the balanced
    power-of-two split. Precision degrades with split imbalance — the wide
    stage's f32 dense-DFT matmul accumulates: ~2e-7 relative at the
    balanced split, measured ~1e-4 at n1 = N/2 for N = 8192 (deep-fuzz vs
    np.fft.rfft in f64). Keep overrides within ~4x of balanced.
    """
    if n is None:
        n = x.shape[-1]
    if x.shape[-1] != n:
        x = x[..., :n] if x.shape[-1] > n else jnp.pad(
            x, [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])]
        )
    f1r, f1i, f2_full, twr, twi, n1, n2 = _dft_matrices(n, n1)
    if k_out is None:
        k_out = n // 2 + 1
    if not (1 <= k_out <= n // 2 + 1):
        raise ValueError(f"k_out={k_out} outside [1, {n // 2 + 1}]")
    # stage-2 DFT restricted to the rfft half: d = 0 .. ceil(k_out / n1)
    d_max = (k_out + n1 - 1) // n1  # d indices 0..d_max-1 cover all k < n1*d_max

    prec = _resolve_precision(precision)
    z = x.reshape(x.shape[:-1] + (n1, n2)).astype(jnp.float32)

    # stage 1: real input @ complex DFT -> two real matmuls (over axis a)
    yr = jnp.einsum("ca,...ab->...cb", jnp.asarray(f1r), z, precision=prec)
    yi = jnp.einsum("ca,...ab->...cb", jnp.asarray(f1i), z, precision=prec)

    # twiddle (elementwise complex multiply, kept in split real/imag)
    twr_j, twi_j = jnp.asarray(twr), jnp.asarray(twi)
    ypr = yr * twr_j - yi * twi_j
    ypi = yr * twi_j + yi * twr_j

    # stage 2: complex @ complex over axis b -> four real matmuls
    f2r, f2i = jnp.asarray(f2_full.real[:, :d_max]), jnp.asarray(f2_full.imag[:, :d_max])
    xr = (
        jnp.einsum("...cb,bd->...cd", ypr, f2r, precision=prec)
        - jnp.einsum("...cb,bd->...cd", ypi, f2i, precision=prec)
    )
    xi = (
        jnp.einsum("...cb,bd->...cd", ypr, f2i, precision=prec)
        + jnp.einsum("...cb,bd->...cd", ypi, f2r, precision=prec)
    )

    # X[k] = X2[c, d] with k = n1*d + c  ->  transpose (c,d)->(d,c), ravel
    xr = jnp.swapaxes(xr, -1, -2).reshape(x.shape[:-1] + (d_max * n1,))[..., :k_out]
    xi = jnp.swapaxes(xi, -1, -2).reshape(x.shape[:-1] + (d_max * n1,))[..., :k_out]
    return jax.lax.complex(xr, xi)


def rfft_mx_magnitude(
    x: jnp.ndarray, n: int | None = None, *, k_out: int | None = None
) -> jnp.ndarray:
    """|rfft| over the last axis without materialising complex output."""
    spec = rfft_mx(x, n, k_out=k_out)
    return jnp.abs(spec).astype(jnp.float32)


@partial(jax.jit, static_argnames=("n",))
def _rfft_mx_jit(x, n):
    return rfft_mx(x, n)


def irfft_mx_at(
    spec: jnp.ndarray, n: int, out_indices, *, precision: "str | None" = None
) -> jnp.ndarray:
    """
    irfft evaluated at selected output samples as ONE dense synthesis
    matmul: (..., N//2+1) complex (or real, e.g. a power spectrum) ->
    (..., len(out_indices)) float32, equal to
    `jnp.fft.irfft(spec, n)[..., out_indices]`.

    When only M << N output samples are needed (correlation lags: the
    diffusion block wants +-max_lag of an n_fft-point inverse), the direct
    hermitian synthesis  x[m] = (1/n)·sum_k w_k·Re(X[k]·e^{i·2πkm/n})
    (w = 2 except DC/Nyquist) is an (F, M) matmul — no FFT, no
    full-length output, stage cost proportional to M.
    """
    out_indices = np.asarray(out_indices, np.int64)
    f = n // 2 + 1
    if spec.shape[-1] != f:
        raise ValueError(f"expected {f} rfft bins, got {spec.shape[-1]}")
    k = np.arange(f, dtype=np.float64)
    ang = (2.0 * np.pi / n) * np.outer(k, out_indices % n)
    w = np.full((f, 1), 2.0 / n)
    w[0] = 1.0 / n
    if n % 2 == 0:
        w[-1] = 1.0 / n
    prec = _resolve_precision(precision)
    cos_m = jnp.asarray((np.cos(ang) * w).astype(np.float32))
    if jnp.iscomplexobj(spec):
        sin_m = jnp.asarray((np.sin(ang) * w).astype(np.float32))
        out = (
            jnp.einsum("...f,fm->...m", jnp.real(spec), cos_m, precision=prec)
            - jnp.einsum("...f,fm->...m", jnp.imag(spec), sin_m, precision=prec)
        )
    else:
        out = jnp.einsum(
            "...f,fm->...m", spec.astype(jnp.float32), cos_m, precision=prec
        )
    return out.astype(jnp.float32)


def irfft_mx(spec: jnp.ndarray, n: int) -> jnp.ndarray:
    """
    Matmul irfft: (..., N//2+1) complex64 -> (..., N) float32, matching
    jnp.fft.irfft(spec, n). Implemented as the conjugate-transposed 4-step
    on the hermitian-extended spectrum, real part only.
    """
    k_out = n // 2 + 1
    if spec.shape[-1] != k_out:
        raise ValueError(f"expected {k_out} rfft bins, got {spec.shape[-1]}")
    # hermitian extension to the full complex spectrum of length n
    tail = jnp.conj(spec[..., 1 : n - k_out + 1][..., ::-1])
    full = jnp.concatenate([spec, tail], axis=-1)

    f1r, f1i, f2_full, twr, twi, n1, n2 = _dft_matrices(n)
    # inverse DFT = conj(forward(conj(x))) / n; run the same 4-step with
    # conjugated tables. Input ordering: X[k], k = n2*a' + b' view.
    z = full.reshape(full.shape[:-1] + (n1, n2))
    zr, zi = jnp.real(z), jnp.imag(z)

    f1r_j, f1i_j = jnp.asarray(f1r), jnp.asarray(-f1i)  # conj
    yr = (
        jnp.einsum("ca,...ab->...cb", f1r_j, zr, precision=_PRECISION)
        - jnp.einsum("ca,...ab->...cb", f1i_j, zi, precision=_PRECISION)
    )
    yi = (
        jnp.einsum("ca,...ab->...cb", f1r_j, zi, precision=_PRECISION)
        + jnp.einsum("ca,...ab->...cb", f1i_j, zr, precision=_PRECISION)
    )

    twr_j, twi_j = jnp.asarray(twr), jnp.asarray(-twi)  # conj twiddle
    ypr = yr * twr_j - yi * twi_j
    ypi = yr * twi_j + yi * twr_j

    f2r = jnp.asarray(np.real(f2_full))
    f2i = jnp.asarray(-np.imag(f2_full))  # conj
    # real part of the output only (the imaginary part is ~0 for a
    # hermitian input): re(Y' @ F2*) = ypr@f2r - ypi@f2i
    xr = (
        jnp.einsum("...cb,bd->...cd", ypr, f2r, precision=_PRECISION)
        - jnp.einsum("...cb,bd->...cd", ypi, f2i, precision=_PRECISION)
    )
    out = jnp.swapaxes(xr, -1, -2).reshape(full.shape[:-1] + (n,))
    return (out / n).astype(jnp.float32)
