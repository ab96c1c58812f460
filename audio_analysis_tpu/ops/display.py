"""
Display-resolution pooling ON DEVICE, so plot data crosses the host link at
pixel resolution instead of full STFT resolution.

The spectrogram/waterfall figures draw at most ~1200x720 pixels, but the
host path used to fetch the full (C, T, F) dB plane (~17 MB int16 per tap
at the 2^20 bucket) and pool on the host (plot.log_frequency_image). Here
the same max-pooling runs on device and only the pooled image (~3 MB) plus
two colour-scale percentiles cross the link.

Mapping to the hardware (no gathers — see CLAUDE.md kernel map):

- Column (time) pooling is a strided reshape + max, exactly the host
  algorithm with the bucket width derived from each channel's VALID frame
  count (a short tap or channel in a large pow-2 bucket keeps the time
  resolution the host path would draw for its real width; channels whose
  widths pool differently run as separate dispatches).
- Row (log-frequency) pooling is a range-max query over contiguous,
  settings-static bin ranges: a shifted-maximum "sparse table" pyramid
  along F (log2(Wmax) levels), then each row's max is the maximum of TWO
  entries — selected with a one-hot MATMUL over the stacked pyramid
  (selection is linear, so it is a matmul rather than a gather; whether
  a take() is faster on the current card is ROADMAP queue 1 item 7).
- Waterfall needs only its ~18 slice frames: a frames-by-time 0/1 mask
  matmul extracts (C, S, F) directly (reference waterfall.py:220-247
  recomputed the full STFT per channel and sliced on host).
- Colour percentiles (spectrogram.py:278-289 contract) use the sort-free
  exact order statistics in ops/selectq over the full-resolution valid
  region, matching np.percentile's interpolation.

-inf never enters the matmuls: masked/padded cells use a large finite
negative (0 * -inf would poison the one-hot products with NaN).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from audio_analysis_tpu.ops import selectq

# finite stand-in for -inf as the max identity (0 * -inf = NaN in matmuls)
_NEG = np.float32(-3.0e38)

# 1/128-dB int16 fixed point (same as the plane fetches): the ±255.99 dB
# window covers any practical floor_db (a 1/256 step clipped at ±127.99 dB,
# silently flattening plots for floors below -128 dB); 1/128 dB is still
# ~100x finer than a plot pixel.
_DB_SCALE = 128.0
_DB_CLIP = 255.99


@jax.jit
def quantize_db_i16(x):
    """dB plane -> 1/128-dB int16 fixed point (±255.99 dB clip): THE d2h
    link format for every dB image/slice/plane. One definition so the
    display paths and analyses/_common.fetch_db_plane_i16 cannot drift —
    cross-path value-equality tests depend on an identical contract."""
    return jnp.round(jnp.clip(x, -_DB_CLIP, _DB_CLIP) * _DB_SCALE).astype(jnp.int16)


def dequantize_db_i16(q) -> np.ndarray:
    """Inverse of quantize_db_i16, on host (float32)."""
    return np.asarray(q).astype(np.float32) * np.float32(1.0 / _DB_SCALE)


def _freqs_f32(n_fft: int, sample_rate_hz: int) -> np.ndarray:
    """The float32 rfft frequency grid — the SAME dtype the host figure
    code compares against (ops.stft.rfft_freqs_hz); float64 here could
    disagree by one bin at the f_min/f_max boundaries."""
    return np.fft.rfftfreq(n_fft, d=1.0 / float(sample_rate_hz)).astype(np.float32)


def freq_selection(n_fft: int, sample_rate_hz: int, f_min: float, f_max: float):
    """The contiguous rfft-bin range [i0, i1) inside [f_min, f_max] — the
    same selection as `freq_hz[fmask]` in the figure code (frequencies are
    ascending, so the mask is one contiguous run)."""
    freq = _freqs_f32(n_fft, sample_rate_hz)
    mask = (freq >= np.float32(f_min)) & (freq <= np.float32(f_max))
    if not np.any(mask):
        raise ValueError("empty frequency selection")
    idx = np.nonzero(mask)[0]
    return int(idx[0]), int(idx[-1]) + 1


@functools.lru_cache(maxsize=16)
def _log_row_select(
    n_fft: int, sample_rate_hz: int, i0: int, i1: int,
    f_min: float, f_max: float, rows: int,
):
    """One-hot selection matrix for the sparse-table range-max, host-built
    once per (settings, sample-rate) and cached.

    Returns (sel (2*rows, levels*F_sel) float32, levels). Row r of the
    pooled image = max(sel_A[r] . stack, sel_B[r] . stack) where stack is
    the level-stacked shifted-max pyramid: level k entry i holds
    max(x[i : i+2^k]). Row ranges replicate plot.log_frequency_image:
    log-spaced edges, searchsorted, nearest-bin for sub-bin rows.
    """
    freq_sel = _freqs_f32(n_fft, sample_rate_hz)[i0:i1]
    n_sel = freq_sel.size
    edges = np.logspace(np.log10(f_min), np.log10(f_max), rows + 1)
    idx = np.searchsorted(freq_sel, edges).clip(0, n_sel)

    spans = []
    max_w = 1
    for r in range(rows):
        lo, hi = int(idx[r]), int(idx[r + 1])
        if hi <= lo:
            b = min(lo, n_sel - 1)
            spans.append((b, 1))
        else:
            spans.append((lo, hi - lo))
            max_w = max(max_w, hi - lo)
    # highest level actually indexed below is k = floor(log2(max_w)), so
    # exactly bit_length(max_w) levels; the previous `(max_w-1).bit_length()
    # + 1` built one unused extra plane whenever max_w was not a power of 2
    levels = int(max_w).bit_length()  # k = 0..floor(log2(max_w))

    a = np.zeros((rows, levels, n_sel), np.float32)
    b = np.zeros((rows, levels, n_sel), np.float32)
    for r, (lo, w) in enumerate(spans):
        k = int(w).bit_length() - 1  # floor(log2(w)); 2^k >= w/2
        a[r, k, lo] = 1.0
        b[r, k, lo + w - (1 << k)] = 1.0
    sel = np.concatenate([a.reshape(rows, -1), b.reshape(rows, -1)], axis=0)
    return sel, levels


# one resident device copy of each selection matrix (~60 MB at the default
# 720 rows x 6 levels x ~1700 bins), shared by every tap of a bundle;
# bounded FIFO so mixed-rate batch jobs don't grow device memory without limit
_SEL_DEVICE: dict = {}
_SEL_DEVICE_MAX = 3


def _sel_on_device(key) -> jnp.ndarray:
    entry = _SEL_DEVICE.get(key)
    if entry is None:
        sel, _levels = _log_row_select(*key)
        if len(_SEL_DEVICE) >= _SEL_DEVICE_MAX:
            _SEL_DEVICE.pop(next(iter(_SEL_DEVICE)))
        entry = jax.device_put(sel)
        _SEL_DEVICE[key] = entry
    return entry


@functools.partial(
    jax.jit, static_argnames=("i0", "i1", "rows", "levels", "col_pool")
)
def _pooled_image_dev(mag_tf, num_frames, sel, i0, i1, rows, levels, col_pool):
    c, t, _f = mag_tf.shape
    x = mag_tf[:, :, i0:i1]
    n_sel = x.shape[-1]
    valid_t = jnp.arange(t) < num_frames[:, None]  # (C, T)

    # colour percentiles over the FULL-RES valid region (the displayed set)
    flat = x.reshape(c, -1)
    vmask = jnp.broadcast_to(valid_t[:, :, None], x.shape).reshape(c, -1)
    pcts = selectq.masked_percentiles(flat, vmask, (99.5, 5.0))  # (C, 2)

    xm = jnp.where(valid_t[:, :, None], x, _NEG)

    if col_pool > 1:
        nb = -(-t // col_pool)
        pad = nb * col_pool - t
        if pad:
            xm = jnp.pad(xm, ((0, 0), (0, pad), (0, 0)), constant_values=_NEG)
        xm = xm.reshape(c, nb, col_pool, n_sel).max(axis=2)

    planes = [xm]
    for lvl in range(1, levels):
        shift = 1 << (lvl - 1)
        prev = planes[-1]
        shifted = jnp.concatenate(
            [
                prev[:, :, shift:],
                jnp.full(prev.shape[:2] + (shift,), _NEG, prev.dtype),
            ],
            axis=2,
        )
        planes.append(jnp.maximum(prev, shifted))
    stack = jnp.concatenate(planes, axis=2)  # (C, T', levels*F_sel)

    ab = jnp.einsum(
        "ctf,rf->ctr", stack, sel, precision=jax.lax.Precision.HIGHEST
    )  # one-hot selection: exact
    image = jnp.maximum(ab[..., :rows], ab[..., rows:])  # (C, T', rows)

    q = quantize_db_i16(image)
    # percentiles ride the same fetch as one extra time-column
    extras = jnp.zeros((c, 1, rows), jnp.float32)
    extras = extras.at[:, 0, :2].set(pcts)
    qe = quantize_db_i16(extras)
    return jnp.concatenate([q, qe], axis=1)


def pooled_log_freq_image(
    mag_tf,
    num_frames_host: np.ndarray,
    n_fft: int,
    sample_rate_hz: int,
    f_min: float,
    f_max: float,
    rows: int = 720,
    cols: int = 1200,
):
    """
    Device (C, T, F) dB plane -> host display products, one small fetch:

      images: list of (rows, T_c') float32 dB per channel (valid columns
              only, transposed for imshow), exactly the max-pooled values
              plot.log_frequency_image computes (same quantisation as the
              old full-plane fetch: 1/128 dB)
      p995, p5: per-channel colour percentiles of the full-res valid region

    `num_frames_host` are the per-channel valid frame counts (host meta).
    """
    key = (int(n_fft), int(sample_rate_hz), *freq_selection(n_fft, sample_rate_hz, f_min, f_max), float(f_min), float(f_max), int(rows))
    i0, i1 = key[2], key[3]
    _sel, levels = _log_row_select(*key)
    sel_dev = _sel_on_device(key)

    # Bucket width PER CHANNEL from its VALID frame count — exactly what
    # the host path computes for each channel's real width (neither the
    # padded static T nor another channel's width). Channels usually agree
    # (per-tap alignment trims them near-identically), so the common case
    # stays one dispatch + one fetch; differing widths fall back to one
    # call per channel. col_pool is a static jit arg, but its value set is
    # tiny (ceil(t_valid/cols)) so compile diversity stays bounded.
    nfh = np.asarray(num_frames_host, np.int64)
    pools = [
        (-(-int(v) // cols) if (cols > 0 and int(v) > cols + cols // 2) else 1)
        for v in nfh
    ]

    nf = jnp.asarray(nfh.astype(np.int32))

    def run(mag_sub, nf_sub, col_pool):
        packed = np.asarray(
            _pooled_image_dev(
                mag_sub, nf_sub, sel_dev, i0, i1, int(rows), int(levels), int(col_pool)
            )
        )
        return dequantize_db_i16(packed)

    if len(set(pools)) == 1:
        plane = run(mag_tf, nf, pools[0])
        planes = [plane[c] for c in range(plane.shape[0])]
    else:
        planes = [run(mag_tf[c : c + 1], nf[c : c + 1], cp)[0] for c, cp in enumerate(pools)]

    images = []
    p995, p5 = [], []
    for c, plane_c in enumerate(planes):
        n_valid = int(nfh[c])
        nvb = max(1, -(-n_valid // pools[c]))
        images.append(plane_c[:nvb].T.copy())  # (rows, T_c')
        p995.append(float(plane_c[-1, 0]))
        p5.append(float(plane_c[-1, 1]))
    return images, np.asarray(p995), np.asarray(p5)


@functools.partial(jax.jit, static_argnames=("i0", "i1"))
def _slices_dev(mag_tf, frame_idx, i0, i1):
    c, t, _f = mag_tf.shape
    x = mag_tf[:, :, i0:i1]
    onehot = (
        jnp.arange(t)[None, None, :] == frame_idx[:, :, None]
    ).astype(jnp.float32)  # (C, S, T)
    sel = jnp.einsum(
        "cst,ctf->csf", onehot, x, precision=jax.lax.Precision.HIGHEST
    )
    return quantize_db_i16(sel)


def stft_frame_slices(
    mag_tf,
    frame_idx: np.ndarray,
    n_fft: int,
    sample_rate_hz: int,
    f_min: float,
    f_max: float,
) -> np.ndarray:
    """
    Extract per-channel STFT frames (C, S, F_sel) from the device plane via
    a 0/1 mask matmul (no gather, no full-plane fetch) and return them as
    host float32 dB with the standard 1/128-dB quantisation.

    `frame_idx` is (C, S) int32 — per-channel frame indices (pad rows with
    a repeated index; the caller trims).
    """
    i0, i1 = freq_selection(n_fft, sample_rate_hz, f_min, f_max)
    idx = jnp.asarray(np.asarray(frame_idx, np.int32))
    q = np.asarray(_slices_dev(mag_tf, idx, i0, i1))
    return dequantize_db_i16(q)
