"""
ctypes binding to the native C++ audio I/O runtime (cpp/audioio.cpp).

The native library provides:
- fast single-file WAV decode (PCM16/PCM24/PCM32/float32) to float32
- multithreaded batched bundle decode: all taps of a bundle decoded in
  parallel worker threads directly into one padded (B, N_max, C) buffer,
  ready for device upload (the batched replacement for the reference's
  sequential per-tap scipy reads, bundle.py:56-68)
- PCM16 WAV encode

Falls back gracefully (available() -> False) when the library has not been
built; all call sites must handle that by using the scipy path.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

def _lib_candidates() -> List[Path]:
    here = Path(__file__).resolve()
    # pip-installed builds place the C-ABI extension inside the package
    # (setup.py: audio_analysis_tpu/_audioio*.so — loaded via ctypes, the
    # interpreter-tag suffix is irrelevant); repo checkouts use cpp/build.
    return sorted(here.parents[1].glob("_audioio*.so")) + [
        here.parents[2] / "cpp" / "build" / "libaudioio.so",
        here.parents[2] / "cpp" / "libaudioio.so",
    ]

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_override_error: Optional[OSError] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted, _override_error
    if _load_attempted:
        if _override_error is not None:
            raise _override_error  # every call fails loudly, not just the first
        return _lib
    _load_attempted = True
    override = os.environ.get("AA_AUDIOIO_LIB")
    if override:
        # An explicit override (relocated deployments, sanitizer builds)
        # must be honored or fail loudly — silently falling back to the
        # repo-default .so would, e.g., run an ASan campaign against the
        # NON-sanitized library and report clean.
        try:
            lib = ctypes.CDLL(override)  # raises OSError with the dlopen detail
        except OSError as exc:
            _override_error = exc
            raise
        _configure(lib)
        _lib = lib
        return _lib
    for candidate in _lib_candidates():
        if candidate.exists():
            try:
                lib = ctypes.CDLL(str(candidate))
            except OSError:
                continue
            _configure(lib)
            _lib = lib
            break
    return _lib


def _configure(lib: ctypes.CDLL) -> None:
    lib.aa_read_wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),  # frames
        ctypes.POINTER(ctypes.c_int32),  # channels
        ctypes.POINTER(ctypes.c_int32),  # sample rate
    ]
    lib.aa_read_wav_info.restype = ctypes.c_int32

    lib.aa_read_wav_f32.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),  # out (frames*channels interleaved)
        ctypes.c_int64,  # capacity in floats
    ]
    lib.aa_read_wav_f32.restype = ctypes.c_int32

    lib.aa_write_wav_pcm16.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,  # frames
        ctypes.c_int32,  # channels
        ctypes.c_int32,  # sample rate
    ]
    lib.aa_write_wav_pcm16.restype = ctypes.c_int32

    lib.aa_read_bundle_f32.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # paths
        ctypes.c_int32,  # num files
        ctypes.POINTER(ctypes.c_float),  # out (B, N_max, C) contiguous
        ctypes.c_int64,  # N_max (frames)
        ctypes.c_int32,  # C
        ctypes.POINTER(ctypes.c_int64),  # out lengths per file
        ctypes.c_int32,  # num threads
    ]
    lib.aa_read_bundle_f32.restype = ctypes.c_int32

    lib.aa_read_bundle_planar_i16.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # paths
        ctypes.c_int32,  # num files
        ctypes.POINTER(ctypes.c_int16),  # out (B, C, N_max) planar
        ctypes.c_int64,  # N_max (frames)
        ctypes.c_int32,  # C
        ctypes.POINTER(ctypes.c_int64),  # out lengths per file
        ctypes.c_int32,  # num threads
    ]
    lib.aa_read_bundle_planar_i16.restype = ctypes.c_int32


def available() -> bool:
    return _load() is not None


# latched by ensure_built after a FAILED `make -C cpp`: without it every
# caller (e.g. each example of a hypothesis test) would re-run the whole
# build attempt — up to timeout_s each — on a machine whose toolchain is
# broken or missing, turning one skip-worthy condition into minutes of
# retries (round-4 advisor finding).
_build_failed = False


def ensure_built(timeout_s: float = 180.0) -> bool:
    """Best-effort: build the native library (`make -C cpp`) if it is not
    loadable yet, then retry the load. Returns available().

    Perf entry points (bench.py, chip_smoke.py) call this so a fresh
    checkout measures the native decode path instead of silently falling
    back to the ~10x slower scipy reader. Never raises: when the toolchain
    or Makefile is missing the normal fallback story applies. A failed
    build is remembered for the life of the process — repeat calls return
    False immediately instead of re-running make."""
    global _lib, _load_attempted, _build_failed
    if available() or os.environ.get("AA_AUDIOIO_LIB"):
        return available()
    if _build_failed:
        return False
    makefile = Path(__file__).resolve().parents[2] / "cpp" / "Makefile"
    if not makefile.exists():
        _build_failed = True
        return False
    import subprocess

    try:
        subprocess.run(
            ["make", "-C", str(makefile.parent)],
            capture_output=True,
            timeout=timeout_s,
            check=True,
        )
    except Exception:
        _build_failed = True
        return False
    _lib, _load_attempted = None, False  # retry the candidate scan
    return available()


def read_wav_info(path: str | Path) -> Tuple[int, int, int]:
    """Return (frames, channels, sample_rate_hz) without decoding samples."""
    lib = _load()
    assert lib is not None
    frames = ctypes.c_int64(0)
    channels = ctypes.c_int32(0)
    rate = ctypes.c_int32(0)
    rc = lib.aa_read_wav_info(
        str(path).encode(), ctypes.byref(frames), ctypes.byref(channels), ctypes.byref(rate)
    )
    if rc != 0:
        raise IOError(f"native WAV probe failed ({rc}): {path}")
    return frames.value, channels.value, rate.value


def read_wav(path: str | Path) -> Tuple[int, np.ndarray]:
    """Decode a WAV file to float32. Returns (sample_rate_hz, (N,) or (N,C))."""
    lib = _load()
    assert lib is not None
    frames, channels, rate = read_wav_info(path)
    out = np.empty(frames * channels, dtype=np.float32)
    rc = lib.aa_read_wav_f32(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(out.size),
    )
    if rc != 0:
        raise IOError(f"native WAV decode failed ({rc}): {path}")
    if channels > 1:
        out = out.reshape(frames, channels)
    return rate, out


def write_wav_pcm16(path: str | Path, int16_samples: np.ndarray, sample_rate_hz: int) -> None:
    lib = _load()
    assert lib is not None
    x = np.ascontiguousarray(int16_samples, dtype=np.int16)
    if x.ndim == 1:
        frames, channels = x.size, 1
    else:
        frames, channels = x.shape
    rc = lib.aa_write_wav_pcm16(
        str(path).encode(),
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_int64(frames),
        ctypes.c_int32(channels),
        ctypes.c_int32(sample_rate_hz),
    )
    if rc != 0:
        raise IOError(f"native WAV encode failed ({rc}): {path}")


def read_bundle(
    paths: List[Path],
    n_max: int,
    channels: int,
    num_threads: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """
    Decode many WAVs in parallel into one zero-padded (B, N_max, C) float32
    buffer. Returns (batch, lengths). Mono files are duplicated to C channels.
    """
    lib = _load()
    assert lib is not None
    num = len(paths)
    out = np.zeros((num, n_max, channels), dtype=np.float32)
    lengths = np.zeros(num, dtype=np.int64)
    c_paths = (ctypes.c_char_p * num)(*[str(p).encode() for p in paths])
    rc = lib.aa_read_bundle_f32(
        c_paths,
        ctypes.c_int32(num),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n_max),
        ctypes.c_int32(channels),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(num_threads),
    )
    if rc != 0:
        raise IOError(f"native bundle decode failed ({rc})")
    return out, lengths


def read_bundle_planar_i16(
    paths: List[Path],
    n_max: int,
    channels: int,
    num_threads: int = 8,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """
    PCM16 bundle fast path: zero-padded PLANAR (B, C, N_max) int16 batch —
    half the bytes of the f32 path on the host AND across the host->device
    link (the device converts /32768 on-chip). Returns None when any tap is
    not plain PCM16 (callers fall back to the f32 decoder).
    """
    lib = _load()
    assert lib is not None
    num = len(paths)
    out = np.zeros((num, channels, n_max), dtype=np.int16)
    lengths = np.zeros(num, dtype=np.int64)
    c_paths = (ctypes.c_char_p * num)(*[str(p).encode() for p in paths])
    rc = lib.aa_read_bundle_planar_i16(
        c_paths,
        ctypes.c_int32(num),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_int64(n_max),
        ctypes.c_int32(channels),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(num_threads),
    )
    if rc == -3:  # kErrUnsupported: not PCM16 — caller uses the f32 path
        return None
    if rc != 0:
        raise IOError(f"native planar-i16 bundle decode failed ({rc})")
    return out, lengths
