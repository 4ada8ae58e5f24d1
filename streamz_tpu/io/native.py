"""ctypes binding for the C++ native ingest runtime (``native/``).

Builds ``libstreamz_native.so`` on first use (plain ``make``) and exposes the
threaded batch decoder.  Callers fall back to the pure-Python ingest when the
native library is unavailable; behavior is identical (the native layer is the
performance path, mirroring the reference's minimp3/hound/rayon stack).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

# Candidate homes for the C++ sources, in preference order:
#  1. <repo>/native — the in-tree / sdist layout (three dirs above here);
#  2. <package>/native — the wheel layout (setup.py copies the sources into
#     the built package, so `pip install .` keeps the native ingest layer
#     instead of silently dropping to pure-Python).
_CANDIDATE_DIRS = (
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native"),
    os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native"),
)


def source_dir():
    """The native source directory in use, or None when none exists."""
    for d in _CANDIDATE_DIRS:
        if os.path.exists(os.path.join(d, "streamz_native.cpp")):
            return d
    return None


def _so_path():
    """The shared library to load: an already-built .so in any candidate
    dir wins (a deployment may ship ONLY the built artifact, sources
    pruned — that must keep the fast path); else the source dir's build
    target; None when neither exists anywhere."""
    for d in _CANDIDATE_DIRS:
        p = os.path.join(d, "libstreamz_native.so")
        if os.path.exists(p):
            return p
    d = source_dir()
    return os.path.join(d, "libstreamz_native.so") if d else None


_lib = None
_lib_lock = threading.Lock()
_build_attempted = False
_load_failed = False
_warned_fallback = False

# Bumped whenever the C ABI changes (exports added/removed/reshaped); a
# stale on-disk .so from an older checkout is rebuilt instead of crashing
# the ctypes bindings with AttributeError.
SZ_NATIVE_VERSION = 2


class _SzClip(ctypes.Structure):
    _fields_ = [
        ("samples", ctypes.POINTER(ctypes.c_int16)),
        ("len", ctypes.c_int64),
        ("rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("status", ctypes.c_int32),
    ]


def _try_build(force: bool = False) -> bool:
    """Build the .so from sources (when any exist); True iff the SOURCE
    directory's build target exists afterwards."""
    global _build_attempted
    d = source_dir()
    if d is None:
        return False
    target = os.path.join(d, "libstreamz_native.so")
    if _build_attempted and not force:
        return os.path.exists(target)
    _build_attempted = True
    try:
        cmd = ["make", "-s", "-B"] if force else ["make", "-s"]
        subprocess.run(
            cmd, cwd=d, check=True,
            capture_output=True, timeout=120,
        )
    except Exception:
        return False
    return os.path.exists(target)


def _warn_unavailable() -> None:
    """One loud warning the first time the native layer is found missing.

    The fallback is behavior-identical but a large ingest perf cliff
    (threaded C++ decode→downmix→resample vs a Python thread pool), so a
    wheel that lost its sources — or a host without a C++ toolchain — must
    say so instead of silently serving the slow path."""
    global _warned_fallback
    if _warned_fallback:
        return
    _warned_fallback = True
    import warnings

    d = source_dir()
    if d:
        why = f"the C++ build failed in {d!r} (is g++/make installed?)"
    elif _so_path():
        why = (
            f"only a stale/incompatible libstreamz_native.so was found "
            f"(ABI version != {SZ_NATIVE_VERSION}) and no sources exist to "
            f"rebuild it (searched {list(_CANDIDATE_DIRS)!r})"
        )
    else:
        why = f"no native sources found in any of {list(_CANDIDATE_DIRS)!r}"
    warnings.warn(
        "streamz_tpu: native ingest layer unavailable — " + why +
        "; falling back to pure-Python ingest (identical results, much "
        "slower batch decode/resample). Build native/libstreamz_native.so "
        "to restore the fast path.",
        RuntimeWarning,
        stacklevel=3,
    )


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on demand; None if unavailable.

    A stale ``libstreamz_native.so`` from an older checkout (missing a
    newer export, or an older ``sz_version``) is rebuilt once with
    ``make -B`` instead of crashing the binding — ``available()`` must
    return False, never raise, so callers can fall back to pure Python.
    """
    global _lib, _load_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None

        def _existing_sos():
            return [
                p for p in (
                    os.path.join(d, "libstreamz_native.so")
                    for d in _CANDIDATE_DIRS
                ) if os.path.exists(p)
            ]

        def _bind_ok(so):
            try:
                lib = _bind(ctypes.CDLL(so))
            except (OSError, AttributeError):
                return None
            return lib if lib.sz_version() == SZ_NATIVE_VERSION else None

        if not _existing_sos():
            _try_build()
        for so in _existing_sos():
            lib = _bind_ok(so)
            if lib is not None:
                _lib = lib
                return lib
        # Every existing .so is stale/unloadable: force ONE rebuild (needs
        # sources) and prefer the freshly built artifact over any stale
        # prebuilt one found earlier in the candidate order.
        if _try_build(force=True):
            d = source_dir()
            built = os.path.join(d, "libstreamz_native.so") if d else None
            for so in ([built] if built else []) + _existing_sos():
                lib = _bind_ok(so)
                if lib is not None:
                    _lib = lib
                    return lib
        _load_failed = True
        _warn_unavailable()
        return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sz_version.restype = ctypes.c_int32
    lib.sz_decode_mp3.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.sz_read_wav.argtypes = lib.sz_decode_mp3.argtypes
    lib.sz_write_wav.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int16,
    ]
    lib.sz_batch_decode.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(_SzClip),
    ]
    lib.sz_batch_ingest.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(_SzClip),
    ]
    lib.sz_resample_i16.argtypes = [
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sz_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return load() is not None


def _clip_to_numpy(lib, clip: _SzClip) -> Optional[Tuple[np.ndarray, int, int]]:
    if clip.status != 0 or not clip.samples:
        return None
    arr = np.ctypeslib.as_array(clip.samples, shape=(clip.len,)).copy()
    lib.sz_free(clip.samples)
    return arr.astype(np.int16, copy=False), int(clip.rate), int(clip.channels)


def decode_file(path: str) -> Optional[Tuple[np.ndarray, int, int]]:
    """Decode one MP3/WAV natively → (interleaved i16, rate, channels)."""
    lib = load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_int64(0)
    rate = ctypes.c_int32(0)
    ch = ctypes.c_int32(0)
    fn = lib.sz_decode_mp3 if path.lower().endswith(".mp3") else lib.sz_read_wav
    rc = fn(os.fsencode(path), ctypes.byref(out), ctypes.byref(n),
            ctypes.byref(rate), ctypes.byref(ch))
    if rc != 0:
        return None
    arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    lib.sz_free(out)
    return arr.astype(np.int16, copy=False), int(rate.value), int(ch.value)


def batch_decode(
    paths: List[str], threads: int = 0
) -> List[Optional[Tuple[np.ndarray, int, int]]]:
    """Threaded native batch decode; per-path None on failure."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    if n == 0:
        return []
    # os.fsencode, not str.encode: a surrogate-escaped (non-UTF-8)
    # filename from os.listdir must fail only ITS clip, not raise
    # UnicodeEncodeError for the whole batch.
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    clips = (_SzClip * n)()
    lib.sz_batch_decode(c_paths, n, threads, clips)
    return [_clip_to_numpy(lib, clips[i]) for i in range(n)]


def batch_ingest(
    paths: List[str], target_rate: int = 44100, threads: int = 0
) -> List[Optional[Tuple[np.ndarray, int, int]]]:
    """Full threaded native ingest: decode → downmix → resample.

    Returns per-path (mono i16 at target_rate, target_rate, 1) or None.
    The resampler is the C++ twin of :mod:`streamz_tpu.dsp.resample`
    (bit-identical i16 output)."""
    if target_rate <= 0:
        # The C side rejects this too (a zero-output resampler plan would
        # corrupt the heap); fail loudly here with a Python-level message.
        raise ValueError(f"target_rate must be positive, got {target_rate}")
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    if n == 0:
        return []
    # os.fsencode, not str.encode: a surrogate-escaped (non-UTF-8)
    # filename from os.listdir must fail only ITS clip, not raise
    # UnicodeEncodeError for the whole batch.
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    clips = (_SzClip * n)()
    lib.sz_batch_ingest(c_paths, n, threads, target_rate, clips)
    return [_clip_to_numpy(lib, clips[i]) for i in range(n)]


def resample_i16_native(
    samples: np.ndarray, fs_in: int, fs_out: int
) -> Optional[np.ndarray]:
    """C++ FFT resample of i16 PCM; None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    pcm = np.ascontiguousarray(samples, dtype=np.int16)
    out = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_int64(0)
    rc = lib.sz_resample_i16(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        len(pcm), fs_in, fs_out, ctypes.byref(out), ctypes.byref(n),
    )
    if rc != 0:
        return None
    arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    lib.sz_free(out)
    return arr.astype(np.int16, copy=False)


def write_wav_native(path: str, samples: np.ndarray, rate: int = 44100) -> bool:
    lib = load()
    if lib is None:
        return False
    pcm = np.ascontiguousarray(samples, dtype=np.int16)
    rc = lib.sz_write_wav(
        os.fsencode(path),
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        len(pcm), rate, 1,
    )
    return rc == 0
