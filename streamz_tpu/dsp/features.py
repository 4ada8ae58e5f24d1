"""FeatureExtractor facade + the ``feature_cache/*.npy`` load-or-compute layer.

Mirrors the reference's ``FeatureExtractor`` (``streamz-rs/src/lib.rs:231-264``),
``with_thread_extractor`` (``:266-276``) and ``load_cached_features``
(``:558-579``).  On the device there is no per-thread FFT plan to cache — the
jitted frontend is process-global — so the "extractor" is a thin stateless
facade and ``with_thread_extractor`` simply hands it out.

The device frontend is the XLA formulation (:mod:`streamz_tpu.dsp.mfcc`).
A fused Pallas/Triton kernel for it lost to XLA on an H100 at every
precision that passes the 1e-3 parity gate, and was removed; the backend
names that chose a device frontend now raise.
"""

from __future__ import annotations

import os
from typing import Callable, List, Sequence, TypeVar

import numpy as np

from streamz_tpu.dsp import mfcc, mfcc_ref
from streamz_tpu.io import audio

R = TypeVar("R")

# 'auto' runs the XLA frontend on the device; 'numpy' is the host-side
# golden spec.  The names that chose between device frontends went with the
# Pallas kernels.
_BACKENDS = ("auto", "numpy")
_REMOVED = ("jax", "pallas", "pallas_v2", "pallas_v3", "pallas_v4")


def _check_backend(backend: str) -> None:
    if backend in _REMOVED:
        raise ValueError(
            f"frontend backend {backend!r} was removed: the XLA frontend is "
            "the only device frontend; use 'auto'"
        )
    if backend not in _BACKENDS:
        raise ValueError(f"unknown frontend backend {backend!r}")


class FeatureExtractor:
    """Stateless MFCC frontend facade.

    ``backend='auto'`` (default) runs the XLA frontend on the device;
    ``'numpy'`` runs the golden CPU spec (parity tests and the bench
    baseline).
    """

    def __init__(self, backend: str = "auto"):
        _check_backend(backend)
        self.backend = backend

    def extract(self, samples: np.ndarray) -> np.ndarray:
        """PCM (i16 or f32) → [n_windows, 60] float32."""
        if self.backend == "numpy":
            return mfcc_ref.extract_features_np(samples)
        return mfcc.extract_features(samples)

    def extract_batch(
        self, clips: Sequence[np.ndarray], mesh=None, store=None
    ) -> List[np.ndarray]:
        """Batched extraction; with ``mesh`` the clip axis is sharded across
        the data mesh (only the numpy golden spec is host-only).  With
        ``store`` (a :class:`~streamz_tpu.dsp.mfcc.DeviceFeatureStore`) the
        device outputs are additionally kept device-resident for
        downstream device consumers."""
        if self.backend == "numpy":
            return [mfcc_ref.extract_features_np(c) for c in clips]
        return mfcc.extract_features_batch(clips, mesh=mesh, store=store)


_GLOBAL_EXTRACTOR = FeatureExtractor()


def with_thread_extractor(f: Callable[[FeatureExtractor], R]) -> R:
    """Run a closure with the process-global extractor (src/lib.rs:271-276)."""
    return f(_GLOBAL_EXTRACTOR)


def save_cached_features(path: str, feats: np.ndarray) -> None:
    """Publish ``feature_cache/<sanitized>.npy`` atomically (temp + rename
    in the cache dir): a concurrent reader — another process
    training/evaluating the same corpus — must never observe a
    partially-written .npy."""
    import tempfile

    cache = audio.feature_cache_path(path)
    fd, tmp = tempfile.mkstemp(
        prefix=cache.name + ".", suffix=".tmp", dir=str(cache.parent)
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.save(f, feats)
        os.replace(tmp, cache)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_cached_features(
    path: str, extractor: FeatureExtractor | None = None
) -> np.ndarray:
    """Load ``feature_cache/<sanitized>.npy`` or compute+store it
    (src/lib.rs:558-579).  Returns [n_windows, 60] float32."""
    extractor = extractor or _GLOBAL_EXTRACTOR
    cache = audio.feature_cache_path(path)
    if cache.exists():
        try:
            return np.load(cache).astype(np.float32)
        except Exception:
            # Torn cache file (writer interrupted mid-save, or two
            # processes raced before writes were atomic): recompute and
            # overwrite instead of aborting every future run.
            pass
    samples = audio.load_audio_samples(path)
    feats = extractor.extract(samples)
    save_cached_features(path, feats)
    return feats
