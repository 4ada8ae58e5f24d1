"""MFCC frontend tests: numpy golden spec vs the JAX/XLA implementation."""

import os

import numpy as np
import pytest

from streamz_tpu import config
from streamz_tpu.dsp import mel as melmod
from streamz_tpu.dsp import mfcc, mfcc_ref
from streamz_tpu.dsp.features import FeatureExtractor, load_cached_features

REF_DATA = "/root/reference/streamz-rs/examples/training_data"


def _tone(n, freq=440.0, rate=44100, amp=12000):
    t = np.arange(n) / rate
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.int16)


# ---------------------------------------------------------------------------
# Spec-level properties of the golden numpy implementation.
# ---------------------------------------------------------------------------


def test_window_counts():
    assert mfcc_ref.extract_features_np(np.zeros(799, np.int16)).shape == (0, 60)
    assert mfcc_ref.extract_features_np(np.zeros(800, np.int16)).shape == (1, 60)
    assert mfcc_ref.extract_features_np(np.zeros(1199, np.int16)).shape == (1, 60)
    assert mfcc_ref.extract_features_np(np.zeros(1200, np.int16)).shape == (2, 60)
    assert mfcc_ref.extract_features_np(_tone(4000)).shape == (9, 60)


def test_per_frame_znorm():
    feats = mfcc_ref.extract_features_np(_tone(8000, freq=880))
    np.testing.assert_allclose(feats.mean(axis=1), 0.0, atol=1e-5)
    np.testing.assert_allclose(feats.std(axis=1), 1.0, atol=1e-4)


def test_mel_filterbank_shape_and_coverage():
    fb = melmod.mel_filterbank()
    assert fb.shape == (26, 401)
    assert np.all(fb >= 0)
    # Triangles overlap: every interior bin inside (fmin, fmax) is covered.
    assert np.all(fb.sum(axis=0)[5:395] > 0)


def test_dct2_matrix_unnormalized():
    d = melmod.dct2_matrix(4, 4)
    x = np.array([1.0, 2.0, 3.0, 4.0])
    got = d @ x
    want = np.array(
        [
            sum(x[n] * np.cos(np.pi / 4 * (n + 0.5) * k) for n in range(4))
            for k in range(4)
        ]
    )
    np.testing.assert_allclose(got, want, atol=1e-12)
    # k=0 row is the plain sum (no 1/sqrt scaling).
    np.testing.assert_allclose(got[0], x.sum(), atol=1e-12)


def test_deltas_edge_clamped():
    # Construct a signal with >=3 windows and verify the delta stencil on the
    # base coefficients directly.
    x = np.concatenate([_tone(1600, 300), _tone(1600, 1200), _tone(1600, 3000)])
    feats = mfcc_ref.extract_features_np(x)
    n = feats.shape[0]
    assert n >= 3
    # Recompute base+deltas manually from the pipeline pieces.
    xf = x.astype(np.float32) / 32767.0
    idx = np.arange(n)[:, None] * 400 + np.arange(800)[None, :]
    spec = np.fft.fft(xf[idx], axis=-1)[:, :401]
    power = (spec.real**2 + spec.imag**2).astype(np.float64)
    mel_log = np.log(np.maximum(power @ melmod.mel_filterbank().T, 1e-12))
    base = mel_log @ melmod.dct2_matrix().T
    d1 = mfcc_ref._add_deltas(base)
    # First frame: (base[1]-base[0])/2 (prev clamps to self).
    np.testing.assert_allclose(d1[0], (base[1] - base[0]) / 2.0)
    np.testing.assert_allclose(d1[-1], (base[-1] - base[-2]) / 2.0)


# ---------------------------------------------------------------------------
# JAX implementation vs golden.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [800, 1999, 4000, 44100])
def test_jax_matches_golden_tone(n):
    x = _tone(n, freq=523.25)
    want = mfcc_ref.extract_features_np(x)
    got = mfcc.extract_features(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_jax_matches_golden_noise():
    rng = np.random.default_rng(42)
    x = (rng.normal(0, 4000, size=22050)).astype(np.int16)
    want = mfcc_ref.extract_features_np(x)
    got = mfcc.extract_features(x)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_jax_batch_ragged():
    rng = np.random.default_rng(0)
    clips = [
        (rng.normal(0, 3000, size=n)).astype(np.int16)
        for n in (900, 4410, 12000, 799)
    ]
    got = mfcc.extract_features_batch(clips)
    for c, g in zip(clips, got):
        want = mfcc_ref.extract_features_np(c)
        assert g.shape == want.shape
        if len(want):
            np.testing.assert_allclose(g, want, atol=2e-3, rtol=1e-3)


def test_batch_matches_single_extraction():
    """Batched and single-clip extraction agree tightly: the feature cache
    may now be published from batched ingest outputs
    (compute_speaker_embeddings' feature_map path), so the two paths must
    be interchangeable well inside the 1e-3 golden gate."""
    rng = np.random.default_rng(1)
    clips = [
        (rng.normal(0, 3000, size=n)).astype(np.int16)
        for n in (1700, 9000, 4410)
    ]
    batched = mfcc.extract_features_batch(clips)
    for c, b in zip(clips, batched):
        single = mfcc.extract_features(c)
        np.testing.assert_allclose(b, single, atol=1e-5, rtol=1e-5)


def test_short_clip_empty():
    assert mfcc.extract_features(np.zeros(100, np.int16)).shape == (0, 60)


@pytest.mark.skipif(not os.path.isdir(REF_DATA), reason="reference data absent")
def test_jax_matches_golden_real_speech(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from streamz_tpu.io import audio as audio_io

    p = os.path.join(REF_DATA, "common_voice_fr_41911269.mp3")
    samples = audio_io.load_audio_samples(p)
    want = mfcc_ref.extract_features_np(samples)
    got = mfcc.extract_features(samples)
    assert want.shape[0] > 100
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_feature_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from streamz_tpu.io import wav as wavio

    p = str(tmp_path / "clip.wav")
    wavio.write_wav(p, _tone(4000))
    ex = FeatureExtractor()
    feats = load_cached_features(p, ex)
    cache_file = tmp_path / "feature_cache" / f"{str(p).replace('/', '_')}.npy"
    assert cache_file.exists()
    again = load_cached_features(p, ex)
    np.testing.assert_array_equal(feats, again)
    # Cache is authoritative: loading uses the stored array.
    np.save(cache_file, np.zeros((2, 60), np.float32))
    assert load_cached_features(p, ex).shape == (2, 60)


def test_feature_cache_torn_file_recovers(tmp_path, monkeypatch):
    """A truncated/corrupt cache .npy (writer killed mid-save before writes
    were atomic, or a concurrent-writer race) must be recomputed and
    overwritten, not crash every later run; writes publish atomically with
    no temp litter."""
    monkeypatch.chdir(tmp_path)
    from streamz_tpu.io import wav as wavio

    p = str(tmp_path / "clip.wav")
    wavio.write_wav(p, _tone(4000))
    ex = FeatureExtractor()
    feats = load_cached_features(p, ex)
    cache_file = tmp_path / "feature_cache" / f"{str(p).replace('/', '_')}.npy"
    cache_file.write_bytes(b"\x93NUMPY truncated garbage")
    again = load_cached_features(p, ex)
    np.testing.assert_allclose(again, feats, atol=1e-6)
    # The torn file was replaced by a loadable one, atomically (no litter).
    np.testing.assert_allclose(np.load(cache_file), feats, atol=1e-6)
    leftovers = [
        f for f in (tmp_path / "feature_cache").iterdir()
        if f.suffix == ".tmp"
    ]
    assert leftovers == []


def test_zero_window_clip_features_are_cached(tmp_path, monkeypatch):
    """A clip shorter than one window caches its (0, 60) feature array, so
    later loads hit the cache instead of re-running load+extract on every
    call forever (np.save/load round-trip empty arrays fine)."""
    import os

    from streamz_tpu.dsp.features import (
        load_cached_features, save_cached_features,
    )
    from streamz_tpu.io import audio as io_audio, wav as wavio

    monkeypatch.chdir(tmp_path)
    p = "tiny.wav"
    wavio.write_wav(p, np.zeros(100, np.int16), 44100)  # < one 800 window
    feats = load_cached_features(p)
    assert feats is not None and feats.shape[0] == 0
    cache = io_audio.feature_cache_path(p)
    assert cache.exists()
    cached = np.load(cache)
    assert cached.shape[0] == 0


# ---------------------------------------------------------------------------
# The device frontend at real widths, and its backend names.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n_clips,seconds", [(1, 10.0), (4, 10.0), (8, 2.5), (3, 0.05)]
)
def test_xla_frontend_matches_golden_at_real_widths(n_clips, seconds):
    """The batched device frontend (explicit float32 matmuls) against the
    float64 golden spec at the identify pipeline's 10 s clips, within the
    1e-3 parity gate."""
    rng = np.random.default_rng(n_clips)
    n = int(seconds * 44100)
    clips = [
        (_tone(n, freq=110.0 * (i + 1)) // 2
         + rng.normal(0, 800, n).astype(np.int16))
        for i in range(n_clips)
    ]
    got = mfcc.extract_features_batch(clips)
    for g, c in zip(got, clips):
        want = mfcc_ref.extract_features_np(c)
        assert g.shape == want.shape
        if len(want):
            assert np.abs(g - want).max() <= 1e-3


def test_frontend_precision_is_explicit():
    """The device GEMMs' precision is set, never left to the platform
    default (TF32 on the GPU fails the parity gate), and the frontend and
    the classifier share it."""
    import jax

    from streamz_tpu import precision
    from streamz_tpu.nn import model

    assert precision.MATMUL == jax.lax.Precision.HIGHEST
    assert mfcc.MATMUL is model.MATMUL is precision.MATMUL


@pytest.mark.parametrize(
    "backend", ["pallas", "pallas_v2", "pallas_v3", "pallas_v4"]
)
def test_removed_pallas_backends_raise(backend):
    with pytest.raises(ValueError, match="removed"):
        FeatureExtractor(backend)


def test_auto_is_the_only_device_frontend():
    """'auto' is the one device frontend (the XLA formulation); 'jax',
    which once forced it over a kernel, raises like the kernels' names."""
    clip = np.random.default_rng(5).normal(0, 3000, 4000).astype(np.int16)
    np.testing.assert_array_equal(FeatureExtractor("auto").extract(clip),
                                  mfcc.extract_features(clip))
    with pytest.raises(ValueError, match="removed"):
        FeatureExtractor("jax")
    with pytest.raises(ValueError, match="unknown"):
        FeatureExtractor("triton")
