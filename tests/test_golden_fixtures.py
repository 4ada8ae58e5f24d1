"""Committed golden fixtures freeze the feature pipeline and npz schema.

Regenerating these files is a *deliberate* act (see the generation snippet in
the git history): any unintended numeric or format drift in the MFCC spec,
the JAX frontends, or the checkpoint codec fails here first.
"""

import os

import numpy as np

from streamz_tpu.dsp import mfcc, mfcc_ref
from streamz_tpu.nn import checkpoint

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _load(name):
    return np.load(os.path.join(FIX, name))


def test_numpy_spec_matches_golden_features():
    clip = _load("golden_clip.npy")
    want = _load("golden_features.npy")
    got = mfcc_ref.extract_features_np(clip)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_jax_frontend_matches_golden_features():
    clip = _load("golden_clip.npy")
    want = _load("golden_features.npy")
    got = mfcc.extract_features(clip)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_auto_extractor_matches_golden_features():
    from streamz_tpu.dsp.features import FeatureExtractor

    clip = _load("golden_clip.npy")
    want = _load("golden_features.npy")
    got = FeatureExtractor("auto").extract(clip)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_golden_checkpoint_loads_identically():
    net = checkpoint.load(os.path.join(FIX, "golden_model.npz"))
    assert net.num_speakers == 3
    assert net.file_lists[0] == ["data/a.wav"]
    assert net.file_lists[1] == []
    assert net.file_lists[2] == ["data/c.wav"]
    assert len(net.embeddings) == 3
    assert net.embeddings[1][1] == np.float32(0.6)
    enc = net.encoding_layer()
    assert enc is not None and enc[0].shape == (4, 16)

    x = _load("golden_model_input.npy")
    want = _load("golden_model_probs.npy")
    np.testing.assert_allclose(net.forward(x), want, atol=1e-5, rtol=1e-5)


def test_golden_npz_zip_entries():
    """The zip layout itself is frozen (numpy savez convention)."""
    import zipfile

    with zipfile.ZipFile(os.path.join(FIX, "golden_model.npz")) as z:
        names = set(z.namelist())
    assert "w3_1.npy" in names
    assert "speaker_0_files.npy" in names
    assert "w4_16.npy" in names
    assert "speaker_embeddings.npy" in names
