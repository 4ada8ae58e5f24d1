"""PCM-halo sharded MFCC frontend (window_parallel) vs the unsharded frontend.

The CP-analogue capability (SURVEY.md §5.7): a long clip's PCM block axis is
sharded across the mesh, halo blocks move via ppermute, and the features
must come out *bit-equal* to the single-device frontend
(``streamz-rs/src/lib.rs:288-318`` windowing + ``:212-228`` delta stencil).
"""

import numpy as np
import pytest

from streamz_tpu.dsp.mfcc import extract_features
from streamz_tpu.infer.embed import extract_embedding_from_features, normalize
from streamz_tpu.infer.identify import identify_speaker
from streamz_tpu.nn.model import SpeakerNet
from streamz_tpu.parallel import comm
from streamz_tpu.parallel import window_parallel as wp


@pytest.fixture(scope="module")
def mesh():
    return comm.make_mesh(8, axis=comm.WINDOW_AXIS)


def test_ten_minute_clip_bit_equal(mesh):
    """A 10-minute clip sharded over 8 devices reproduces the unsharded
    features bit-for-bit (the VERDICT-specified acceptance case)."""
    rng = np.random.default_rng(0)
    clip = rng.normal(0, 3000, size=600 * 44100).astype(np.int16)
    ref = extract_features(clip)
    shd = wp.mfcc_features_pcm_sharded(clip, mesh)
    assert ref.shape == shd.shape == (66149, 60)
    np.testing.assert_array_equal(ref, shd)


@pytest.mark.parametrize("n", [799, 800, 1200, 4001, 12345])
def test_ragged_lengths_bit_equal(mesh, n):
    """Shard-boundary/edge-clamp cases: clips whose window counts land on and
    around the per-device shard edges, incl. the zero-window case."""
    rng = np.random.default_rng(n)
    clip = rng.normal(0, 3000, size=n).astype(np.int16)
    ref = extract_features(clip)
    shd = wp.mfcc_features_pcm_sharded(clip, mesh)
    assert ref.shape == shd.shape
    np.testing.assert_array_equal(ref, shd)


def test_single_device_mesh_matches():
    mesh1 = comm.make_mesh(1, axis=comm.WINDOW_AXIS)
    rng = np.random.default_rng(3)
    clip = rng.normal(0, 3000, size=44100).astype(np.int16)
    np.testing.assert_array_equal(
        extract_features(clip), wp.mfcc_features_pcm_sharded(clip, mesh1)
    )


def test_fused_identify_and_embedding_match(mesh):
    """The fused SPMD programs (frontend + psum aggregation in one dispatch)
    agree with the unsharded identify/embedding paths."""
    rng = np.random.default_rng(1)
    clip = rng.normal(0, 3000, size=30 * 44100).astype(np.int16)
    net = SpeakerNet.new(output=5, seed=0)

    assert wp.identify_speaker_pcm_sharded(net, clip, mesh) == identify_speaker(
        net, clip
    )

    feats = extract_features(clip)
    e_ref = normalize(extract_embedding_from_features(net, feats))
    e_shd = wp.extract_embedding_pcm_sharded(net, clip, mesh)
    np.testing.assert_allclose(e_shd, e_ref, atol=1e-6)


def test_empty_clip(mesh):
    net = SpeakerNet.new(output=3, seed=0)
    clip = np.zeros((100,), np.int16)  # < one window
    assert wp.mfcc_features_pcm_sharded(clip, mesh).shape == (0, 60)
    assert wp.identify_speaker_pcm_sharded(net, clip, mesh) == 0
    emb = wp.extract_embedding_pcm_sharded(net, clip, mesh)
    assert emb.shape == (net.embedding_size(),)
    assert not emb.any()


def test_trailing_partial_block_clip(mesh):
    """Clip lengths whose trailing partial block overruns the shard buffer
    (13000 samples on the 8-device mesh) are handled — the extra
    samples feed no window, so features still match the unsharded frontend."""
    rng = np.random.default_rng(7)
    for n in (13000, 1999, 12800 + 1):
        clip = rng.normal(0, 3000, size=n).astype(np.int16)
        ref = extract_features(clip)
        shd = wp.mfcc_features_pcm_sharded(clip, mesh)
        assert ref.shape == shd.shape
        # Not bit-equal here: these lengths bucket the *unsharded* batch to a
        # 64-block GEMM whose CPU summation strategy differs from smaller Ms
        # (~1e-6 on z-normed features) — a dot-shape effect, not a halo bug.
        np.testing.assert_allclose(ref, shd, atol=1e-5)
        net = SpeakerNet.new(output=3, seed=0)
        wp.identify_speaker_pcm_sharded(net, clip, mesh)
        wp.extract_embedding_pcm_sharded(net, clip, mesh)


def test_long_clip_routing_in_batch_ingest(mesh, monkeypatch):
    """extract_features_batch routes clips at/above the long-clip threshold
    through the PCM-sharded frontend (all devices cooperate on one clip's
    window axis) while short clips keep the clip-axis-sharded batch path."""
    from streamz_tpu.dsp import mfcc
    from streamz_tpu.parallel import window_parallel as wp2

    monkeypatch.setattr(wp2, "LONG_CLIP_WINDOW_THRESHOLD", 64)
    rng = np.random.default_rng(9)
    long_clip = rng.normal(0, 3000, size=100 * 400 + 400).astype(np.int16)
    short_clip = rng.normal(0, 3000, size=8000).astype(np.int16)

    calls = {"n": 0}
    real = wp2.mfcc_features_pcm_sharded

    def spying(c, m):
        calls["n"] += 1
        return real(c, m)

    monkeypatch.setattr(wp2, "mfcc_features_pcm_sharded", spying)
    got = mfcc.extract_features_batch([long_clip, short_clip], mesh=mesh)
    assert calls["n"] == 1
    ref = mfcc.extract_features_batch([long_clip, short_clip])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_forced_backend_skips_pcm_sharded_route(mesh, monkeypatch):
    """The PCM-halo long-clip route computes features with the XLA
    formulation, so a caller *forcing* the host golden spec ('numpy') must
    not be routed through it.  'auto' keeps the cooperative route."""
    from streamz_tpu.dsp import mfcc
    from streamz_tpu.dsp.features import FeatureExtractor
    from streamz_tpu.parallel import window_parallel as wp2

    monkeypatch.setattr(wp2, "LONG_CLIP_WINDOW_THRESHOLD", 64)
    rng = np.random.default_rng(11)
    long_clip = rng.normal(0, 3000, size=100 * 400 + 400).astype(np.int16)

    calls = {"n": 0}
    real = wp2.mfcc_features_pcm_sharded

    def spying(c, m):
        calls["n"] += 1
        return real(c, m)

    monkeypatch.setattr(wp2, "mfcc_features_pcm_sharded", spying)
    forced = FeatureExtractor("numpy")
    got = forced.extract_batch([long_clip], mesh=mesh)
    assert calls["n"] == 0  # honored the forced spec
    np.testing.assert_array_equal(got[0], forced.extract(long_clip))

    FeatureExtractor("auto").extract_batch([long_clip], mesh=mesh)
    assert calls["n"] == 1  # the XLA-core route is faithful -> taken


def test_identify_forced_extractor_skips_fused_route(mesh, monkeypatch):
    """identify_speaker honors a caller-forced extractor: the fused
    PCM-sharded fast path (XLA features) is only taken for default/'auto'
    extractors."""
    from streamz_tpu.dsp.features import FeatureExtractor
    from streamz_tpu.infer import identify as idf
    from streamz_tpu.parallel import window_parallel as wp2

    monkeypatch.setattr(wp2, "LONG_CLIP_WINDOW_THRESHOLD", 16)
    rng = np.random.default_rng(12)
    net = SpeakerNet.new(output=4, seed=0)
    clip = rng.normal(0, 3000, size=40 * 400 + 400).astype(np.int16)

    calls = {"n": 0}
    real = wp2.identify_speaker_pcm_sharded

    def spying(n, c, m):
        calls["n"] += 1
        return real(n, c, m)

    monkeypatch.setattr(wp2, "identify_speaker_pcm_sharded", spying)
    ext = FeatureExtractor("numpy")
    got = idf.identify_speaker(net, clip, extractor=ext, mesh=mesh)
    assert calls["n"] == 0  # forced golden-spec features, no bypass
    assert got == idf.identify_speaker(net, clip, extractor=ext)
    idf.identify_speaker(net, clip, mesh=mesh)
    assert calls["n"] == 1  # default extractor still takes the fused path


def test_identify_with_threshold_mesh_routing(mesh, monkeypatch):
    """identify_speaker_with_threshold_feats routes long cached-feature sets
    through the sharded vote sums and agrees with the local path."""
    from streamz_tpu.infer import identify as idf
    from streamz_tpu.parallel import window_parallel as wp2

    monkeypatch.setattr(wp2, "LONG_CLIP_WINDOW_THRESHOLD", 32)
    rng = np.random.default_rng(10)
    net = SpeakerNet.new(output=4, seed=0)
    windows = rng.normal(0, 1, size=(100, 60)).astype(np.float32)
    local = idf.identify_speaker_with_threshold_feats(net, windows, 0.0)
    shard = idf.identify_speaker_with_threshold_feats(net, windows, 0.0, mesh=mesh)
    assert local == shard

    # identify_speaker on long PCM routes through the fused SPMD program.
    clip = rng.normal(0, 3000, size=40 * 400 + 400).astype(np.int16)
    monkeypatch.setattr(wp2, "LONG_CLIP_WINDOW_THRESHOLD", 16)
    calls = {"n": 0}
    real = wp2.identify_speaker_pcm_sharded

    def spying(n, c, m):
        calls["n"] += 1
        return real(n, c, m)

    monkeypatch.setattr(wp2, "identify_speaker_pcm_sharded", spying)
    got = idf.identify_speaker(net, clip, mesh=mesh)
    assert calls["n"] == 1
    assert got == idf.identify_speaker(net, clip)
