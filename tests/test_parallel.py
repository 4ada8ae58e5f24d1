"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from streamz_tpu.nn import train as T
from streamz_tpu.nn.model import SpeakerNet
from streamz_tpu.parallel import comm, data_parallel as dp, window_parallel as wp


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_dp_step_matches_single_device():
    """Sharded psum step == the single-device corpus step, bit-for-bit-ish."""
    mesh = comm.make_mesh(8)
    net = SpeakerNet.new(input_size=8, hidden1=16, hidden2=8, output=2, seed=3)
    rng = np.random.default_rng(0)
    B = 64  # divisible by 8
    x = rng.normal(size=(B, 8)).astype(np.float32)
    y = rng.integers(0, 2, size=(B,)).astype(np.int32)
    w = np.ones((B,), np.float32)

    want_params, want_loss = T.corpus_step(
        net.params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
        jnp.int32(2), 0.05,
    )

    step = dp.make_dp_train_step(mesh)
    xb, yb, wb = dp.shard_arrays(mesh, x, y, w)
    got_params, got_loss = step(
        net.params, xb, yb, wb, jnp.int32(2), jnp.float32(0.05)
    )
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    for k in want_params:
        np.testing.assert_allclose(
            np.asarray(got_params[k]), np.asarray(want_params[k]),
            atol=1e-5, rtol=1e-4, err_msg=k,
        )


def test_dp_step_invariant_to_device_count():
    """Global-batch semantics: same result on 2 and 8 devices."""
    net = SpeakerNet.new(input_size=8, hidden1=16, hidden2=8, output=2, seed=5)
    rng = np.random.default_rng(1)
    B = 32
    x = rng.normal(size=(B, 8)).astype(np.float32)
    y = rng.integers(0, 2, size=(B,)).astype(np.int32)
    w = np.ones((B,), np.float32)

    outs = []
    for n in (2, 8):
        mesh = comm.make_mesh(n)
        step = dp.make_dp_train_step(mesh)
        xb, yb, wb = dp.shard_arrays(mesh, x, y, w)
        p, loss = step(net.params, xb, yb, wb, jnp.int32(2), jnp.float32(0.05))
        outs.append((p, float(loss)))
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-5)
    for k in outs[0][0]:
        np.testing.assert_allclose(
            np.asarray(outs[0][0][k]), np.asarray(outs[1][0][k]),
            atol=1e-5, rtol=1e-4,
        )


def test_dp_epoch_scan():
    mesh = comm.make_mesh(8)
    net = SpeakerNet.new(input_size=8, hidden1=16, hidden2=8, output=2, seed=9)
    rng = np.random.default_rng(2)
    steps, B = 10, 64
    x = np.concatenate([
        rng.normal(+1, 1, size=(steps, B // 2, 8)),
        rng.normal(-1, 1, size=(steps, B // 2, 8)),
    ], axis=1).astype(np.float32)
    y = np.concatenate([
        np.zeros((steps, B // 2)), np.ones((steps, B // 2))
    ], axis=1).astype(np.int32)
    w = np.ones((steps, B), np.float32)

    epoch = dp.make_dp_train_epoch(mesh, steps=steps)
    params, losses = epoch(
        net.params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
        jnp.int32(2), jnp.float32(0.1),
    )
    losses = np.asarray(losses)
    assert losses.shape == (steps,)
    assert losses[-1] < losses[0]


def test_window_sharded_votes_match_local():
    mesh = wp.make_window_mesh(8)
    net = SpeakerNet.new(input_size=8, hidden1=16, hidden2=8, output=3, seed=11)
    rng = np.random.default_rng(3)
    W = 40  # windows, padded to 40 (divisible by 8)
    windows = rng.normal(size=(W, 8)).astype(np.float32)
    valid = (np.arange(W) < 37).astype(np.float32)

    step = wp.make_sharded_vote_step(mesh)
    sums, count = step(net.params, jnp.asarray(windows), jnp.asarray(valid),
                       jnp.int32(3))
    want = net.forward(windows[:37]).sum(axis=0)
    np.testing.assert_allclose(np.asarray(sums)[:3], want, atol=1e-4, rtol=1e-4)
    assert float(count) == 37.0


def test_window_sharded_embedding_matches_local():
    mesh = wp.make_window_mesh(8)
    net = SpeakerNet.new(input_size=8, hidden1=16, hidden2=8, output=2, seed=13)
    rng = np.random.default_rng(4)
    W = 24
    windows = rng.normal(size=(W, 8)).astype(np.float32)
    valid = np.ones((W,), np.float32)

    step = wp.make_sharded_embedding_step(mesh)
    got = step(net.params, jnp.asarray(windows), jnp.asarray(valid))
    want = net.forward_embedding_np(windows).mean(axis=0)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5, rtol=1e-4)


def test_identify_speaker_sharded_matches_host():
    from streamz_tpu.infer import identify
    mesh = wp.make_window_mesh(8)
    net = SpeakerNet.new(input_size=8, hidden1=16, hidden2=8, output=3, seed=21)
    rng = np.random.default_rng(6)
    windows = rng.normal(size=(37, 8)).astype(np.float32)
    want = int(net.forward(windows).sum(axis=0).argmax())
    got = wp.identify_speaker_sharded(net, windows, mesh)
    assert got == want


def test_extract_embedding_sharded_matches_host():
    from streamz_tpu.infer.embed import extract_embedding_from_features
    mesh = wp.make_window_mesh(8)
    net = SpeakerNet.new(input_size=8, hidden1=16, hidden2=8, output=2, seed=22)
    rng = np.random.default_rng(7)
    windows = rng.normal(size=(19, 8)).astype(np.float32)
    want = extract_embedding_from_features(net, windows)
    got = wp.extract_embedding_sharded(net, windows, mesh)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_frontend_matches_unsharded(monkeypatch, n_dev):
    """The clip-axis-sharded frontend is bit-equal to the unsharded run at
    any mesh size, and the shard_map path is actually taken."""
    from streamz_tpu.dsp import mfcc

    mesh = comm.make_mesh(n_dev)
    rng = np.random.default_rng(0)
    clips = [
        rng.normal(0, 3000, size=n).astype(np.int16)
        for n in (44100, 22050, 44100, 8000, 60000)
    ]

    calls = {"n": 0}
    real = mfcc.sharded_frontend

    def spying(m):
        calls["n"] += 1
        return real(m)

    monkeypatch.setattr(mfcc, "sharded_frontend", spying)
    unsharded = mfcc.extract_features_batch(clips)
    assert calls["n"] == 0
    sharded = mfcc.extract_features_batch(clips, mesh=mesh)
    assert calls["n"] > 0  # the frontend went through shard_map
    for a, b in zip(unsharded, sharded):
        np.testing.assert_array_equal(a, b)


def test_extractor_keeps_mesh_for_pallas_backend(monkeypatch):
    """FeatureExtractor hands the mesh to the batched frontend, so the
    ingest stage stays sharded."""
    from streamz_tpu.dsp import mfcc
    from streamz_tpu.dsp.features import FeatureExtractor

    mesh = comm.make_mesh(8)
    seen = {}
    real = mfcc.extract_features_batch

    def spying(clips, mesh=None, **kw):
        seen["mesh"] = mesh
        return real(clips, mesh=mesh, **kw)

    monkeypatch.setattr(mfcc, "extract_features_batch", spying)
    # features.py imported `mfcc` as a module, so the monkeypatch is seen.
    rng = np.random.default_rng(1)
    clips = [rng.normal(0, 3000, size=12000).astype(np.int16)]
    FeatureExtractor("auto").extract_batch(clips, mesh=mesh)
    assert seen["mesh"] is mesh


def test_sharded_identify_zero_speakers_returns_zero():
    """num_speakers == 0 is a loadable checkpoint state: the sharded
    identify helpers must return 0 like the unsharded path (unwrap_or(0)),
    not raise argmax-of-empty."""
    from streamz_tpu import config

    mesh = comm.make_mesh(8)
    net = SpeakerNet.new(output=1, seed=0)
    net.num_speakers = 0
    wins = np.random.default_rng(0).normal(
        size=(32, config.FEATURE_SIZE)).astype(np.float32)
    assert wp.identify_speaker_sharded(net, wins, mesh) == 0
    pcm = (np.random.default_rng(1).normal(0, 3000, size=20000)
           ).astype(np.int16)
    assert wp.identify_speaker_pcm_sharded(net, pcm, mesh) == 0


def test_pad_to_mesh_handles_1d_and_empty():
    """A bare [F] vector is ONE window; an empty input keeps the model's
    feature width (reshape(len,-1) used to turn [60] into a garbage
    [60,1] and [] into width-1 rows)."""
    from streamz_tpu import config

    mesh = comm.make_mesh(8)
    one = np.arange(config.FEATURE_SIZE, dtype=np.float32)
    padded, valid = wp._pad_to_mesh(one, mesh)
    assert padded.shape[1] == config.FEATURE_SIZE and valid.sum() == 1
    padded, valid = wp._pad_to_mesh([], mesh)
    assert padded.shape[1] == config.FEATURE_SIZE and valid.sum() == 0
    # and the public consumer works end-to-end on both
    net = SpeakerNet.new(output=2, seed=0)
    assert wp.identify_speaker_sharded(net, one, mesh) in (0, 1)


def test_make_mesh_rejects_overrequest():
    with pytest.raises(ValueError, match="only"):
        comm.make_mesh(64)
