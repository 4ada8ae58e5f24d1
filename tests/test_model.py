"""SpeakerNet forward/growth semantics tests."""

import numpy as np
import pytest
import jax.numpy as jnp

from streamz_tpu.nn import model as M
from streamz_tpu.nn.model import SpeakerNet


def test_forward_matches_numpy_reference():
    """forward == relu -> tanh -> masked softmax (src/lib.rs:880-891)."""
    net = SpeakerNet.new(input_size=6, hidden1=5, hidden2=4, output=3, seed=1)
    x = np.random.default_rng(0).normal(size=(7, 6)).astype(np.float32)

    w1 = np.asarray(net.params["w1"]); b1 = np.asarray(net.params["b1"])
    w2 = np.asarray(net.params["w2"]); b2 = np.asarray(net.params["b2"])
    w3, b3 = net.output_layer()
    h1 = np.maximum(x @ w1 + b1, 0.0)
    h2 = np.tanh(h1 @ w2 + b2)
    logits = h2 @ w3 + b3
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    want = e / e.sum(axis=-1, keepdims=True)

    got = net.forward(x)
    assert got.shape == (7, 3)
    # XLA's tanh/matmul differ from numpy's at the few-ULP level in f32.
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_masked_capacity_columns_are_zero_prob():
    net = SpeakerNet.new(input_size=6, hidden1=5, hidden2=4, output=2, seed=1)
    x = jnp.ones((3, 6), jnp.float32)
    full = np.asarray(M.forward(net.params, x, net.num_speakers))
    assert full.shape[-1] == net.capacity
    assert np.all(full[:, 2:] == 0.0)
    np.testing.assert_allclose(full.sum(axis=-1), 1.0, rtol=1e-6)


def test_add_output_class_grows_logically():
    net = SpeakerNet.new(input_size=6, hidden1=5, hidden2=4, output=2, seed=1)
    x = np.random.default_rng(1).normal(size=(4, 6)).astype(np.float32)
    before = net.forward(x)
    cap0 = net.capacity
    net.add_output_class()
    assert net.output_size() == 3
    assert len(net.file_lists) == 3
    after = net.forward(x)
    assert after.shape == (4, 3)
    # Existing columns' logits unchanged; probabilities renormalize.
    w3b, b3b = net.output_layer()
    assert b3b[2] == 0.0
    # growth within capacity must not reallocate
    assert net.capacity == cap0


def test_capacity_doubles_when_exhausted():
    net = SpeakerNet.new(input_size=4, hidden1=3, hidden2=2, output=1, seed=0)
    cap0 = net.capacity
    for _ in range(cap0):
        net.add_output_class()
    assert net.output_size() == cap0 + 1
    assert net.capacity == 2 * cap0


def test_embed_heads_differ():
    """embed uses tanh-h2, forward_embedding uses ReLU-h2."""
    net = SpeakerNet.new(input_size=6, hidden1=5, hidden2=4, output=2, seed=2)
    x = np.random.default_rng(2).normal(size=(3, 6)).astype(np.float32)
    tanh_e = net.embed_np(x)
    relu_e = net.forward_embedding_np(x)
    assert tanh_e.shape == relu_e.shape == (3, 4)
    assert np.all(tanh_e <= 1.0) and np.all(tanh_e >= -1.0)
    assert np.all(relu_e >= 0.0)
    assert not np.allclose(tanh_e, relu_e)


def test_record_training_file_dedup():
    net = SpeakerNet.new(input_size=4, hidden1=3, hidden2=2, output=1, seed=0)
    net.record_training_file(2, "a.wav")
    net.record_training_file(2, "a.wav")
    assert net.file_lists[2] == ["a.wav"]
    assert len(net.file_lists) == 3


def test_set_output_layer():
    net = SpeakerNet.new(input_size=4, hidden1=3, hidden2=2, output=1, seed=0)
    w3 = np.ones((2, 5), np.float32)
    b3 = np.arange(5, dtype=np.float32)
    net.set_output_layer(w3, b3)
    assert net.num_speakers == 5
    got_w3, got_b3 = net.output_layer()
    np.testing.assert_allclose(got_w3, w3)
    np.testing.assert_allclose(got_b3, b3)


def test_reference_method_surface_train_and_save(tmp_path):
    """SimpleNeuralNet method parity: train/train_batch/train_bits/
    forward_bits/save/load as instance methods."""
    net = SpeakerNet.new(input_size=4, hidden1=3, hidden2=2, output=2, seed=6)
    x = np.array([0.1, -0.2, 0.3, 0.4], np.float32)
    w1_before = np.asarray(net.params["w1"]).copy()
    net.train(x, [1.0, 0.0], 0.1)
    assert not np.allclose(np.asarray(net.params["w1"]), w1_before)

    net.train_batch(np.stack([x, -x]), [0.0, 1.0], 0.1)
    net.train_bits(x, np.ones(net.capacity), 0.5)
    bits = net.forward_bits(x)
    # Live width, not capacity: the reference's output layer IS exactly the
    # trained size — capacity-padding columns are random init, and exposing
    # them would hand shape-derived consumers phantom bits.
    assert bits.shape == (net.num_speakers,)
    assert np.all((bits >= 0) & (bits <= 1))

    p = str(tmp_path / "m.npz")
    net.save(p)
    got = SpeakerNet.load(p)
    np.testing.assert_allclose(
        np.asarray(got.params["w1"]), np.asarray(net.params["w1"])
    )


def test_weights_change_after_training():
    """Port of the reference's own unit test (src/lib.rs:1831-1851)."""
    net = SpeakerNet.new(input_size=4, hidden1=3, hidden2=2, output=2, seed=9)
    before = {k: np.asarray(v).copy() for k, v in net.params.items()}
    net.train_batch(np.array([[0.1, -0.2, 0.3, 0.4]], np.float32), [1.0, 0.0], 0.1)
    changed = any(
        not np.array_equal(np.asarray(net.params[k]), before[k])
        for k in ("w1", "w2", "b1", "b2")
    )
    assert changed, "weights did not change after training step"


def test_zero_speaker_forward_is_all_zero():
    """num_speakers == 0 (a loadable checkpoint state) must keep the
    documented invariant — inactive columns exactly 0.0 — instead of the
    degenerate uniform 1/capacity softmax."""
    import jax.numpy as jnp

    from streamz_tpu.nn.model import SpeakerNet, forward

    net = SpeakerNet.new(output=1, seed=0)
    x = jnp.ones((3, 60), jnp.float32)
    probs = np.asarray(forward(net.params, x, 0))
    np.testing.assert_array_equal(probs, np.zeros_like(probs))


def test_set_output_layer_never_shrinks_capacity():
    """ensure_capacity pre-sizes the buffer so on-device growth never
    recompiles; installing a smaller live layer must keep that width
    (capacity-sized companion state may already exist)."""
    net = SpeakerNet.new(input_size=4, hidden1=3, hidden2=2, output=1, seed=0)
    net.ensure_capacity(512)
    assert net.capacity >= 512
    cap_before = net.capacity
    net.set_output_layer(np.ones((2, 5), np.float32),
                         np.arange(5, dtype=np.float32))
    assert net.capacity == cap_before and net.num_speakers == 5
    w3, b3 = net.output_layer()
    np.testing.assert_allclose(b3, np.arange(5, dtype=np.float32))


@pytest.mark.parametrize("num_speakers", [1, 64, 130])
def test_full_width_forward_matches_float64(num_speakers):
    """The reference 60->512->256->S classifier at full width (capacity 128
    or 256) against a float64 forward."""
    import jax.numpy as jnp

    import chip_smoke
    from streamz_tpu.nn.model import SpeakerNet, forward

    net = SpeakerNet.new(output=num_speakers, seed=num_speakers)
    assert net.capacity == (128 if num_speakers <= 128 else 256)
    x = np.random.default_rng(0).normal(size=(2048, 60)).astype(np.float32)
    got = np.asarray(forward(net.params, jnp.asarray(x), num_speakers))
    want = chip_smoke.probs_f64(net.params, x, num_speakers)
    np.testing.assert_allclose(got, want, atol=1e-5)
