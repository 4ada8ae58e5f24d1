"""Training-step tests: gradient parity vs a numpy backprop oracle,
reference batch semantics, and convergence."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from streamz_tpu.nn import drivers, train as T
from streamz_tpu.nn.model import SpeakerNet, forward


def _np_params(net):
    return {k: np.asarray(v, np.float64) for k, v in net.params.items()}


def _oracle_batch_step(params, batch, target_live, lr, num_speakers):
    """Numpy replica of the reference's train_batch math (src/lib.rs:1002-1060):
    sum per-sample grads over the batch, update with lr/batch_len on the live
    w3 slice only."""
    w1, b1 = params["w1"], params["b1"]
    w2, b2 = params["w2"], params["b2"]
    w3, b3 = params["w3"].copy(), params["b3"].copy()
    w3l = w3[:, :num_speakers]
    b3l = b3[:num_speakers]
    g = {k: np.zeros_like(v) for k, v in params.items()}
    for x in batch:
        h1_pre = x @ w1 + b1
        h1 = np.maximum(h1_pre, 0)
        h2 = np.tanh(h1 @ w2 + b2)
        z = h2 @ w3l + b3l
        e = np.exp(z - z.max())
        out = e / e.sum()
        delta = out - target_live
        g["w3"][:, :num_speakers] += np.outer(h2, delta)
        g["b3"][:num_speakers] += delta
        dh2 = (delta @ w3l.T) * (1 - h2**2)
        g["w2"] += np.outer(h1, dh2)
        g["b2"] += dh2
        dh1 = (dh2 @ w2.T) * (h1_pre > 0)
        g["w1"] += np.outer(x, dh1)
        g["b1"] += dh1
    scale = lr / len(batch)
    return {k: params[k] - scale * g[k] for k in params}


def test_train_batch_matches_oracle():
    net = SpeakerNet.new(input_size=6, hidden1=5, hidden2=4, output=3, seed=11)
    rng = np.random.default_rng(0)
    batch = rng.normal(size=(4, 6)).astype(np.float32)
    target_live = np.array([0.0, 1.0, 0.0])
    cap = net.capacity
    target = np.zeros((4, cap), np.float32)
    target[:, 1] = 1.0

    want = _oracle_batch_step(_np_params(net), batch, target_live, 0.1, 3)
    got = T.train_batch(
        net.params, jnp.asarray(batch), jnp.asarray(target), 0.1, jnp.int32(3)
    )
    for k in want:
        np.testing.assert_allclose(
            np.asarray(got[k], np.float64), want[k], atol=1e-4, rtol=1e-3,
            err_msg=k,
        )


def test_out_of_range_target_pushes_all_down():
    """Zero target vector -> delta = softmax (reference quirk,
    src/lib.rs:592-594 + :1028)."""
    net = SpeakerNet.new(input_size=6, hidden1=5, hidden2=4, output=2, seed=3)
    rng = np.random.default_rng(1)
    batch = rng.normal(size=(2, 6)).astype(np.float32)
    cap = net.capacity
    zero_target = np.zeros((2, cap), np.float32)

    want = _oracle_batch_step(
        _np_params(net), batch, np.zeros(2), 0.05, 2
    )
    got = T.train_batch(
        net.params, jnp.asarray(batch), jnp.asarray(zero_target), 0.05, jnp.int32(2)
    )
    for k in want:
        np.testing.assert_allclose(
            np.asarray(got[k], np.float64), want[k], atol=1e-4, rtol=1e-3
        )
    # and the params DID change (the reference really does update here)
    assert not np.allclose(np.asarray(got["w3"]), np.asarray(net.params["w3"]))


def test_masked_columns_receive_no_gradient():
    net = SpeakerNet.new(input_size=6, hidden1=5, hidden2=4, output=2, seed=4)
    cap = net.capacity
    batch = np.random.default_rng(2).normal(size=(3, 6)).astype(np.float32)
    target = np.zeros((3, cap), np.float32)
    target[:, 0] = 1.0
    got = T.train_batch(
        net.params, jnp.asarray(batch), jnp.asarray(target), 0.1, jnp.int32(2)
    )
    np.testing.assert_array_equal(
        np.asarray(got["w3"])[:, 2:], np.asarray(net.params["w3"])[:, 2:]
    )
    np.testing.assert_array_equal(
        np.asarray(got["b3"])[2:], np.asarray(net.params["b3"])[2:]
    )


def test_fully_masked_batch_is_noop():
    net = SpeakerNet.new(input_size=6, hidden1=5, hidden2=4, output=2, seed=5)
    batch = jnp.ones((4, 6))
    target = jnp.zeros((4, net.capacity))
    got = T.train_batch(
        net.params, batch, target, 0.1, jnp.int32(2), weights=jnp.zeros(4)
    )
    for k in net.params:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(net.params[k]))


def test_pretrain_converges_two_classes():
    """End-to-end: two separable feature clusters become classifiable."""
    net = SpeakerNet.new(input_size=8, hidden1=16, hidden2=8, output=2, seed=7)
    rng = np.random.default_rng(9)
    a = rng.normal(loc=+1.0, size=(40, 8)).astype(np.float32)
    b = rng.normal(loc=-1.0, size=(40, 8)).astype(np.float32)
    for _ in range(10):
        drivers.pretrain_from_features(net, a, 0, 2, 1, 0.05, 0.0, 8)
        drivers.pretrain_from_features(net, b, 1, 2, 1, 0.05, 0.0, 8)
    pa = net.forward(a).argmax(axis=1)
    pb = net.forward(b).argmax(axis=1)
    assert (pa == 0).mean() > 0.9
    assert (pb == 1).mean() > 0.9


def test_pretrain_loss_finite_and_positive():
    net = SpeakerNet.new(input_size=8, hidden1=16, hidden2=8, output=2, seed=8)
    x = np.random.default_rng(3).normal(size=(20, 8)).astype(np.float32)
    loss = drivers.pretrain_from_features(net, x, 0, 2, 2, 0.01, 0.2, 8)
    assert np.isfinite(loss) and loss > 0


def test_empty_windows_zero_loss():
    net = SpeakerNet.new(input_size=8, hidden1=4, hidden2=4, output=2, seed=8)
    loss = drivers.pretrain_from_features(
        net, np.zeros((0, 8), np.float32), 0, 2, 3, 0.01, 0.2, 8
    )
    assert loss == 0.0


def test_all_zero_windows_skipped():
    """All-zero windows never contribute loss or gradients (src/lib.rs:607-609)."""
    net = SpeakerNet.new(input_size=8, hidden1=4, hidden2=4, output=2, seed=8)
    before = {k: np.asarray(v).copy() for k, v in net.params.items()}
    loss = drivers.pretrain_from_features(
        net, np.zeros((16, 8), np.float32), 0, 2, 2, 0.05, 0.0, 8
    )
    assert loss == 0.0
    for k in before:
        np.testing.assert_array_equal(np.asarray(net.params[k]), before[k])


def test_train_bits_matches_oracle():
    """MSE+sigmoid delta chain (src/lib.rs:917-951)."""
    net = SpeakerNet.new(input_size=6, hidden1=5, hidden2=4, output=3, seed=13)
    # stego nets use the full (unmasked) output layer
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6,)).astype(np.float64)
    t = (rng.random(net.capacity) > 0.5).astype(np.float64)
    p = _np_params(net)

    h1_pre = x @ p["w1"] + p["b1"]; h1 = np.maximum(h1_pre, 0)
    h2_pre = h1 @ p["w2"] + p["b2"]; h2 = np.tanh(h2_pre)
    out = 1 / (1 + np.exp(-(h2 @ p["w3"] + p["b3"])))
    delta = (out - t) * out * (1 - out)
    want_w3 = p["w3"] - 0.5 * np.outer(h2, delta)
    dh2 = (delta @ p["w3"].T) * (1 - h2**2)
    want_w2 = p["w2"] - 0.5 * np.outer(h1, dh2)

    got = T.train_bits_step(
        net.params, jnp.asarray(x, jnp.float32), jnp.asarray(t, jnp.float32),
        0.5, net.capacity,
    )
    np.testing.assert_allclose(np.asarray(got["w3"], np.float64), want_w3,
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(got["w2"], np.float64), want_w2,
                               atol=1e-4, rtol=1e-3)


def test_corpus_step_improves_loss():
    net = SpeakerNet.new(input_size=8, hidden1=16, hidden2=8, output=2, seed=21)
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.normal(+1, 1, size=(64, 8)), rng.normal(-1, 1, size=(64, 8))
    ]).astype(np.float32)
    y = np.concatenate([np.zeros(64), np.ones(64)]).astype(np.int32)
    w = np.ones(128, np.float32)
    params = net.params
    losses = []
    for _ in range(30):
        params, loss = T.corpus_step(
            params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
            jnp.int32(2), 0.1,
        )
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7


@pytest.mark.parametrize(
    "num_speakers,capacity", [(1, 128), (3, 128), (64, 128), (130, 256)]
)
def test_corpus_step_matches_delta_rule_oracle(num_speakers, capacity):
    """The corpus step (XLA autodiff of the surrogate loss) applies the
    reference's delta rule over the weighted batch, at several class counts
    and padded capacities; masked rows and out-of-range labels follow the
    reference (zero target -> pure softmax delta)."""
    net = SpeakerNet.new(input_size=12, hidden1=10, hidden2=6,
                         output=num_speakers, seed=num_speakers)
    net.ensure_capacity(capacity)
    assert net.capacity == capacity
    rng = np.random.default_rng(num_speakers)
    B = 24
    x = rng.normal(size=(B, 12)).astype(np.float32)
    y = rng.integers(0, num_speakers + 1, size=B).astype(np.int32)
    w = (rng.random(B) > 0.25).astype(np.float32)
    lr = 0.05

    params = _np_params(net)
    kept = w > 0
    want = params
    if kept.any():
        # The oracle's one batch step with per-sample targets: sum the
        # per-sample deltas by stepping one sample at a time with lr / n.
        n = int(kept.sum())
        g_total = {k: np.zeros_like(v) for k, v in params.items()}
        for xi, yi in zip(x[kept], y[kept]):
            tgt = np.zeros(num_speakers)
            if yi < num_speakers:
                tgt[yi] = 1.0
            stepped = _oracle_batch_step(params, xi[None], tgt, 1.0,
                                         num_speakers)
            for k in params:
                g_total[k] += params[k] - stepped[k]
        want = {k: params[k] - (lr / n) * g_total[k] for k in params}
    got, _ = T.corpus_step(
        net.params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
        jnp.int32(num_speakers), lr,
    )
    for k in want:
        np.testing.assert_allclose(
            np.asarray(got[k], np.float64), want[k], atol=1e-5, rtol=1e-4,
            err_msg=k,
        )
