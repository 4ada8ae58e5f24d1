"""Jitted training steps reproducing the reference's SGD semantics.

The reference trains with hand-written backprop (``streamz-rs/src/lib.rs:954-1060``):
softmax + cross-entropy whose output delta is exactly ``softmax(logits) - target``
— including the quirk that an out-of-range target class yields a zero target
vector and a pure ``softmax`` delta (``pretrain_from_features`` builds the
one-hot only when ``target_class < num_classes``, ``src/lib.rs:592-594``).
Autodiffing the clamped log-loss would *not* reproduce that, so the gradient
here is taken of ``logsumexp(logits) - <target, logits>``, whose derivative is
that exact delta for any target vector.

``train_on_windows`` reproduces the full ``pretrain_from_features`` loop
(``src/lib.rs:582-628``) as one jitted ``lax.scan``:

  per epoch: shuffle windows → chunks of ``batch_size`` → per-window feature
  dropout (plain zeroing, no 1/(1-p) rescale, ``src/lib.rs:119-129``) →
  windows that become all-zero are skipped (``:607-609``) → the *mean*
  gradient over surviving windows is applied once per chunk (``train_batch``,
  ``:1002-1060``) → the reported loss is ``-ln(max(p_target, 1e-12))``
  accumulated over surviving windows (``:610-616``).

Masked class growth: logits beyond ``num_speakers`` sit at a large negative
constant, so their softmax mass and gradients are exactly zero, matching the
reference's ``w3[.., ..num_speakers]`` slicing (``src/lib.rs:961-962``).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from streamz_tpu.nn.model import Params, forward_logits, hidden_tanh, matmul


@jax.jit
def train_batch(
    params: Params,
    batch: jax.Array,
    target: jax.Array,
    lr,
    num_speakers,
    weights: jax.Array | None = None,
) -> Params:
    """One mean-gradient SGD step over a batch (src/lib.rs:1002-1060).

    Jitted: the reference method surface (SpeakerNet.train/train_batch)
    dispatches here per call, and an unjitted jax.grad would re-trace the
    whole forward+backward every step.

    ``weights``: optional [B] 0/1 mask of samples included in the batch; the
    mean divides by the *included* count, and a fully-masked batch applies no
    update (the reference skips empty batches at ``:1003-1005``).
    """
    B = batch.shape[0]
    w = jnp.ones((B,), jnp.float32) if weights is None else weights

    def summed(p):
        logits = forward_logits(p, batch, num_speakers)
        lse = jax.nn.logsumexp(logits, axis=-1)
        per = lse - jnp.sum(target * logits, axis=-1)
        return jnp.sum(per * w)

    grads = jax.grad(summed)(params)
    count = jnp.sum(w)
    scale = jnp.where(count > 0, lr / jnp.maximum(count, 1.0), 0.0)
    return jax.tree_util.tree_map(lambda p, g: p - scale * g, params, grads)


def file_epoch_views(
    windows: jax.Array,   # [N_pad, F]
    n_valid: jax.Array,   # scalar
    key: jax.Array,
    dropout: jax.Array,
    epochs: int,
) -> Tuple[jax.Array, jax.Array]:
    """Per-epoch shuffled+dropped window views and their valid masks.

    Reproduces ``pretrain_from_features``'s per-epoch shuffle
    (valid windows first, random order), plain-zeroing input dropout and
    all-zero-window skip (src/lib.rs:119-129, :598-609).  Shared by the
    single-device and the window-sharded trainers so both consume
    byte-identical data.  Returns (dropped [E, N_pad, F], valid [E, N_pad]).
    """
    n_pad, feat = windows.shape

    def one_epoch(ekey):
        k_perm, k_drop = jax.random.split(ekey)
        scores = jnp.where(
            jnp.arange(n_pad) < n_valid,
            jax.random.uniform(k_perm, (n_pad,)),
            jnp.inf,
        )
        order = jnp.argsort(scores)
        keep = jax.random.uniform(k_drop, (n_pad, feat)) >= dropout
        dropped = jnp.where(keep, windows[order], 0.0)
        valid = (jnp.arange(n_pad) < n_valid) & jnp.any(dropped != 0.0, axis=-1)
        return dropped, valid.astype(jnp.float32)

    return jax.vmap(one_epoch)(jax.random.split(key, epochs))


def train_on_windows_impl(
    params: Params,
    windows: jax.Array,   # [N_pad, F] feature windows (padded)
    n_valid: jax.Array,   # scalar count of real windows
    target_vec: jax.Array,  # [capacity] target vector (may be all-zero)
    num_speakers: jax.Array,  # scalar int
    key: jax.Array,
    lr: jax.Array,
    dropout: jax.Array,
    *,
    epochs: int,
    batch_size: int,
) -> Tuple[Params, jax.Array]:
    """``pretrain_from_features`` (src/lib.rs:582-628) as one fused step.

    ``target_vec`` is the capacity-length target; the reference builds it as a
    one-hot only when ``target_class < num_classes`` (src/lib.rs:592-594) —
    callers replicate that rule in :mod:`streamz_tpu.nn.drivers`.

    Un-jitted implementation so larger fused steps (the device-resident
    incremental loop) can inline it; use :func:`train_on_windows` standalone.
    The chunk updates run as one ``lax.scan`` with autodiff.

    Returns (new_params, mean reported loss over all processed windows).
    """
    n_pad, feat = windows.shape
    n_chunks = n_pad // batch_size
    capacity = params["b3"].shape[0]

    dropped_all, valid_all = file_epoch_views(
        windows, n_valid, key, dropout, epochs
    )
    chunks = dropped_all.reshape(epochs * n_chunks, batch_size, feat)
    masks = valid_all.reshape(epochs * n_chunks, batch_size)

    def chunk_body(carry, inp):
        params, loss_sum, loss_cnt = carry
        batch, wmask = inp
        params, loss_sum, loss_cnt = _chunk_update(
            params, batch, wmask, target_vec, num_speakers, capacity,
            batch_size, loss_sum, loss_cnt, lr,
        )
        return (params, loss_sum, loss_cnt), None

    (params, loss_sum, loss_cnt), _ = jax.lax.scan(
        chunk_body, (params, jnp.float32(0.0), jnp.float32(0.0)),
        (chunks, masks),
    )
    mean_loss = jnp.where(loss_cnt > 0, loss_sum / jnp.maximum(loss_cnt, 1.0), 0.0)
    return params, mean_loss


def _chunk_update(
    params, batch, wmask, target_vec, num_speakers, capacity, rows,
    loss_sum, loss_cnt, lr, merge=None,
):
    """ONE copy of the chunk-update core shared by the single-device and
    SPMD window-scan trainers.  One fused
    forward+backward: the surrogate sum drives the gradient (== reference
    delta) while the clamped reported loss rides along as aux — halves
    the per-chunk op count, which dominates this latency-bound inner
    loop.  ``merge`` combines (grads, loss, count) across devices before
    the update (the SPMD psum); None is the single-device identity.
    """
    tgt = jnp.broadcast_to(target_vec, (rows, capacity))

    def summed(p):
        logits = forward_logits(p, batch, num_speakers)
        lse = jax.nn.logsumexp(logits, axis=-1)
        per = lse - jnp.sum(tgt * logits, axis=-1)
        probs = jax.nn.softmax(logits, axis=-1)
        report = -jnp.sum(
            tgt * jnp.log(jnp.maximum(probs, 1e-12)), axis=-1
        )
        return jnp.sum(per * wmask), report

    (_, losses), grads = jax.value_and_grad(summed, has_aux=True)(params)
    loss_part = jnp.sum(losses * wmask)
    count = jnp.sum(wmask)
    if merge is not None:
        grads, loss_part, count = merge((grads, loss_part, count))
    scale = jnp.where(count > 0, lr / jnp.maximum(count, 1.0), 0.0)
    params = jax.tree_util.tree_map(lambda p, g: p - scale * g, params, grads)
    return params, loss_sum + loss_part, loss_cnt + count


train_on_windows = partial(
    jax.jit, static_argnames=("epochs", "batch_size"),
    donate_argnums=(0,))(train_on_windows_impl)


def train_on_windows_sharded_impl(
    params: Params,
    windows: jax.Array,   # [N_pad, F] feature windows (replicated)
    n_valid: jax.Array,
    target_vec: jax.Array,
    num_speakers: jax.Array,
    key: jax.Array,
    lr: jax.Array,
    dropout: jax.Array,
    *,
    epochs: int,
    batch_size: int,
    axis: str,
    n_dev: int,
) -> Tuple[Params, jax.Array]:
    """Window-axis-sharded ``train_on_windows_impl`` for use *inside*
    ``shard_map`` (the fused discovery loop's mesh path).

    Inputs arrive replicated; the epoch views (shuffle/dropout/masks) are
    built identically on every device from the same key, and each device
    computes the gradient of its ``batch_size/n_dev`` slice of every chunk.
    ONE ``psum`` per chunk merges (grads, loss, count) — the SPMD equivalent
    of the reference's lock-serialized shared-model update
    (``streamz-rs/src/main.rs:803``).  The merged gradient equals the full
    chunk gradient up to f32 summation order, so label trajectories match
    the unsharded scan; params stay replicated by construction.
    """
    n_pad, feat = windows.shape
    n_chunks = n_pad // batch_size
    capacity = params["b3"].shape[0]

    dropped_all, valid_all = file_epoch_views(
        windows, n_valid, key, dropout, epochs
    )
    chunks = dropped_all.reshape(epochs * n_chunks, batch_size, feat)
    masks = valid_all.reshape(epochs * n_chunks, batch_size)

    rows_per = -(-batch_size // n_dev)
    bs_pad = rows_per * n_dev
    if bs_pad != batch_size:  # zero-weight padding rows for uneven splits
        chunks = jnp.pad(chunks, ((0, 0), (0, bs_pad - batch_size), (0, 0)))
        masks = jnp.pad(masks, ((0, 0), (0, bs_pad - batch_size)))
    d = jax.lax.axis_index(axis)

    def chunk_body(carry, inp):
        params, loss_sum, loss_cnt = carry
        batch_full, wmask_full = inp
        batch = jax.lax.dynamic_slice_in_dim(batch_full, d * rows_per, rows_per)
        wmask = jax.lax.dynamic_slice_in_dim(wmask_full, d * rows_per, rows_per)
        params, loss_sum, loss_cnt = _chunk_update(
            params, batch, wmask, target_vec, num_speakers, capacity,
            rows_per, loss_sum, loss_cnt, lr,
            merge=lambda t: jax.lax.psum(t, axis),
        )
        return (params, loss_sum, loss_cnt), None

    (params, loss_sum, loss_cnt), _ = jax.lax.scan(
        chunk_body, (params, jnp.float32(0.0), jnp.float32(0.0)),
        (chunks, masks),
    )
    mean_loss = jnp.where(loss_cnt > 0, loss_sum / jnp.maximum(loss_cnt, 1.0), 0.0)
    return params, mean_loss


# ---------------------------------------------------------------------------
# Stego (sigmoid + MSE) training step (src/lib.rs:917-951).
# ---------------------------------------------------------------------------


@jax.jit
def train_bits_step(
    params: Params, x: jax.Array, target: jax.Array, lr, n_live
) -> Params:
    """Single-sample MSE+sigmoid SGD step on the live output columns (jitted
    — see train_batch).

    Reference delta chain: ``delta_out = (out - t) * out * (1 - out)``
    (src/lib.rs:926-927) — exactly the gradient of 0.5*||sigmoid(z) - t||^2,
    so plain autodiff of that loss reproduces it.  The reference's layer is
    exact-size, so columns beyond ``n_live`` (the capacity padding) are
    masked out of the loss — their random weights would otherwise inject
    phantom gradients into the shared w1/w2 trunk.
    """

    def loss(p):
        _, h2 = hidden_tanh(p, x)  # the SAME trunk forward_bits runs
        out = jax.nn.sigmoid(matmul(h2, p["w3"]) + p["b3"])
        live = jnp.arange(out.shape[-1]) < n_live
        return 0.5 * jnp.sum(jnp.where(live, (out - target) ** 2, 0.0))

    grads = jax.grad(loss)(params)
    return jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)


# ---------------------------------------------------------------------------
# High-throughput corpus-batched step: one big labeled batch, mean CE
# gradient, used by the data-parallel trainer in streamz_tpu/parallel.  This
# replaces the reference's per-file rayon loop (src/main.rs:750-835) when
# exact incremental semantics are not required.
# ---------------------------------------------------------------------------


def corpus_grads(
    params: Params,
    batch: jax.Array,     # [B, F]
    labels: jax.Array,    # [B] int32
    weights: jax.Array,   # [B] 0/1 valid mask
    num_speakers,
) -> Tuple[Params, jax.Array, jax.Array]:
    """Summed surrogate-loss gradients + (loss_sum, valid count) for one
    labeled batch — the core shared by :func:`corpus_step` and the
    data-parallel trainers (each device runs this on its shard and psums
    the results)."""
    capacity = params["b3"].shape[0]
    target = jax.nn.one_hot(labels, capacity, dtype=jnp.float32)
    target = target * (labels < num_speakers)[:, None].astype(jnp.float32)

    def summed(p):
        logits = forward_logits(p, batch, num_speakers)
        lse = jax.nn.logsumexp(logits, axis=-1)
        per = lse - jnp.sum(target * logits, axis=-1)
        return jnp.sum(per * weights)

    loss_sum, grads = jax.value_and_grad(summed)(params)
    return grads, loss_sum, jnp.sum(weights)


def corpus_step(
    params: Params,
    batch: jax.Array,     # [B, F]
    labels: jax.Array,    # [B] int32
    weights: jax.Array,   # [B] 0/1 valid mask
    num_speakers,
    lr,
) -> Tuple[Params, jax.Array]:
    """One SGD step on a large labeled batch; returns (params, mean CE loss)."""
    grads, loss_sum, count = corpus_grads(
        params, batch, labels, weights, num_speakers
    )
    count = jnp.maximum(count, 1.0)
    params = jax.tree_util.tree_map(lambda p, g: p - (lr / count) * g, params, grads)
    return params, loss_sum / count
