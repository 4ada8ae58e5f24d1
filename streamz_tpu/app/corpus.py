"""Whole-corpus batched training — the batched fast path at scale.

The reference trains per file, per epoch, in batches of 8 windows behind a
write lock (``streamz-rs/src/main.rs:750-835``).  When exact incremental
semantics are not required (e.g. all labels known), the batched way is one
global shuffled window pool trained with large batches, data-parallel over a
``"data"`` mesh axis with psum gradient allreduce.

``train_corpus`` builds the pool from a feature map, shards it over the mesh,
and drives :func:`streamz_tpu.parallel.data_parallel.make_dp_train_epoch`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from streamz_tpu import config
from streamz_tpu.nn.model import SpeakerNet
from streamz_tpu.parallel import comm, data_parallel as dp


def build_window_pool(
    feature_map: Dict[str, np.ndarray],
    files: Sequence[Tuple[str, int]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten per-file windows into one labeled pool ([N, F], [N])."""
    xs: List[np.ndarray] = []
    ys: List[np.ndarray] = []
    for path, cls in files:
        wins = feature_map.get(path)
        if wins is None or len(wins) == 0:
            continue
        xs.append(np.asarray(wins, np.float32))
        ys.append(np.full(len(wins), cls, np.int32))
    if not xs:
        return (np.zeros((0, config.FEATURE_SIZE), np.float32),
                np.zeros((0,), np.int32))
    return np.concatenate(xs), np.concatenate(ys)


def train_corpus(
    net: SpeakerNet,
    windows: np.ndarray,
    labels: np.ndarray,
    *,
    epochs: int = 5,
    batch_size: int = 4096,
    lr: float = 0.01,
    dropout: float = 0.0,
    mesh: Optional[Mesh] = None,
    seed: int = 0,
) -> List[float]:
    """Data-parallel large-batch SGD over the whole pool.

    Returns the per-epoch mean losses.  ``batch_size`` is the *global* batch;
    it is padded so every device gets an equal shard.

    ``dropout`` reproduces the reference's input dropout (zero elements with
    prob p, no 1/(1-p) rescale, all-zero windows skipped from the batch —
    src/lib.rs:119-129, :607-609).  Masks are drawn host-side from the seeded
    rng for the UNPADDED pool only, so the rng stream (shuffles + masks)
    is device-count-independent; trained params then match across device
    counts up to psum reduction-order float noise.
    """
    mesh = mesh or comm.make_mesh()
    n_dev = mesh.devices.size
    if batch_size % n_dev:
        batch_size += n_dev - batch_size % n_dev

    n = len(windows)
    if n == 0:
        return []

    steps = max(1, -(-n // batch_size))
    n_pad = steps * batch_size

    rng = np.random.default_rng(seed)
    epoch_fn = dp.make_dp_train_epoch(mesh, steps=steps)

    params = net.params
    losses: List[float] = []
    for _ in range(int(epochs)):
        order = rng.permutation(n)
        idx = np.concatenate([order, np.zeros(n_pad - n, np.int64)])
        x = windows[idx]
        w = (np.arange(n_pad) < n).astype(np.float32)
        if dropout > 0.0:
            # Draw the mask for the UNPADDED rows only: n_pad depends on
            # the mesh-multiple batch rounding, so consuming draws for
            # padding rows would advance the bit generator by a
            # device-count-dependent amount — breaking the documented
            # bit-invariance from epoch 2 on (the next permutation would
            # differ across mesh sizes).  Padding rows carry w == 0, so
            # leaving them un-dropped changes nothing.
            keep = rng.random((n,) + x.shape[1:], dtype=np.float32) >= dropout
            x[:n] = x[:n] * keep
            w = w * np.any(x != 0.0, axis=-1)  # all-zero windows skipped
        x = x.astype(np.float32).reshape(steps, batch_size, -1)
        y = labels[idx].reshape(steps, batch_size)
        w = w.astype(np.float32).reshape(steps, batch_size)

        xb, yb, wb = (
            jax.device_put(a, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec(None, comm.DATA_AXIS)))
            for a in (x, y, w)
        )
        params, step_losses = epoch_fn(
            params, xb, yb, wb, jnp.int32(net.num_speakers), jnp.float32(lr)
        )
        losses.append(float(np.asarray(step_losses).mean()))
    net.params = params
    return losses
