"""SPMD data-parallel training over a ``"data"`` mesh axis.

This is the multi-chip equivalent of the reference's shared-memory data
parallelism (rayon threads + one RwLock'd model,
``streamz-rs/src/main.rs:750-835``): the window batch is sharded across
devices, each device computes gradients on its shard, and a ``psum`` (an
NCCL all-reduce on GPUs) replaces the lock-serialized weight update.
Parameters stay replicated.

Built on ``shard_map`` so the collective structure is explicit and the step
jits identically from 1 device to many (and to multi-host with the same axis
name).
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from streamz_tpu.nn import train
from streamz_tpu.parallel import comm


def _dp_local_step(params, batch, labels, weights, num_speakers, lr):
    """One data-parallel SGD step on this device's shard (runs INSIDE
    shard_map): local grads -> psum allreduce (the SPMD
    replacement for the reference's write-lock serialization) -> global
    mean-gradient update.  Shared by the single-step and scanned-epoch
    trainers so the two can never silently disagree on the update rule."""
    grads_local, loss_local, count_local = train.corpus_grads(
        params, batch, labels, weights, num_speakers
    )
    grads = jax.tree_util.tree_map(
        lambda g: comm.psum(g, comm.DATA_AXIS), grads_local
    )
    loss = comm.psum(loss_local, comm.DATA_AXIS)
    count = comm.psum(count_local, comm.DATA_AXIS)
    scale = jnp.where(count > 0, lr / jnp.maximum(count, 1.0), 0.0)
    new_params = jax.tree_util.tree_map(lambda p, g: p - scale * g, params, grads)
    return new_params, loss / jnp.maximum(count, 1.0)


def make_dp_train_step(mesh: Mesh):
    """Build a jitted data-parallel SGD step.

    Returns ``step(params, batch, labels, weights, num_speakers, lr)`` with
    ``batch``/``labels``/``weights`` sharded on their leading axis and params
    replicated.  Semantics match the reference's mean-gradient ``train_batch``
    (``src/lib.rs:1002-1060``) over the *global* batch: the division uses the
    global valid count, so results are independent of the device count.
    """
    shard = partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(comm.DATA_AXIS), P(comm.DATA_AXIS), P(comm.DATA_AXIS), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(shard(_dp_local_step))


def make_dp_train_epoch(mesh: Mesh, *, steps: int):
    """A jitted multi-step trainer: ``lax.scan`` of the DP step over
    pre-batched data [steps, B, F] (B sharded across devices)."""

    def _local_epoch(params, batches, labels, weights, num_speakers, lr):
        def body(params, inp):
            b, l, w = inp
            return _dp_local_step(params, b, l, w, num_speakers, lr)

        params, losses = jax.lax.scan(body, params, (batches, labels, weights))
        return params, losses

    shard = partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(),
            P(None, comm.DATA_AXIS),
            P(None, comm.DATA_AXIS),
            P(None, comm.DATA_AXIS),
            P(),
            P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(shard(_local_epoch))


def shard_arrays(mesh: Mesh, *arrays):
    """Device-put arrays with their leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(comm.DATA_AXIS))
    return tuple(jax.device_put(a, sharding) for a in arrays)
